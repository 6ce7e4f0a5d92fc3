"""Where the port's entry points run.

The port is written for the card: an entry point that is given no device
runs on CUDA, and raises when there is none.  Nothing carries on on the CPU
by itself; a caller that wants the CPU (the parity tests do) passes
``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tempest_tpu_torch runs on a CUDA card and found none; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")
