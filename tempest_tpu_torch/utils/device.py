"""Where the port's entry points run.

The port is written for the card: an entry point that is given no device
runs on CUDA, and raises when there is none.  Nothing carries on on the CPU
by itself; a caller that wants the CPU (the parity tests do) passes
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor"]


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tempest_tpu_torch runs on a CUDA card and found none; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def as_tensor(x, device: torch.device | str | None = None) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a tensor on ``device``.  With
    ``device=None`` a tensor stays where it lies and a host array goes to the
    CUDA card (raising when there is none); complex host arrays go up as
    complex64."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    device = resolve_device(device)
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            x = np.ascontiguousarray(x, np.complex64)
        return torch.from_numpy(x).to(device)
    return torch.as_tensor(x, device=device)
