"""The repo's own benchmark and entry-point programs, in the port.

Each module is the counterpart of one program at the repo's root, which
stays the JAX package's own:

* ``bench`` — ``bench.py``: one JSON line, the full chain's IQ throughput at
  1080p60 (``python -m tempest_tpu_torch.bench.bench``);
* ``bench_all`` — ``bench_all.py``: one JSON line a scenario, in the JAX
  script's order (``python -m tempest_tpu_torch.bench.bench_all``);
* ``graft_entry`` — ``__graft_entry__.py``: ``entry()``, the flagship step
  and its arguments, and ``dryrun_multichip(n)``, one step of every sharded
  program.

They run on the CUDA card unless told ``device="cpu"`` (``--device cpu``),
and every line they print names the device and its power limit.  Timed
regions are fenced with ``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import functools
import subprocess

import torch

__all__ = ["device_fields", "fence"]


@functools.lru_cache(maxsize=None)
def _power_limit_w(index: int) -> float:
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def device_fields(device: torch.device) -> dict:
    """``{"device", "power_limit_w"}`` of a result line: the card's name and
    power limit (``None`` on the CPU, which has none)."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = torch.cuda.current_device() if device.index is None else device.index
    return {"device": torch.cuda.get_device_name(index), "power_limit_w": _power_limit_w(index)}


def fence(device: torch.device) -> None:
    """Wait until the card has run everything queued on it (nothing to wait
    for on the CPU, where every operation returns done)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
