"""What every entry shares: the run's context, the seeded sample of answers
to check, and the comparisons."""

from __future__ import annotations

import dataclasses
import random
import sys
import time

import torch

__all__ = ["FORBIDDEN", "forbidden_modules", "Context", "Reservoir", "rel_max", "abs_max",
           "check"]

# Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "tempest_tpu")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole (so
    ``tempest_tpu_torch`` is not ``tempest_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """One run: where, from which seed, and the cell's data."""

    device: torch.device
    seed: int
    config: dict
    traffic: dict
    spans: object

    def __post_init__(self) -> None:
        # The sample of answers to check is drawn from the seed.
        self.rng = random.Random(self.seed * 7 + 3)

    def fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        return time.perf_counter()


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from the run's seeded generator (Algorithm R)."""

    def __init__(self, k: int, rng: random.Random) -> None:
        self.k, self.rng, self.seen = int(k), rng, 0
        self.items: dict[int, object] = {}

    def slot(self) -> int | None:
        """The slot the next item takes, or None where it is not kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        self.items[slot] = item

    def values(self) -> list:
        return [self.items[s] for s in sorted(self.items)]


def rel_max(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog − ref| over the reference's range; inf where the shapes differ
    or a value is not finite."""
    prog = torch.as_tensor(prog).to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    if prog.shape != ref.shape:
        return float("inf")
    span = float(ref.max() - ref.min()) or 1.0
    gap = float(torch.max(torch.abs(prog - ref)))
    return gap / span if gap == gap else float("inf")


def abs_max(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog − ref|; inf where the shapes differ or a value is not finite."""
    prog = torch.as_tensor(prog).to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    if prog.shape != ref.shape:
        return float("inf")
    gap = float(torch.max(torch.abs(prog - ref)))
    return gap if gap == gap else float("inf")


def check(readings: dict, name: str, value: float) -> None:
    """Keep the worst reading of ``name``."""
    readings[name] = max(readings.get(name, float("-inf")), float(value))
