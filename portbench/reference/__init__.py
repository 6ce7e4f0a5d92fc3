"""The benchmark's plain reference: what the port computes, restated in plain
PyTorch and NumPy from the port's plain versions at commit 535d04e.  It
imports nothing of ``tempest_tpu_torch``, ``tempest_tpu`` or ``jax``, and
takes nothing the program made: it works the cuts, the timing, the mode and
the line tables out again from the generated inputs."""

from . import chain, restore, timing

__all__ = ["chain", "restore", "timing"]
