"""Where the port's entry points run.

The port is written for the card: an entry point that is given no device
runs on CUDA, and raises when there is none.  Nothing carries on on the CPU
by itself; a caller that wants the CPU (the parity tests do) passes
``device="cpu"``.

A whole recording goes up through :func:`staged_upload`, in chunks through a
few reused pinned blocks, where one pageable copy would be paced by the one
host thread that stages it.
"""

from __future__ import annotations

import numpy as np
import torch

from .profiling import annotate, count

__all__ = ["resolve_device", "as_tensor", "staged_upload"]

# A host array of at least STAGED_MIN_BYTES goes up in chunks of
# STAGED_CHUNK_BYTES through STAGED_BLOCKS pinned blocks (staged_upload).
# Measured on an H100's 8-core host (exp/upload_staged.py): chunks over
# 8 MB fill faster on 8 intra-op threads but slower than the one pageable
# copy on one thread, and one thread stages no slower than that copy only
# from about 96 MB of array.
STAGED_MIN_BYTES = 96 << 20
STAGED_CHUNK_BYTES = 8 << 20
STAGED_BLOCKS = 3


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


def chunk_plan(nbytes: int, chunk: int = STAGED_CHUNK_BYTES) -> list[tuple[int, int]]:
    """The byte ranges ``[start, stop)`` a staged upload of ``nbytes`` copies,
    in order: every ``chunk`` bytes, the last one shorter."""
    return [(a, min(a + chunk, nbytes)) for a in range(0, nbytes, chunk)]


def staged_upload(x: np.ndarray, device: torch.device | str | None = None) -> torch.Tensor:
    """``torch.from_numpy(x).to(device)``, equal to the bit, for a large host
    array going to a CUDA card.

    A C-contiguous array of at least ``STAGED_MIN_BYTES`` goes up in chunks:
    each is copied into one of ``STAGED_BLOCKS`` pinned blocks of PyTorch's
    caching host allocator by ``Tensor.copy_`` (on the intra-op threads),
    then to its place in the device tensor by an asynchronous copy on the
    current stream, so the host fills the next block while the card reads
    this one.  A block is filled again only after its previous copy ended
    (its event); the call returns once the last chunk is issued, and work
    later on the stream runs after it.  The source may be changed as soon
    as the call returns.  Smaller or strided arrays, and any other device,
    take the one copy."""
    device = resolve_device(device)
    src = torch.from_numpy(x)
    if device.type != "cuda" or x.nbytes < STAGED_MIN_BYTES or not x.flags.c_contiguous:
        return src.to(device)
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    plan = chunk_plan(x.nbytes)
    with annotate("upload.staged"):
        _copy_chunks(torch.from_numpy(x.reshape(-1).view(np.uint8)),
                     out.view(-1).view(torch.uint8), plan, STAGED_BLOCKS)
    count("upload.staged.bytes", x.nbytes)
    count("upload.staged.chunks", len(plan))
    return out


def _copy_chunks(src: torch.Tensor, dst: torch.Tensor, plan: list[tuple[int, int]],
                 n_blocks: int) -> None:
    """Copy the host bytes ``src`` into the device bytes ``dst`` range by
    range of ``plan``, through ``n_blocks`` pinned blocks taken in turn."""
    stream = torch.cuda.current_stream(dst.device)
    size = max(b - a for a, b in plan)
    blocks = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
              for _ in range(min(n_blocks, len(plan)))]
    events = [torch.cuda.Event() for _ in blocks]
    for i, (a, b) in enumerate(plan):
        k = i % len(blocks)
        events[k].synchronize()  # the block's previous chunk has reached the card
        block = blocks[k][: b - a]
        block.copy_(src[a:b])
        dst[a:b].copy_(block, non_blocking=True)
        events[k].record(stream)
