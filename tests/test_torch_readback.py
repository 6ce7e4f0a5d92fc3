"""The read-back of ``reconstruct_frames`` (and so of ``auto_reconstruct``):
the step's EMA, frames, sync and score as host arrays.

On the CPU the arrays are views of the step's own tensors, as they always
were, and nothing is read into pinned memory.  On the card (the ``cuda``
cases) they are views of pinned tensors from PyTorch's caching host
allocator: bit-equal to a blocking read-back of the same tensors, a result
held across a later call left as it was, and a call made after the previous
result was dropped served from the allocator's cache.

Shapes: 640x480 @ 60 Hz at 2 Msps, 6 frames on 60x80 screens for
``reconstruct_frames``; 0.3 s captures for ``auto_reconstruct``.  Imports no
JAX, so the ``cuda`` cases run on a machine without it (``--noconftest``).
"""

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.ops.enhance import restore_image
from tempest_tpu_torch.pipeline import offline
from tempest_tpu_torch.utils import profiling

MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 2e6
SHAPE = (60, 80)
FIELDS = ("image", "frames", "sync", "score")


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(input_format="iq_interleaved"):
    return offline.ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=6, render_size=SHAPE, input_format=input_format,
        align_subpixel=True)


def _iq(seed):
    return np.asarray(tp.generate_iq(MODE, FS, int(FS * 0.3), snr_db=20.0, seed=seed).iq,
                      np.complex64)


def _words(seed):
    iq = _iq(seed)
    return (np.stack([iq.real, iq.imag], axis=1).reshape(-1) * 8000.0).astype(np.int16)


@pytest.fixture
def steps(monkeypatch):
    """The (config, outputs) of every step ``reconstruct_frames`` makes."""
    seen = []
    make = offline.make_reconstruct_fn

    def spy(config, device=None):
        step = make(config, device)

        def run(*args):
            out = step(*args)
            seen.append((config, out))
            return out

        return run

    monkeypatch.setattr(offline, "make_reconstruct_fn", spy)
    return seen


def _arrays(recon):
    return [getattr(recon, f) for f in FIELDS]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _readback_bytes(recon):
    return sum(a.nbytes for a in _arrays(recon))


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("source", ["int16_words", "complex64"])
def test_reconstruct_frames_returns_views_of_the_step_on_the_cpu(source, steps):
    profiling.enable()
    if source == "int16_words":
        recon = offline.reconstruct_frames(_words(3), _config(), device="cpu")
    else:
        recon = offline.reconstruct_frames(_iq(3), _config("complex64"), device="cpu")
    ((_, outs),) = steps
    for name, got, t in zip(FIELDS, _arrays(recon), outs):
        assert isinstance(got, np.ndarray) and got.dtype == np.float32, name
        assert np.array_equal(_bits(got), _bits(t.numpy())), name
        # Zero-copy, as ``.cpu().numpy()`` of a CPU tensor is.
        assert np.shares_memory(got, t.numpy()), name
    assert recon.frames.shape == (6, *SHAPE) and recon.sync.shape == (6, 2)
    counters = profiling.summary()["counters"]
    assert counters["offline.readback.bytes"] == _readback_bytes(recon)
    assert counters["offline.readback.pinned.bytes"] == 0


def test_auto_reconstruct_returns_the_steps_arrays_on_the_cpu(steps):
    profiling.enable()
    _, recon = offline.auto_reconstruct(_iq(5), FS, device="cpu")
    ((config, (ema, frames, sync, score)),) = steps
    for name, got, t in zip(("image_raw", "frames", "sync", "score"),
                            (recon.image_raw, recon.frames, recon.sync, recon.score),
                            (ema, frames, sync, score)):
        assert isinstance(got, np.ndarray) and got.dtype == np.float32, name
        assert np.array_equal(_bits(got), _bits(t.numpy())), name
    restored = restore_image(ema.numpy(), config, nsr=0.002, device="cpu")
    assert np.array_equal(_bits(recon.image), _bits(restored))
    counters = profiling.summary()["counters"]
    assert counters["offline.readback.pinned.bytes"] == 0
    assert counters["offline.readback.bytes"] == sum(
        a.nbytes for a in (recon.image_raw, recon.frames, recon.sync, recon.score))


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned read-back runs from device tensors")
    return torch.device("cuda", 0)


def _host_allocs():
    """The caching host allocator's ``cudaHostAlloc`` calls so far."""
    return torch.cuda.host_memory_stats()["num_host_alloc"]


@pytest.mark.cuda
def test_read_back_is_pinned_and_equal_to_a_blocking_copy(steps):
    dev = _card()
    profiling.enable()
    recon = offline.reconstruct_frames(_words(3), _config(), device=dev)
    ((_, outs),) = steps
    for name, got, t in zip(FIELDS, _arrays(recon), outs):
        assert t.device.type == "cuda", name
        assert torch.from_numpy(got).is_pinned(), name
        assert np.array_equal(_bits(got), _bits(t.cpu().numpy())), name
    counters = profiling.summary()["counters"]
    assert counters["offline.readback.pinned.bytes"] == counters["offline.readback.bytes"]
    assert counters["offline.readback.bytes"] == _readback_bytes(recon)


@pytest.mark.cuda
def test_held_result_survives_later_calls_and_a_dropped_one_is_reused(steps):
    dev = _card()
    config = _config()
    held = offline.reconstruct_frames(_words(3), config, device=dev)
    kept = [a.copy() for a in _arrays(held)]
    later = offline.reconstruct_frames(_words(4), config, device=dev)
    assert not np.array_equal(later.frames, held.frames)
    assert not any(np.shares_memory(a, b) for a, b in zip(_arrays(held), _arrays(later)))
    # Dropped: its blocks go back to the cache, and the next call takes them.
    del later
    steps.clear()
    before = _host_allocs()
    again = offline.reconstruct_frames(_words(4), config, device=dev)
    assert _host_allocs() == before
    assert all(torch.from_numpy(a).is_pinned() for a in _arrays(again))
    # The held result is what it was, after both calls.
    for name, a, b in zip(FIELDS, _arrays(held), kept):
        assert np.array_equal(_bits(a), _bits(b)), name


@pytest.mark.cuda
def test_auto_reconstruct_reads_back_into_pinned_memory(steps):
    dev = _card()
    profiling.enable()
    _, recon = offline.auto_reconstruct(_iq(5), FS, device=dev)
    ((_, (ema, frames, sync, score)),) = steps
    for name, got, t in zip(("image_raw", "frames", "sync", "score"),
                            (recon.image_raw, recon.frames, recon.sync, recon.score),
                            (ema, frames, sync, score)):
        assert torch.from_numpy(got).is_pinned(), name
        assert np.array_equal(_bits(got), _bits(t.cpu().numpy())), name
    counters = profiling.summary()["counters"]
    assert counters["offline.readback.pinned.bytes"] == counters["offline.readback.bytes"] > 0
