"""``tempest_tpu_torch.utils.device.staged_upload``: a large host array to the
card in chunks through a few reused pinned blocks, and the two entries that
upload whole recordings through it (``auto_reconstruct``, and every user of
``ops.scan._words``: ``combined_reconstruct``, the band scan, the fusion).

On the CPU the chunk plan is checked byte by byte, and the helper is the one
copy it always was: ``torch.from_numpy(x).to(device)``, no staged byte
counted.  On the card (the ``cuda`` cases) the staged copy is equal to the
bit to that copy for int16, float32 and complex64 arrays below the size
threshold, at a multiple of the chunk and a few elements over one; the source
may be overwritten once the call returns; many chunks through the same blocks
behind a busy stream (so that a block refilled before its copy ended would
show); and an ``auto_reconstruct`` or ``combined_reconstruct`` of host words
above the threshold stages every uploaded byte and gives the arrays of the
same call on the words already on the card.

Shapes: 640x480 @ 60 Hz captures of 0.3 s at 2 Msps and 1 M samples at
8 Msps on the CPU; on the card, arrays just over the threshold (96 MB) and
up to 34 chunks.  Imports no JAX, so the ``cuda`` cases run on a machine
without it (``--noconftest``).
"""

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.ops import scan
from tempest_tpu_torch.pipeline import offline
from tempest_tpu_torch.utils import profiling
from tempest_tpu_torch.utils.device import (
    STAGED_CHUNK_BYTES, STAGED_MIN_BYTES, chunk_plan, staged_upload)

MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
CHUNK = STAGED_CHUNK_BYTES
# The smallest multiple of the chunk that takes the staged path.
STAGED_MULTIPLE = -(-STAGED_MIN_BYTES // CHUNK) * CHUNK
DTYPES = {"int16": np.int16, "float32": np.float32, "complex64": np.complex64}


@pytest.fixture(autouse=True)
def _tracer_on():
    profiling.disable()
    profiling.reset()
    profiling.enable()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _counter(name):
    return profiling.summary()["counters"].get(name, 0)


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def _random(nbytes, dtype, seed=0):
    """``nbytes`` of random bits as an array of ``dtype`` (NaNs and all)."""
    raw = np.random.default_rng(seed).integers(0, 256, nbytes, dtype=np.uint8)
    return raw.view(dtype)


def _iq(fs, seconds, seed):
    return np.asarray(tp.generate_iq(MODE, fs, int(fs * seconds), snr_db=20.0, seed=seed).iq,
                      np.complex64)


def _words(iq, scale=8000.0):
    return np.round(np.stack([iq.real, iq.imag], axis=1).reshape(-1) * scale).astype(np.int16)


def _timing(t):
    return t.mode_name, t.refresh_hz, t.line_count


def _harmonics(n):
    cap = tp.generate_iq_harmonics(MODE, 8e6, n, [-2.4e6, 1.8e6], amplitudes=[1.0, 0.7],
                                   depths=[0.8, -0.8], snr_db=6.0, seed=5)
    return _words(np.asarray(cap.iq, np.complex64), 4096.0)


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("nbytes", [1, 2 * 3 * 5, STAGED_MIN_BYTES - 1, STAGED_MULTIPLE,
                                    STAGED_MULTIPLE + 1, 33 * CHUNK + 6])
def test_chunk_plan_covers_every_byte_once(nbytes):
    plan = chunk_plan(nbytes)
    assert plan[0][0] == 0 and plan[-1][1] == nbytes
    for (a, b), (c, _) in zip(plan, plan[1:]):
        assert b == c, "ranges must follow one another with no gap or overlap"
    assert all(0 < b - a <= CHUNK for a, b in plan)
    assert len(plan) == -(-nbytes // CHUNK)
    # Every byte exactly once, counted directly.
    if nbytes < 1 << 16:
        covered = np.zeros(nbytes, np.int64)
        for a, b in plan:
            covered[a:b] += 1
        assert (covered == 1).all()


def test_chunk_plan_of_nothing_is_empty():
    assert chunk_plan(0) == []


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nbytes", [24, STAGED_MULTIPLE])
def test_staged_upload_on_the_cpu_is_the_one_copy(dtype, nbytes):
    x = np.zeros(nbytes // np.dtype(DTYPES[dtype]).itemsize, DTYPES[dtype])
    x[:3] = 7
    got = staged_upload(x, "cpu")
    want = torch.from_numpy(x).to("cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    # As before: the CPU tensor is the array itself, no copy.
    assert got.data_ptr() == want.data_ptr() == x.ctypes.data
    assert _counter("upload.staged.bytes") == 0 and _counter("upload.staged.chunks") == 0


def test_words_on_the_cpu_are_the_upload_they_were():
    iq = _iq(2e6, 0.01, 1)
    words = scan._words(iq, "cpu")
    assert torch.equal(_bits(words), _bits(torch.from_numpy(iq.view(np.float32))))
    w16 = _words(iq)
    assert torch.equal(scan._words(w16, "cpu"), torch.from_numpy(w16))
    assert _counter("upload.staged.bytes") == 0


def test_auto_reconstruct_stages_nothing_on_the_cpu():
    words = _words(_iq(2e6, 0.3, 5))
    offline.auto_reconstruct(words, 2e6, device="cpu")
    assert _counter("offline.upload.bytes") == words.nbytes
    assert _counter("upload.staged.bytes") == 0 and _counter("upload.staged.chunks") == 0


def test_combined_reconstruct_stages_nothing_on_the_cpu():
    words = _harmonics(1 << 20)
    offline.combined_reconstruct(words, 8e6, [-2.4e6, 1.8e6], chan_bw=2e6, alpha=0.7,
                                 device="cpu")
    assert _counter("offline.upload.bytes") == words.nbytes
    assert _counter("upload.staged.bytes") == 0


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staged upload copies through pinned blocks to one")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size", ["below", "multiple", "multiple_and_odd"])
def test_staged_upload_is_the_one_copy_to_the_bit(dtype, size):
    card = _card()
    item = np.dtype(DTYPES[dtype]).itemsize
    nbytes = {"below": STAGED_MIN_BYTES - 5 * item, "multiple": STAGED_MULTIPLE,
              "multiple_and_odd": STAGED_MULTIPLE + 3 * item}[size]
    x = _random(nbytes, DTYPES[dtype], seed=nbytes)
    if dtype == "complex64":
        x = x.view(np.float32)  # complex captures go up as their words
    got = staged_upload(x, card)
    want = torch.from_numpy(x).to(card)
    assert got.device == want.device and got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    staged = 0 if size == "below" else nbytes
    assert _counter("upload.staged.bytes") == staged
    assert _counter("upload.staged.chunks") == (len(chunk_plan(nbytes)) if staged else 0)


@pytest.mark.cuda
def test_odd_byte_count_is_the_one_copy_to_the_bit():
    card = _card()
    x = _random(STAGED_MULTIPLE + 1, np.uint8, seed=3)
    assert torch.equal(staged_upload(x, card), torch.from_numpy(x).to(card))
    assert _counter("upload.staged.bytes") == x.nbytes


@pytest.mark.cuda
def test_source_overwritten_after_the_call_leaves_the_card_as_it_was():
    card = _card()
    x = _random(STAGED_MULTIPLE + 6, np.int16, seed=4)
    kept = torch.from_numpy(x.copy())
    # The stream is busy, so the chunks' copies are still queued on return.
    torch.cuda._sleep(50_000_000)
    got = staged_upload(x, card)
    x[:] = 0
    assert torch.equal(_bits(got.cpu()), _bits(kept))


@pytest.mark.cuda
def test_many_chunks_through_the_same_blocks_behind_a_busy_stream():
    card = _card()
    x = _random(33 * CHUNK + 12, np.float32, seed=5)
    # Each chunk's copy waits behind the sleep: a block refilled before its
    # previous copy ran would put the wrong bytes on the card.
    torch.cuda._sleep(200_000_000)
    got = staged_upload(x, card)
    assert torch.equal(_bits(got), _bits(torch.from_numpy(x).to(card)))
    assert _counter("upload.staged.chunks") == 34
    # Another upload at once takes blocks only once their copies ended.
    y = _random(x.nbytes, np.float32, seed=6)
    again = staged_upload(y, card)
    assert torch.equal(_bits(again), _bits(torch.from_numpy(y).to(card)))
    assert torch.equal(_bits(got), _bits(torch.from_numpy(x).to(card)))


@pytest.mark.cuda
def test_auto_reconstruct_stages_every_byte_of_a_large_recording():
    card = _card()
    one = _words(_iq(2e6, 0.3, 5))
    words = np.tile(one, -(-STAGED_MULTIPLE // one.nbytes))
    assert words.nbytes >= STAGED_MIN_BYTES
    timing, recon = offline.auto_reconstruct(words, 2e6, device=card)
    assert _counter("upload.staged.bytes") == _counter("offline.upload.bytes") == words.nbytes
    # The same call on the words already on the card: the same arrays, to the bit.
    timing_t, recon_t = offline.auto_reconstruct(torch.from_numpy(words).to(card), 2e6,
                                                 device=card)
    assert _timing(timing) == _timing(timing_t)
    for name in ("image", "image_raw", "frames", "sync", "score"):
        a, b = getattr(recon, name), getattr(recon_t, name)
        assert np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                              np.ascontiguousarray(b).view(np.uint8)), name


@pytest.mark.cuda
def test_combined_reconstruct_stages_every_byte_of_a_large_recording():
    card = _card()
    one = _harmonics(1 << 20)
    n = 1 << 20
    while 4 * n < STAGED_MIN_BYTES:  # the part read: a power of two of samples
        n *= 2
    words = np.tile(one, n // (1 << 20))
    args = (8e6, [-2.4e6, 1.8e6])
    kw = dict(chan_bw=2e6, alpha=0.7, device=card)
    timing, recon, comb = offline.combined_reconstruct(words, *args, **kw)
    assert _counter("upload.staged.bytes") == _counter("offline.upload.bytes") == words.nbytes
    timing_t, recon_t, comb_t = offline.combined_reconstruct(
        torch.from_numpy(words).to(card), *args, **kw)
    assert _timing(timing) == _timing(timing_t)
    assert np.array_equal(comb.envelope, comb_t.envelope)
    for name in ("image", "image_raw", "frames"):
        assert np.array_equal(getattr(recon, name), getattr(recon_t, name)), name

