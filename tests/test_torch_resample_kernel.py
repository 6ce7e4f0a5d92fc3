"""Parity of K1 (``tempest_tpu_torch.ops.resample_kernel``) with the Pallas
kernel it ports, ``frames_to_screens_pallas`` run in interpret mode.

On the CPU the wrapper runs K1's plain PyTorch version.  Tolerance 1e-5
relative to the largest output, all rows included: the Pallas kernel carries
the line fractions and the vertical weights in 16.16 fixed point, K1 in
float32, so read positions differ by at most 2⁻¹⁷ sample (the bar of
``tests/test_ops.py`` for the Pallas kernel against the gather path).

The JAX package is imported inside the parity tests, so that this module
also loads where JAX is not installed: on the GPU machine the CUDA case runs
with ``python -m pytest --noconftest tests/test_torch_resample_kernel.py -m cuda``."""

import numpy as np
import pytest
import torch

from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.io.synthetic import generate_iq
from tempest_tpu_torch.ops.resample import _screen_geometry
from tempest_tpu_torch.ops.resample_kernel import (
    frame_to_screen,
    frames_to_screens,
    frames_to_screens_plain,
    screen_geometry,
)
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return torch.device("cuda", 0)


def _envelope(mode, fs, n, seed):
    cap = generate_iq(mode, fs, n, snr_db=18.0, seed=seed)
    return np.abs(cap.iq).astype(np.float32)


def _jax_pallas():
    """The JAX package's Pallas module and jax.numpy (the reference side)."""
    return (pytest.importorskip("tempest_tpu.ops.pallas_resample"),
            pytest.importorskip("jax.numpy"))


def _pallas(env, starts, frame_len, mode, shape):
    pallas, jnp = _jax_pallas()
    return np.asarray(pallas.frames_to_screens_pallas(
        jnp.asarray(env), jnp.asarray(starts), frame_len, mode.height, mode.width,
        shape, interpret=True))


def _port(env, starts, frame_len, mode, shape):
    return frames_to_screens(torch.from_numpy(env), torch.from_numpy(starts),
                             frame_len, mode.height, mode.width, shape).numpy()


def _max_read(starts, frame_len, mode, shape):
    """Largest envelope index the resampler reads (before the end clamp)."""
    start, frac, _, cols, _ = _screen_geometry(frame_len, mode.height, mode.width, shape)
    line_start = np.maximum(start, 0)
    line_frac = frac + (start - line_start)
    last = np.floor(np.maximum(cols[-1] + line_frac, 0.0)).astype(np.int64) + 1
    return int(starts.max()) + int((line_start + last).max()), int(line_start.max())


def test_k1_plain_matches_pallas_with_end_clamp():
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    fs, shape = 2e6, (48, 64)
    frame_len = int(np.floor(fs / mode.refresh))
    n = 3 * frame_len + 1
    env = _envelope(mode, fs, n, seed=5)
    # The last frame starts late enough that its bottom rows read past the
    # block end, but its line spans still start inside the block (where the
    # Pallas wrapper's edge padding and K1's index clamp agree).
    _, max_line = _max_read(np.zeros(1, np.int32), frame_len, mode, shape)
    last = n - max_line - 20
    starts = np.array([0, frame_len // 3, last], np.int32)
    max_read, _ = _max_read(starts, frame_len, mode, shape)
    assert max_read > n - 1, (max_read, n)
    ref = _pallas(env, starts, frame_len, mode, shape)
    got = _port(env, starts, frame_len, mode, shape)
    assert got.shape == ref.shape == (3, 48, 64)
    assert np.abs(got - ref).max() / np.abs(ref).max() < REL


def test_k1_plain_matches_pallas_at_slice_geometry():
    """The slice's own geometry: 1080p60 at 20 Msps onto 600x800, 2 frames
    at carried-phase starts.  On a smooth signal (as tests/test_ops.py holds
    the Pallas kernel against the gather path) within 1e-5 relative.  On the
    capture's noisy envelope, whose neighbouring samples differ by up to its
    whole range, the bound follows from the fixed point instead: a tap's
    position moves by the 2⁻¹⁷ quantisation of its fraction plus one f32
    rounding step of the sum ``c·delta + frac`` (which that quantisation can
    flip), times the largest step between neighbouring samples; the vertical
    weight moves by 2⁻¹⁷ of the envelope's range."""
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    fs, shape = 20e6, (600, 800)
    spf = fs / mode.refresh
    frame_len = int(np.floor(spf))
    n = int(np.ceil(2 * spf)) + 1 + int(np.ceil(spf))
    starts = np.floor(np.float32(123456.7) + np.float32(spf) * np.arange(2, dtype=np.float32)
                      + np.float32(0.5)).astype(np.int32)
    t = np.arange(n)
    smooth = (1.5 + np.sin(2 * np.pi * t / 797.0)
              + 0.3 * np.cos(2 * np.pi * t / 91.0)).astype(np.float32)
    ref = _pallas(smooth, starts, frame_len, mode, shape)
    got = _port(smooth, starts, frame_len, mode, shape)
    assert np.abs(got - ref).max() / np.abs(ref).max() < REL

    env = _envelope(mode, fs, n, seed=33)
    ref = _pallas(env, starts, frame_len, mode, shape)
    got = _port(env, starts, frame_len, mode, shape)
    max_pos = (shape[1] - 1) * (mode.width / shape[1]) * (frame_len / (mode.height * mode.width)) + 1
    tap = (2.0 ** -17 + float(np.spacing(np.float32(max_pos)))) * float(np.abs(np.diff(env)).max())
    bound = tap + 2.0 ** -17 * float(env.max() - env.min()) + 1e-6 * float(np.abs(ref).max())
    assert np.abs(got - ref).max() < bound


def test_frame_to_screen_matches_pallas_single_frame():
    """The single-frame wrapper on a smooth test signal (as tests/test_ops.py
    holds the Pallas kernel against the gather path)."""
    y_t, x_t, shape = 525, 800, (48, 64)
    t = np.arange(66666)
    sig = (np.sin(2 * np.pi * t / 797.0) + 0.3 * np.cos(2 * np.pi * t / 91.0)).astype(np.float32)
    pallas, jnp = _jax_pallas()
    ref = np.asarray(pallas.frame_to_screen_pallas(jnp.asarray(sig), y_t, x_t, shape,
                                                   interpret=True))
    got = frame_to_screen(torch.from_numpy(sig), y_t, x_t, shape).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < REL


def test_wrapper_counts_only_kernel_launches():
    """On a CPU tensor the wrapper runs the plain version and leaves the
    launch count alone; it rejects devices and shapes it does not take."""
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    env = torch.from_numpy(_envelope(mode, 2e6, 40000, seed=1))
    with count_launches() as seen:
        frames_to_screens(env, torch.zeros(1, dtype=torch.int32), 33333,
                          mode.height, mode.width, (48, 64))
    assert not seen
    with pytest.raises(ValueError):
        frames_to_screens(env[None], torch.zeros(1, dtype=torch.int32), 33333,
                          mode.height, mode.width, (48, 64))


@pytest.mark.cuda
def test_k1_cuda_matches_plain(cuda_device):
    """K1 against its plain version on the card, at the slice's shapes.
    Tolerance 1e-6 relative: both do the same f32 operations in the same
    order (the kernel forbids FMA contraction)."""
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    fs, shape = 20e6, (600, 800)
    spf = fs / mode.refresh
    frame_len = int(np.floor(spf))
    n = int(np.ceil(36 * spf)) + 1 + int(np.ceil(spf))
    rng = np.random.default_rng(0)
    env = torch.from_numpy(rng.random(n, dtype=np.float32)).to(cuda_device)
    starts = np.floor(np.float32(1000.25) + np.float32(spf) * np.arange(36, dtype=np.float32)
                      + np.float32(0.5)).astype(np.int32)
    starts = torch.from_numpy(starts).to(cuda_device)
    with count_launches() as seen:
        got = frames_to_screens(env, starts, frame_len, mode.height, mode.width, shape)
    assert seen == {"k1": 1, ("k1", 2, False): 1}
    geom = screen_geometry(frame_len, mode.height, mode.width, shape, env.device)
    ref = frames_to_screens_plain(env, starts, geom)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(600, 99), (601, 402), (300, 2048), (48, 99)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k1_cuda_matches_plain_at_other_widths(cuda_device, shape):
    """Widths that take the kernel's other work splits: no multiple of 4
    (one column a work item, with fewer and with more work items a row than
    a block has threads), more than 4 x 256 columns, and so few rows that
    the wrapper takes fewer rows a tile.  The last frame reads past the
    block end."""
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    spf = 20e6 / mode.refresh
    frame_len = int(np.floor(spf))
    n = 3 * frame_len - 4000
    env = torch.from_numpy(np.random.default_rng(1).random(n, dtype=np.float32)).to(cuda_device)
    starts = torch.tensor([0, frame_len + 3, 2 * frame_len + 1], dtype=torch.int32,
                          device=cuda_device)
    got = frames_to_screens(env, starts, frame_len, mode.height, mode.width, shape)
    geom = screen_geometry(frame_len, mode.height, mode.width, shape, env.device)
    ref = frames_to_screens_plain(env, starts, geom)
    torch.cuda.synchronize()
    assert got.shape == (3, *shape)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(600, 800), (48, 99)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_frame_to_screen_cuda_matches_plain(cuda_device, shape):
    """The single-frame wrapper on the card: one launch of its own (counted
    under the single frame's variant, not the envelope entry's), equal to
    the plain version of the same frame."""
    y_t, x_t = 1125, 2576
    sig = torch.from_numpy(np.random.default_rng(2).random(333333, dtype=np.float32)).to(cuda_device)
    with count_launches() as seen:
        got = frame_to_screen(sig, y_t, x_t, shape)
    assert seen == {"k1": 1, ("k1", 2, False, "frame"): 1}
    geom = screen_geometry(sig.shape[0], y_t, x_t, shape, sig.device)
    ref = frames_to_screens_plain(sig, torch.zeros(1, dtype=torch.int32, device=sig.device), geom)[0]
    torch.cuda.synchronize()
    assert got.shape == shape
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6


# The main path's screen and the shapes whose work splits it does not take (one
# column a work item, fewer and more work items a row than threads, few rows).
FRAME_SHAPES = [(600, 800), (600, 99), (601, 402), (300, 2048), (48, 99)]


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("offset", [None, 0.6], ids=["no_offset", "offset"])
@pytest.mark.parametrize("shape", FRAME_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_frame_to_screen_cuda_is_one_launch_equal_to_plain_to_the_bit(
        cuda_device, shape, offset, taps):
    """One 1080p60 frame at 20 Msps (333,333 samples) through the
    single-frame launch, with its tile plan of fewer rows and one stage
    buffer: equal to the plain version to the bit, one launch, and one
    allocation on the card, the screen (the start is a cached device 0, the
    residual a scalar: no fill kernel, no upload); a residual given as a
    tensor on the card gives the same bits.  (Allocations, not a profiler:
    twenty CUDA-only profiler sessions here left a later one in the same
    process, ``tests/test_torch_align_ema.py``'s, recording no kernel.)"""
    y_t, x_t = 1125, 2576
    sig = torch.from_numpy(np.random.default_rng(3).random(333333, dtype=np.float32)).to(cuda_device)
    geom = screen_geometry(sig.shape[0], y_t, x_t, shape, sig.device)
    fracs = None if offset is None else torch.full((1,), offset, device=cuda_device)
    ref = frames_to_screens_plain(sig, torch.zeros(1, dtype=torch.int32, device=cuda_device),
                                  geom, fracs, taps)[0]
    frame_to_screen(sig, y_t, x_t, shape, offset, taps)   # plan, build and caches made
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"]
    with count_launches() as seen:
        got = frame_to_screen(sig, y_t, x_t, shape, offset, taps)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"] == allocated + 1
    assert seen == {"k1": 1, ("k1", taps, offset is not None, "frame"): 1}
    assert got.shape == shape and torch.equal(got, ref)
    if fracs is not None:
        assert torch.equal(frame_to_screen(sig, y_t, x_t, shape, fracs, taps), ref)
