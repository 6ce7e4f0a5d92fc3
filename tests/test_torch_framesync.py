"""Parity of the port's frame sync and alignment with the JAX package's.

The port works on a leading frame axis; the JAX functions run per frame.
Sync compares on screens of a synthetic capture, where the blanking peak is
clear: the profile sums and the prefix cumsum reassociate between the two
libraries (f32, ~1e-7 relative), which moves the parabola's fraction by far
less than 1e-3 px and cannot flip the integer argmax on such a peak."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempest_tpu.ops import framesync as jfs
from tempest_tpu_torch.io.synthetic import generate_iq
from tempest_tpu_torch.ops import framesync as pfs
from tempest_tpu_torch.ops.resample_kernel import frames_to_screens
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

SHAPE = (48, 64)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def screens():
    """Six raw (unaligned) screens of a 640x480 capture at 2 Msps."""
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    fs = 2e6
    spf = fs / mode.refresh
    n_frames = 6
    cap = generate_iq(mode, fs, int(np.ceil(spf * (n_frames + 1))), snr_db=18.0, seed=11)
    env = torch.from_numpy(np.abs(cap.iq).astype(np.float32))
    # Starts off the frame grid so the blanking sits at varied positions.
    starts = torch.from_numpy(np.round(np.arange(n_frames) * spf * 1.013 + 777).astype(np.int32))
    return frames_to_screens(env, starts, int(spf), mode.height, mode.width, SHAPE).numpy()


def _circ_diff(a, b, n):
    d = np.abs(a - b) % n
    return np.minimum(d, n - d)


def test_frame_sync_subpixel_matches_jax(screens):
    s_y, s_x, score = pfs.frame_sync_subpixel(torch.from_numpy(screens))
    ref = [jfs.frame_sync_subpixel(jnp.asarray(f)) for f in screens]
    ry, rx, rs = (np.array([float(r[i]) for r in ref]) for i in range(3))
    # Integer part (the argmax centre: the fraction is clipped to ±0.5).
    np.testing.assert_array_equal(np.round(s_y.numpy()), np.round(ry))
    np.testing.assert_array_equal(np.round(s_x.numpy()), np.round(rx))
    assert _circ_diff(s_y.numpy(), ry, SHAPE[0]).max() < 1e-3
    assert _circ_diff(s_x.numpy(), rx, SHAPE[1]).max() < 1e-3
    np.testing.assert_allclose(score.numpy(), rs, rtol=1e-4)


def test_frame_sync_integer_matches_jax(screens):
    s_y, s_x, score = pfs.frame_sync(torch.from_numpy(screens))
    ref = [jfs.frame_sync(jnp.asarray(f)) for f in screens]
    np.testing.assert_array_equal(s_y.numpy(), [int(r[0]) for r in ref])
    np.testing.assert_array_equal(s_x.numpy(), [int(r[1]) for r in ref])
    np.testing.assert_allclose(score.numpy(), [float(r[2]) for r in ref], rtol=1e-4)


@pytest.mark.parametrize("method", ["contrast", "reference"])
def test_score_matrices_match_jax(screens, method):
    """The (w, c) score matrices of the row and column profiles; 1e-4
    relative to the largest score (window sums are prefix differences)."""
    for axis, frac in ((1, 0.01), (0, 0.05)):
        prof = np.stack([np.asarray(jfs.smooth_profile(jnp.asarray(f.sum(axis=axis))))
                         for f in screens])
        spec = jfs.sync_spec_for_axis(prof.shape[1], frac)
        jfn = jfs.contrast_scores if method == "contrast" else jfs.blank_scores
        pfn = pfs.contrast_scores if method == "contrast" else pfs.blank_scores
        ref = np.stack([np.asarray(jfn(jnp.asarray(p), spec)) for p in prof])
        got = pfn(torch.from_numpy(prof),
                  pfs.SyncSpec(spec.w_min, spec.w_max, spec.n)).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_smooth_profile_matches_jax():
    prof = np.random.default_rng(2).random((3, 50), dtype=np.float32)
    ref = np.stack([np.asarray(jfs.smooth_profile(jnp.asarray(p))) for p in prof])
    got = pfs.smooth_profile(torch.from_numpy(prof)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_align_frame_integer_matches_jax():
    img = np.random.default_rng(3).random((3, *SHAPE), dtype=np.float32)
    sy = np.array([0, 5, -7], np.int32)
    sx = np.array([63, -1, 20], np.int32)
    got = pfs.align_frame(torch.from_numpy(img), torch.from_numpy(sy), torch.from_numpy(sx))
    ref = np.stack([np.asarray(jfs.align_frame(jnp.asarray(f), int(a), int(b)))
                    for f, a, b in zip(img, sy, sx)])
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_align_frame_subpixel_matches_jax(interp):
    """Against the roll form within 1e-6 (the same taps and weights, summed
    in the same order) and against the circulant-matmul form within 1e-5
    (the same math, reassociated by the matrix products)."""
    rng = np.random.default_rng(4)
    img = rng.random((4, *SHAPE), dtype=np.float32)
    sy = np.array([2.6, -0.49, 40.25, 0.0], np.float32)
    sx = np.array([-1.3, 63.5, 0.125, 7.0], np.float32)
    got = pfs.align_frame_subpixel(torch.from_numpy(img), torch.from_numpy(sy),
                                   torch.from_numpy(sx), interp).numpy()
    roll = np.stack([np.asarray(jfs.align_frame_subpixel(
        jnp.asarray(f), jnp.float32(a), jnp.float32(b), interp))
        for f, a, b in zip(img, sy, sx)])
    mat = np.stack([np.asarray(jfs.align_frame_subpixel_matmul(
        jnp.asarray(f), jnp.float32(a), jnp.float32(b), interp))
        for f, a, b in zip(img, sy, sx)])
    assert np.abs(got - roll).max() < 1e-6
    assert np.abs(got - mat).max() < 1e-5


# Shifts of both signs, fractional and whole, and beyond the axis (48 rows,
# 64 columns) in both directions: the operator wraps them modulo n.
MATMUL_SHIFTS = [(2.6, -1.3), (-0.49, 63.5), (40.25, 0.125), (0.0, 7.0), (-130.75, 200.5)]


@pytest.mark.parametrize("interp", ["linear", "cubic"])
@pytest.mark.parametrize("n, s", [(48, 2.6), (48, -0.49), (64, 63.5), (64, -130.75), (48, 200.5),
                                  (64, 7.0)])
def test_shift_matrix_matches_jax(n, s, interp):
    """The operator's entries are the taps' weights, computed in float32 with
    the same operations; XLA may contract a product and a sum of the cubic
    weights into one FMA: a few ulps of a weight of at most 1 (1e-6)."""
    got = pfs.shift_matrix(n, torch.tensor(s, dtype=torch.float32), interp)
    ref = np.asarray(jfs.shift_matrix(n, jnp.float32(s), interp))
    assert got.shape == ref.shape == (n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # Each row holds the taps of one output sample: their weights sum to 1.
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_align_frame_subpixel_matmul_matches_jax_and_the_roll_form(interp):
    """Against the JAX package's matrix form and against the port's roll form
    within 1e-5: two matrix products of 48 and 64 terms sum the same two or
    four non-zero products in another order (f32 reassociation on values
    below 2).  A [F] batch equals the frames taken one by one."""
    rng = np.random.default_rng(5)
    img = rng.random((len(MATMUL_SHIFTS), *SHAPE), dtype=np.float32)
    sy = np.array([a for a, _ in MATMUL_SHIFTS], np.float32)
    sx = np.array([b for _, b in MATMUL_SHIFTS], np.float32)
    got = pfs.align_frame_subpixel_matmul(torch.from_numpy(img), torch.from_numpy(sy),
                                          torch.from_numpy(sx), interp)
    assert got.shape == img.shape
    ref = np.stack([np.asarray(jfs.align_frame_subpixel_matmul(
        jnp.asarray(f), jnp.float32(a), jnp.float32(b), interp))
        for f, a, b in zip(img, sy, sx)])
    assert np.abs(got.numpy() - ref).max() < 1e-5
    one = [pfs.align_frame_subpixel_matmul(torch.from_numpy(f), float(a), float(b), interp)
           for f, a, b in zip(img, sy, sx)]
    assert torch.equal(got, torch.stack(one))
    roll = pfs.align_frame_subpixel(torch.from_numpy(img), torch.from_numpy(sy),
                                    torch.from_numpy(sx), interp)
    assert np.abs(got.numpy() - roll.numpy()).max() < 1e-5
