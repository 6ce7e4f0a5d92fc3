"""K2, the blanking sync (``tempest_tpu_torch.ops.sync_kernel``): its wrapper,
its cost count, its plain version against the JAX package's sync, and — on a
card — the kernel against its plain version.

On the CPU the wrapper runs the plain version.  Tolerances of the kernel
against the plain version on the card (the ``cuda`` cases): the same
operations in another summation order (the profiles' sums, the total and the
prefix; about 1e-7 relative each), so

* the integer centres are equal on screens with a clear blanking peak;
* the sub-pixel centres agree within ``FRAC_TOL`` = 1e-2 px: the parabola's
  denominator is the score's curvature, a few 1e-3 of the peak score, so a
  1e-7 difference of prefix sums that cancel to a window of a tenth of their
  size moves the fraction by some 1e-3 px (card against CPU measured 2.7e-3
  px before K2);
* the scores agree within ``SCORE_REL`` = 1e-4 relative: a window sum that is
  a tenth of the prefix it is the difference of carries 1e-6 of relative
  error, a contrast of 10% of the mean 1e-5, its square twice that.

The kernel's own sums do not depend on the batch: a frame's results are the
same bits in a batch of 1, 36 and 144.  The JAX package is imported inside
the parity tests, so that the ``cuda`` cases also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_sync_kernel.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tempest_tpu_torch.io.synthetic import generate_iq
from tempest_tpu_torch.ops import framesync as pfs
from tempest_tpu_torch.ops import sync_kernel
from tempest_tpu_torch.ops.resample_kernel import frames_to_screens
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

SHAPES = ((30, 40), (60, 80))
FRAC_TOL = 1e-2      # px
SCORE_REL = 1e-4


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
        pytest.skip("needs a CUDA card: K2 has no CPU mode")
    return torch.device("cuda", 0)


def _screens(shape, n_frames=6, seed=11):
    """Raw (unaligned) screens of a 640x480 capture at 2 Msps, cut off the
    frame grid so that the blanking sits at varied positions."""
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    spf = 2e6 / mode.refresh
    cap = generate_iq(mode, 2e6, int(np.ceil(spf * (n_frames + 2))), snr_db=18.0, seed=seed)
    env = torch.from_numpy(np.abs(cap.iq).astype(np.float32))
    starts = np.round(np.arange(n_frames) * spf * 1.013 + 777).astype(np.int32)
    return frames_to_screens(env, torch.from_numpy(starts), int(spf), mode.height, mode.width,
                             shape)


def _jax_sync():
    return (pytest.importorskip("tempest_tpu.ops.framesync"),
            pytest.importorskip("jax.numpy"))


# ------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("bad", ["two_dims", "method", "device"])
def test_wrapper_checks_its_arguments(bad):
    frames = torch.zeros(2, 30, 40)
    with pytest.raises(ValueError):
        if bad == "two_dims":
            sync_kernel.blanking_sync(frames[0])
        elif bad == "method":
            sync_kernel.blanking_sync(frames, method="median")
        else:
            sync_kernel.blanking_sync(frames.to("meta"))


def test_a_screen_with_no_width_to_search_is_refused_by_the_cost_count():
    with pytest.raises(ValueError, match="no blanking width"):
        sync_kernel.launch_cost(1, 30, 40, y_min_frac=0.5)


@pytest.mark.parametrize("subpixel", [False, True], ids=["integer", "subpixel"])
def test_launch_cost_counts_the_screens_once_and_three_outputs(subpixel):
    n_frames, h, w = 5, 30, 40
    nbytes, flops = sync_kernel.launch_cost(n_frames, h, w, subpixel=subpixel)
    assert nbytes == 4 * n_frames * h * w + 3 * 4 * n_frames
    # Rows: w in [ceil(0.3), 7] = [1, 7]; columns: [ceil(2), 10] = [2, 10].
    per_frame = (2 * h * w + 11 * h + 2 * 7 + 8 * 7 * h
                 + 11 * w + 2 * 10 + 8 * 9 * w + (80 if subpixel else 0))
    assert flops == n_frames * per_frame


@pytest.mark.parametrize("subpixel", [False, True], ids=["integer", "subpixel"])
def test_frame_sync_on_the_cpu_is_the_plain_version(subpixel):
    screens = _screens(SHAPES[0])
    fn = pfs.frame_sync_subpixel if subpixel else pfs.frame_sync
    got = fn(screens)
    ref = sync_kernel.blanking_sync_plain(screens, subpixel=subpixel)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert got[0].dtype == (torch.float32 if subpixel else torch.int32)


@pytest.mark.parametrize("method", ["contrast", "reference"])
@pytest.mark.parametrize("subpixel", [False, True], ids=["integer", "subpixel"])
def test_plain_version_matches_jax(method, subpixel):
    """The plain version against the JAX package's per-frame sync: integer
    centres equal, fractions within 1e-3 px, scores within 1e-4 relative
    (the profiles' sums and the prefix reassociate between the libraries,
    as ``tests/test_torch_framesync.py`` states)."""
    jfs, jnp = _jax_sync()
    screens = _screens(SHAPES[1])
    s_y, s_x, score = sync_kernel.blanking_sync_plain(screens, method=method, subpixel=subpixel)
    jfn = jfs.frame_sync_subpixel if subpixel else jfs.frame_sync
    ref = [jfn(jnp.asarray(f), method=method) for f in screens.numpy()]
    ry, rx, rs = (np.array([float(r[i]) for r in ref]) for i in range(3))
    np.testing.assert_array_equal(np.round(s_y.numpy()), np.round(ry))
    np.testing.assert_array_equal(np.round(s_x.numpy()), np.round(rx))
    assert np.abs(s_y.numpy() - ry).max() < 1e-3 and np.abs(s_x.numpy() - rx).max() < 1e-3
    np.testing.assert_allclose(score.numpy(), rs, rtol=1e-4)


# ------------------------------------------------------------- on the card
def _circular_diff(a, b, n):
    d = (a - b).abs() % n
    return torch.minimum(d, n - d)


def _hold(got, ref, subpixel, what, shape):
    s_y, s_x, score = got
    r_y, r_x, r_score = ref
    assert s_y.dtype == r_y.dtype and s_x.dtype == r_x.dtype, what
    if subpixel:
        # The same centre: the same argmax, or its neighbour with the
        # fraction clamped at +-0.5 on both sides.
        assert float(_circular_diff(s_y, r_y, shape[0]).max()) < FRAC_TOL, f"{what}: rows"
        assert float(_circular_diff(s_x, r_x, shape[1]).max()) < FRAC_TOL, f"{what}: columns"
    else:
        assert torch.equal(s_y, r_y) and torch.equal(s_x, r_x), f"{what}: centres"
    rel = float(((score - r_score).abs() / r_score.abs()).max())
    assert rel < SCORE_REL, f"{what}: scores differ by {rel:.3e} relative"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("method", ["contrast", "reference"])
@pytest.mark.parametrize("subpixel", [False, True], ids=["integer", "subpixel"])
def test_k2_matches_plain(cuda_device, shape, method, subpixel):
    screens = _screens(shape).to(cuda_device)
    before = sync_kernel.blanking_sync.launches
    got = sync_kernel.blanking_sync(screens, method=method, subpixel=subpixel)
    ref = sync_kernel.blanking_sync_plain(screens, method=method, subpixel=subpixel)
    torch.cuda.synchronize()
    assert sync_kernel.blanking_sync.launches == before + 2
    _hold(got, ref, subpixel, f"{shape} {method}", shape)


@pytest.mark.cuda
@pytest.mark.parametrize("subpixel", [False, True], ids=["integer", "subpixel"])
def test_k2_gives_a_frame_the_same_bits_in_any_batch(cuda_device, subpixel):
    """Frames 0 and 35 alone, in a batch of 36 and in one of 144."""
    base = _screens(SHAPES[1]).numpy()
    rng = np.random.default_rng(5)
    frames = base[np.arange(144) % len(base)] * rng.uniform(0.9, 1.1, (144, 1, 1))
    frames = torch.from_numpy(frames.astype(np.float32)).to(cuda_device)
    outs = {n: sync_kernel.blanking_sync(frames[:n].contiguous(), subpixel=subpixel)
            for n in (36, 144)}
    for k in (0, 35):
        alone = sync_kernel.blanking_sync(frames[k:k + 1].contiguous(), subpixel=subpixel)
        for n, out in outs.items():
            for a, b in zip(alone, out):
                assert torch.equal(a[0], b[k]), f"frame {k} alone and in a batch of {n}"


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["contrast", "reference"])
@pytest.mark.parametrize("subpixel", [False, True], ids=["integer", "subpixel"])
def test_k2_on_degenerate_and_wrapping_screens(cuda_device, method, subpixel):
    """A zero screen (every window ties: the first, centre 0, no fraction),
    one with a NaN (a NaN wins the argmax: the first window that reads it),
    and one whose bright band wraps over the screen's edges on both axes (the
    windows wrap through the prefix's padding; bright, so that the reference
    score, which grows with the window's sum, has a clear peak too)."""
    h, w = SHAPES[1]
    zero = torch.zeros(1, h, w)
    nan = torch.ones(1, h, w)
    nan[0, 20, 30] = float("nan")
    wrapped = torch.ones(1, h, w)
    wrapped[0, :4] = wrapped[0, -3:] = 4.0
    wrapped[0, :, :5] = wrapped[0, :, -4:] = 4.0
    screens = torch.cat([zero, nan, wrapped]).to(cuda_device)
    s_y, s_x, score = sync_kernel.blanking_sync(screens, method=method, subpixel=subpixel)
    r_y, r_x, r_score = sync_kernel.blanking_sync_plain(screens, method=method, subpixel=subpixel)
    torch.cuda.synchronize()
    for got, ref in ((s_y, r_y), (s_x, r_x)):
        assert torch.equal(got[:2], ref[:2]), "zero and NaN screens: the same centres"
    assert float(s_y[0]) == 0.0 and float(s_x[0]) == 0.0 and float(score[0]) == 0.0
    assert torch.isnan(score[1]) and torch.isnan(r_score[1])
    _hold((s_y[2:], s_x[2:], score[2:]), (r_y[2:], r_x[2:], r_score[2:]), subpixel, "wrapped",
          (h, w))
    for s, n in ((s_y[2], h), (s_x[2], w)):  # the band, centred at 0
        assert min(abs(float(s)), abs(float(s) - n)) < 1.0


@pytest.mark.cuda
def test_k2_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    screens = _screens(SHAPES[0]).to(cuda_device)
    with pytest.raises(TypeError):
        sync_kernel.blanking_sync(screens.double())
    with pytest.raises(ValueError, match="contiguous"):
        sync_kernel.blanking_sync(screens.transpose(1, 2))
    with pytest.raises(ValueError, match="4x4"):
        sync_kernel.blanking_sync(screens[:, :3, :3].contiguous(), y_min_frac=0.0,
                                  x_min_frac=0.0)
