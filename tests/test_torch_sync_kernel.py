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

The kernel's own sums do not depend on the batch or on how K2b's search is
split over a frame's cluster of blocks: a frame's results are the same bits
in a batch of 1, 36 and 144, and under every split.  The JAX package is imported inside
the parity tests, so that the ``cuda`` cases also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_sync_kernel.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tempest_tpu_torch._build import count_launches
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


def _windows(n, frac):
    spec = pfs.sync_spec_for_axis(n, frac)
    return (spec.w_max - spec.w_min + 1) * n


# Clusters of K2b blocks an NVIDIA H100 80GB HBM3 holds at once, by size, as
# its cudaOccupancyMaxActiveClusters gave them at 600x800 and at 150x200
# (exp/k2_clocks.py): two blocks of 512 threads an SM, a cluster within a GPC.
H100_CLUSTERS = {2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}


@pytest.mark.parametrize("shape,n_frames,size", [
    ((600, 800), 36, 6),      # the slice's block: 36 clusters of 6 in one wave
    ((600, 800), 39, 6),      # as many clusters of 6 as the card holds
    ((600, 800), 40, 3),      # one more would take a second wave
    ((600, 800), 144, 3),     # the batched step: no over-split
    ((150, 200), 52, 3),      # the mode search's screens
    ((600, 800), 1, 6),       # one frame
])
def test_search_split_fills_the_card_without_over_splitting(shape, n_frames, size):
    asked = []

    def occupancy(blocks):
        asked.append(blocks)
        return H100_CLUSTERS[blocks]

    assert sync_kernel.search_split(n_frames, occupancy) == size
    assert asked == [6], "the rule asks the card for clusters of 6 alone"


@pytest.mark.parametrize("n_frames,resident,size", [(6, 0, 3), (1, 1, 6), (6, 5, 3)])
def test_search_split_takes_three_when_the_clusters_of_six_do_not_fit(n_frames, resident,
                                                                     size):
    """A card (or a shared-memory size) that holds fewer clusters of 6 than
    there are frames gets clusters of 3, whatever it holds of them."""
    assert sync_kernel.search_split(n_frames, lambda blocks: resident) == size


@pytest.mark.parametrize("n_frames", [1, 2, 5, 36, 52, 144, 1000])
@pytest.mark.parametrize("shape", [(600, 800), (150, 200), (61, 83), (4, 4), (2434, 2048)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_search_split_is_a_cluster_the_kernel_takes(shape, n_frames):
    """2 to 8 blocks (the portable cluster size), and every flat index of
    the frame's windows, both axes, falls in exactly one block's slice,
    slices that do not divide evenly included."""
    h, w = shape
    windows = _windows(h, 0.01) + _windows(w, 0.05)
    size = sync_kernel.search_split(n_frames, H100_CLUSTERS.get)
    assert 2 <= size <= 8
    bounds = sync_kernel.slice_bounds(windows, size)
    covered = [i for k in range(size) for i in range(bounds[k], bounds[k + 1])]
    assert covered == list(range(windows))


@pytest.mark.parametrize("count", [1, 7, 5400, 87000, 128800, 128801])
def test_slices_cover_every_index_once_for_any_block_count(count):
    for parts in range(1, 9):
        bounds = sync_kernel.slice_bounds(count, parts)
        assert bounds[0] == 0 and bounds[-1] == count
        assert all(b - a in (count // parts, count // parts + 1)
                   for a, b in zip(bounds, bounds[1:]))


def test_shared_memory_fits_a_block_at_the_pipeline_screen_and_the_largest_mode():
    """K2a's and K2b's dynamic shared memory at 600x800 (every mode is
    downgraded to it by the pipeline) and at the largest mode of
    ``ALL_VIDEO_MODES`` undowngraded, within 227 KB."""
    mode = max(ALL_VIDEO_MODES.values(), key=lambda m: m.width * m.height)
    for h, w in ((600, 800), (mode.height, mode.width)):
        a, b = sync_kernel.shared_bytes(h, w)
        assert a <= 227 * 1024 and b <= 227 * 1024 - 1024, (h, w, a, b)
    # 600x800: 8 warps' column partials; the rows' prefix (3 of padding +
    # 600 + 2 x 150 + 1, to 904) and the columns' (3 + 1201); the padded
    # profile (1200) and two profiles of 800.
    assert sync_kernel.shared_bytes(600, 800) == (4 * 8 * 800, 4 * (904 + 1204 + 1200 + 1600))


@pytest.mark.parametrize("subpixel", [False, True], ids=["integer", "subpixel"])
def test_pairs_are_the_centres_a_row(subpixel):
    screens = _screens(SHAPES[0])
    s_y, s_x, score, pairs = sync_kernel.blanking_sync(screens, subpixel=subpixel, pairs=True)
    ref = sync_kernel.blanking_sync(screens, subpixel=subpixel)
    assert torch.equal(s_y, ref[0]) and torch.equal(s_x, ref[1]) and torch.equal(score, ref[2])
    assert pairs.dtype == s_y.dtype and pairs.is_contiguous()
    assert torch.equal(pairs, torch.stack([s_y, s_x], dim=1))


def test_search_cost_counts_the_profiles_and_the_windows():
    n_frames, h, w = 36, 600, 800
    nbytes, instructions = sync_kernel.search_cost(n_frames, h, w)
    assert nbytes == 4 * n_frames * (h + 19 * w) + 12 * n_frames   # 2.2 MB at the slice
    windows = _windows(h, 0.01) + _windows(w, 0.05)
    assert windows == 87000 + 128800
    # Two loads, two differences, two quotients of three from hoisted
    # reciprocals, the difference of the means, its square, one comparison.
    assert sync_kernel.SCORE_INSTRUCTIONS == 13
    assert instructions == n_frames * 13 * windows


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
    with count_launches() as seen:
        got = sync_kernel.blanking_sync(screens, method=method, subpixel=subpixel)
    ref = sync_kernel.blanking_sync_plain(screens, method=method, subpixel=subpixel)
    torch.cuda.synchronize()
    assert seen == {"k2": 2}
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


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _special_screens(shape, n_frames, seed=7):
    """``n_frames`` screens of the capture, scaled per frame, with a NaN
    frame and a constant zero frame (every window ties, exactly: no sum
    rounds) among them."""
    base = _screens(shape).numpy()
    rng = np.random.default_rng(seed)
    frames = base[np.arange(n_frames) % len(base)] * rng.uniform(0.9, 1.1, (n_frames, 1, 1))
    frames = frames.astype(np.float32)
    if n_frames >= 3:
        frames[1, 3, 5] = np.nan
        frames[2] = 0.0
    return torch.from_numpy(frames)


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames", [1, 2, 36, 52, 144])
@pytest.mark.parametrize("shape", [(60, 80), (61, 83)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subpixel", [False, True], ids=["integer", "subpixel"])
def test_k2_split_over_blocks_of_a_cluster_matches_plain(cuda_device, subpixel, shape, n_frames):
    """The frame counts of a single frame, the slice's block, the mode
    search and the batched step; 60x80 has w_max = n / 4 on both axes, 61x83
    slices that do not divide evenly.  Against the plain version (the NaN and
    the constant frame: the same centres, a NaN score), and each frame's bits
    the same as alone."""
    frames = _special_screens(shape, n_frames).to(cuda_device)
    got = sync_kernel.blanking_sync(frames, subpixel=subpixel)
    ref = sync_kernel.blanking_sync_plain(frames, subpixel=subpixel)
    torch.cuda.synchronize()
    special = [1, 2] if n_frames >= 3 else []
    normal = [k for k in range(n_frames) if k not in special]
    _hold([t[normal] for t in got], [t[normal] for t in ref], subpixel, f"{n_frames}", shape)
    for k in special:
        assert torch.equal(got[0][k], ref[0][k]) and torch.equal(got[1][k], ref[1][k])
    if special:
        assert torch.isnan(got[2][1]) and float(got[2][2]) == 0.0
    for k in sorted({0, n_frames - 1, *special}):
        alone = sync_kernel.blanking_sync(frames[k:k + 1].contiguous(), subpixel=subpixel)
        assert _same_bits([a[0:1] for a in alone], [b[k:k + 1] for b in got]), f"frame {k}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(60, 80), (61, 83)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subpixel", [False, True], ids=["integer", "subpixel"])
def test_k2_bits_do_not_depend_on_the_split(cuda_device, subpixel, shape):
    """Every cluster of 2 to 8 blocks gives the same bits, the [F, 2] pairs
    included: no sum crosses a block, and the argmax's order is total."""
    frames = _special_screens(shape, 6).to(cuda_device)
    ref = sync_kernel._launch(frames, 0.01, 0.05, 0, subpixel, True, split=2)
    for size in range(3, 9):
        got = sync_kernel._launch(frames, 0.01, 0.05, 0, subpixel, True, split=size)
        assert _same_bits(got, ref), size
    assert torch.equal(_bits(ref[3]), _bits(torch.stack(ref[:2], dim=1)))
