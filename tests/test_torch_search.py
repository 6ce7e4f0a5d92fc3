"""``mode_search_static`` of the port (one K1 launch over the candidate
geometries, one batched ``frame_sync``) against the JAX package's
static-table search, and ``auto_reconstruct(refine_with_search=True)``.

Shapes: 640x480 @ 60 Hz at 4 Msps, the JAX defaults otherwise (2 frames, a
150x200 score grid, 16 phases).  Tolerance on the scores: both sides round
the envelope to bfloat16 alike and read the same quantised positions, K1 in
float32 against float64 tables (2e-5 of a pixel's value, as in
``tests/test_torch_resamplers.py``); the JAX program pads each frame with its
last sample where K1 reads on, which touches the bottom row of a screen: 1 of
150 rows of the row profile.  The contrast score is a ratio of window sums of
the profiles, so 1e-3 relative holds both.  Measured: below 2e-4.
"""

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.ops import resample_kernel
from tempest_tpu_torch.parallel import sharded as psharded

MODE_NAME = "640x480 @ 60Hz"
MODE = tp.ALL_VIDEO_MODES[MODE_NAME]
FS = 4e6
SCORE_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def capture():
    return tp.generate_iq(MODE, FS, int(FS * 0.12), snr_db=20.0, seed=1)


@pytest.fixture(scope="module")
def jax_result(capture):
    jsharded = pytest.importorskip("tempest_tpu.parallel.sharded")
    jmodes = pytest.importorskip("tempest_tpu.video.modes")
    cands = jmodes.candidate_modes(60.0, tol_hz=0.5)
    return cands, jsharded.mode_search_static(capture.iq, FS, 60.0, cands)


def test_same_winner_and_scores_as_jax(capture, jax_result):
    jcands, ref = jax_result
    cands = tp.candidate_modes(60.0, tol_hz=0.5)
    assert [n for n, _ in cands] == [n for n, _ in jcands] and len(cands) > 10
    got = psharded.mode_search_static(capture.iq, FS, 60.0, cands, device="cpu")
    assert got.names == ref.names
    assert got.best_index == ref.best_index and got.names[got.best_index] == MODE_NAME
    assert got.best_mode == cands[got.best_index][1]
    assert got.scores.shape == ref.scores.shape == (len(cands),)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=SCORE_REL)
    assert list(np.argsort(got.scores)[::-1][:3]) == list(np.argsort(ref.scores)[::-1][:3])


def test_envelope_and_tensor_inputs_give_the_complex_input_s_scores(capture):
    cands = tp.candidate_modes(60.0, tol_hz=0.5)[:4]
    from_complex = psharded.mode_search_static(capture.iq, FS, 60.0, cands, device="cpu")
    env = np.abs(capture.iq).astype(np.float32)
    from_env = psharded.mode_search_static(env, FS, 60.0, cands, device="cpu")
    from_tensor = psharded.mode_search_static(torch.from_numpy(capture.iq), FS, 60.0, cands)
    # |z| as sqrt(re² + im²) of the words against numpy's hypot: an ulp apart,
    # which the bfloat16 rounding either absorbs or turns into one bfloat16
    # step on a few samples: 1e-4 on a score.
    np.testing.assert_allclose(from_env.scores, from_complex.scores, rtol=1e-4)
    np.testing.assert_allclose(from_tensor.scores, from_complex.scores, rtol=1e-4)


def test_options_and_errors(capture):
    cands = tp.candidate_modes(60.0, tol_hz=0.5)[:3]
    with pytest.raises(ValueError, match="empty candidate set"):
        psharded.mode_search_static(capture.iq, FS, 60.0, [], device="cpu")
    with pytest.raises(ValueError, match="samples for the mode search"):
        psharded.mode_search_static(capture.iq[:1000], FS, 60.0, cands, device="cpu")
    res = psharded.mode_search_static(capture.iq, FS, 60.0, cands, n_frames=3,
                                      score_size=(75, 100), num_phases=8, device="cpu")
    assert res.scores.shape == (3,) and np.isfinite(res.scores).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            psharded.mode_search_static(capture.iq, FS, 60.0, cands)


def test_one_resample_per_candidate_at_the_score_grid(capture, monkeypatch):
    """One call renders every candidate at the score grid: their rasters in
    the candidates' order, 16 phases, 2 frames of the float32 envelope."""
    calls = []
    real = psharded.frames_to_screens_candidates

    def counted(env, starts, frame_len, rasters, shape, num_phases):
        calls.append((list(rasters), shape, num_phases, starts.numel(), env.dtype))
        return real(env, starts, frame_len, rasters, shape, num_phases)

    monkeypatch.setattr(psharded, "frames_to_screens_candidates", counted)
    cands = tp.candidate_modes(60.0, tol_hz=0.5)
    psharded.mode_search_static(capture.iq, FS, 60.0, cands, device="cpu")
    assert calls == [([(m.height, m.width) for _, m in cands], (150, 200), 16, 2,
                      torch.float32)]


def test_a_score_grid_of_few_rows_halves_the_tile_rows():
    """A screen of far fewer rows than the raster has lines spreads a tile's
    rows over a long run of the block.  At 1080p60 and 20 Msps the default
    150-row score grid still fits eight rows of float32 samples (16,008
    staged); a 75-row grid halves them to four and a 30-row grid to two.
    8-byte float32 pairs start from four rows and come down to two at both."""
    big = tp.ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    raster = (int(20e6 / 60.0), big.height, big.width)
    full = resample_kernel.ROWS_PER_TILE
    assert resample_kernel.tile_plan(*raster, (600, 800), 4)[0] == full[4] == 8
    assert resample_kernel.tile_plan(*raster, (150, 200), 4) == (8, 16008)
    for shape, rows_env, rows_pairs in (((75, 100), 4, 2), ((30, 40), 2, 2)):
        for sample_bytes, rows in ((4, rows_env), (8, rows_pairs)):
            got, cap = resample_kernel.tile_plan(*raster, shape, sample_bytes)
            assert got == rows < full[sample_bytes]
            per_sample = 2 * sample_bytes + (4 if sample_bytes == 8 else 0)
            assert cap * per_sample <= resample_kernel.MAX_SHARED_BYTES
            # Twice the rows would not have fitted: the halving was needed.
            assert (resample_kernel.tile_run_cap(*raster, shape, 2 * got) * per_sample
                    > resample_kernel.MAX_SHARED_BYTES)


def test_refine_with_search_matches_jax(capture):
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    n = int(FS * 0.12)
    jt, jrec = joff.auto_reconstruct(capture.iq[:n], FS, refine_with_search=True,
                                     search_tol_hz=0.5, restore=False)
    pt, prec = tp.auto_reconstruct(capture.iq[:n], FS, refine_with_search=True,
                                   search_tol_hz=0.5, restore=False, device="cpu")
    assert pt.mode_name == jt.mode_name == MODE_NAME
    assert (pt.mode.width, pt.mode.height) == (jt.mode.width, jt.mode.height)
    # The refresh is the same point of the 1/8-sample lag grid in both
    # packages (tests/test_torch_timing.py): 1e-4 Hz.
    assert abs(pt.refresh_hz - jt.refresh_hz) < 1e-4
    assert prec.frames.shape == jrec.frames.shape


def test_refine_with_search_corrects_a_wrong_lock(capture, monkeypatch):
    """The safety net: when stage 1 snaps to the wrong mode of the right
    refresh, the search over the modes near that refresh names the right one."""
    from tempest_tpu_torch.pipeline import offline as poff

    wrong_name = "1920x1080 @ 60Hz"
    wrong = tp.ALL_VIDEO_MODES[wrong_name]
    real = poff.estimate_timing

    def wrong_lock(*args, **kwargs):
        t = real(*args, **kwargs)
        return poff.TimingEstimate(t.refresh_hz, float(wrong.height), wrong_name,
                                   tp.VideoMode(wrong.width, wrong.height, t.refresh_hz), t.snr_db)

    monkeypatch.setattr(poff, "estimate_timing", wrong_lock)
    plain, _ = tp.auto_reconstruct(capture.iq, FS, n_frames=2, device="cpu")
    assert plain.mode_name == wrong_name
    refined, rec = tp.auto_reconstruct(capture.iq, FS, n_frames=2, refine_with_search=True,
                                       search_tol_hz=0.5, device="cpu")
    assert refined.mode_name == MODE_NAME
    assert (refined.mode.width, refined.mode.height) == (MODE.width, MODE.height)
    assert refined.refresh_hz == plain.refresh_hz and refined.line_count == plain.line_count
    assert rec.image.shape == (600, 800)
    words = np.ascontiguousarray(capture.iq).view(np.float32)
    from_words, _ = tp.auto_reconstruct(words, FS, n_frames=2, refine_with_search=True,
                                        search_tol_hz=0.5, device="cpu")
    assert from_words.mode_name == MODE_NAME


@pytest.mark.cuda
def test_search_on_the_card_launches_k1_once_per_candidate(cuda_device, capture):
    """Since K1 takes the candidate set in one launch: once a search, and
    not once per candidate."""
    cands = tp.candidate_modes(60.0, tol_hz=0.5)
    with count_launches() as seen:
        got = psharded.mode_search_static(capture.iq, FS, 60.0, cands, device=cuda_device)
    assert seen["k1"] == 1 == seen["k1", 2, False, "candidates"]
    ref = psharded.mode_search_static(capture.iq, FS, 60.0, cands, device="cpu")
    assert got.best_index == ref.best_index
    np.testing.assert_allclose(got.scores, ref.scores, rtol=SCORE_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(75, 100), (30, 40)])
def test_k1_on_halved_tiles_equals_its_plain_version(cuda_device, shape):
    """Score grids so coarse that the plan halves a tile's rows (to four and
    to two at 1080p60, 20 Msps): the kernel does the plain version's float32
    operations in the same order, so the screens are equal to the bit."""
    big = tp.ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    spf = 20e6 / 60.0
    raster = (int(spf), big.height, big.width, shape)
    assert resample_kernel.tile_plan(*raster, 4)[0] < resample_kernel.ROWS_PER_TILE[4]
    rng = np.random.default_rng(17)
    env = torch.from_numpy(rng.random(int(2 * spf) + 1, dtype=np.float32)).to(cuda_device)
    starts = torch.from_numpy(np.round(np.arange(2) * spf).astype(np.int32)).to(cuda_device)
    got = resample_kernel.frames_to_screens(env, starts, *raster, None, 2, 16)
    geom = resample_kernel.screen_geometry(*raster, env.device, 16)
    ref = resample_kernel.frames_to_screens_plain(env, starts, geom, None, 2)
    assert torch.equal(got, ref)
