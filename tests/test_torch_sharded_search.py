"""Candidate shards of ``parallel.sharded``: ``sharded_mode_search`` and
``sharded_mode_search_2d`` on meshes of CPU shards against the JAX
package's on its 8-device CPU mesh (``tests/test_pipeline.py:119`` and
``:838``), and on the card against the port's static search.

Shapes: 640x480 @ 60 Hz at 4 Msps, the 26 modes within 0.5 Hz of 60 Hz, 2
frames, 150x200 screens.

Tolerance on the scores: 1e-3 relative, that of the static search's parity
test (``tests/test_torch_search.py``).  Each candidate is one K1 read with
its exact line table where the JAX search computes its positions per pixel
in float32 and clamps at the frame's end (K1 reads on into the next frame
for the bottom row); the contrast score is a ratio of window sums of the
row and column profiles.  Measured: 3.7e-5 (1-D), 2.9e-5 (2-D).  How the
candidates are split over the shards changes no score: the same K1 reads,
one ``frame_sync`` per shard over screens it scores frame by frame.
"""

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.parallel.mesh import make_mesh

MODE_NAME = "640x480 @ 60Hz"
MODE = tp.ALL_VIDEO_MODES[MODE_NAME]
FS = 4e6
SHAPE = (150, 200)
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
    return tp.generate_iq(MODE, FS, int(FS * 0.2), snr_db=20.0, seed=3)


@pytest.fixture(scope="module")
def cands():
    c = tp.candidate_modes(60.0, tol_hz=0.5)
    assert len(c) > 8            # a real fan-out over the shards
    return c


def _check_against(got, ref, cands):
    assert got.names == ref.names == [n for n, _ in cands]
    assert got.best_index == ref.best_index and got.names[got.best_index] == MODE_NAME
    assert got.best_mode == cands[got.best_index][1]
    assert got.scores.shape == (len(cands),)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=SCORE_REL)
    assert list(np.argsort(-got.scores)[:3]) == list(np.argsort(-ref.scores)[:3])


def test_sharded_mode_search_matches_jax(capture, cands):
    jsharded = pytest.importorskip("tempest_tpu.parallel.sharded")
    jmesh = pytest.importorskip("tempest_tpu.parallel.mesh")
    ref = jsharded.sharded_mode_search(capture.iq, FS, 60.0, cands, jmesh.make_mesh(8),
                                       n_frames=2, render_size=SHAPE)
    got = tp.sharded_mode_search(capture.iq, FS, 60.0, cands, make_mesh(devices=["cpu"] * 8),
                                 n_frames=2, render_size=SHAPE)
    _check_against(got, ref, cands)


def test_sharded_mode_search_2d_matches_jax(capture, cands):
    """2 time shards × 4 mode shards: each candidate judged on both spans'
    frames, the scores averaged over the time axis."""
    jax = pytest.importorskip("jax")
    jsharded = pytest.importorskip("tempest_tpu.parallel.sharded")
    from jax.sharding import Mesh

    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("blocks", "modes"))
    ref = jsharded.sharded_mode_search_2d(capture.iq, FS, 60.0, cands, jmesh,
                                          frames_per_shard=2, render_size=SHAPE)
    mesh = make_mesh({"blocks": 2, "modes": 4}, devices=["cpu"] * 8)
    got = tp.sharded_mode_search_2d(capture.iq, FS, 60.0, cands, mesh, frames_per_shard=2,
                                    render_size=SHAPE)
    _check_against(got, ref, cands)


@pytest.mark.parametrize("n_shards", [1, 3], ids=["one_shard", "padded"])
def test_the_split_changes_no_score(capture, cands, n_shards):
    """One shard, and 3 shards over 26 candidates (one repeated as a pad),
    give the 8-shard scores: the split is only where each read runs."""
    base = tp.sharded_mode_search(capture.iq, FS, 60.0, cands, make_mesh(devices=["cpu"] * 8),
                                  render_size=SHAPE)
    got = tp.sharded_mode_search(capture.iq, FS, 60.0, cands,
                                 make_mesh(devices=["cpu"] * n_shards), render_size=SHAPE)
    np.testing.assert_array_equal(got.scores, base.scores)
    env = np.abs(capture.iq).astype(np.float32)
    from_env = tp.sharded_mode_search(env, FS, 60.0, cands, make_mesh(devices=["cpu"] * n_shards),
                                      render_size=SHAPE)
    # |z| of the words against numpy's hypot: an ulp apart on some samples.
    np.testing.assert_allclose(from_env.scores, base.scores, rtol=1e-5)


def test_search_refusals(capture, cands):
    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="empty candidate set"):
        tp.sharded_mode_search(capture.iq, FS, 60.0, [], mesh)
    with pytest.raises(ValueError, match="need .* samples"):
        tp.sharded_mode_search(capture.iq[:100_000], FS, 60.0, cands, mesh)
    grid = make_mesh({"blocks": 2, "modes": 1}, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="for 2 time shards"):
        tp.sharded_mode_search_2d(capture.iq[:200_000], FS, 60.0, cands, grid,
                                  frames_per_shard=2)
    with pytest.raises(ValueError, match="empty candidate set"):
        tp.sharded_mode_search_2d(capture.iq, FS, 60.0, [], grid)


# ----------------------------------------------------------------- the card
@pytest.mark.cuda
def test_sharded_search_on_one_card_equals_the_cpu_mesh(cuda_device, capture, cands):
    """Four shards on one card: one K1 launch a shard over its 7 candidates
    (26 and two pads), the winner and the scores of the CPU mesh (the card's
    FFT-free profile sums reassociate: 1e-4)."""
    with count_launches() as seen:
        got = tp.sharded_mode_search(capture.iq, FS, 60.0, cands,
                                     make_mesh(devices=[cuda_device] * 4), render_size=SHAPE)
    torch.cuda.synchronize()
    assert seen["k1"] == 4 == seen["k1", 2, False, "candidates"]
    ref = tp.sharded_mode_search(capture.iq, FS, 60.0, cands, make_mesh(devices=["cpu"] * 4),
                                 render_size=SHAPE)
    assert got.best_index == ref.best_index
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("fidelity", [False, True], ids=["default", "fidelity"])
def test_mesh_runtime_on_one_card_equals_the_single_device_runtime(cuda_device, fidelity):
    """The mesh runtime on four shards of one card against the single-device
    runtime on the card, span by span: to the bit, K1 launched on every
    shard."""
    from tempest_tpu_torch.runtime.mesh_stream import MeshStreamingRuntime
    from tempest_tpu_torch.runtime.sources import SyntheticSource
    from tempest_tpu_torch.runtime.stream import StreamingRuntime

    S = int(FS * 0.1)
    sig = tp.generate_iq(MODE, FS, 3 * 4 * S, snr_db=20.0, seed=12).iq.astype(np.complex64)
    over = {"render_size": SHAPE}
    mrt = MeshStreamingRuntime(SyntheticSource(MODE, FS, 4 * S), MODE,
                               make_mesh(devices=[cuda_device] * 4), alpha=0.5,
                               fidelity=fidelity, config_overrides=over)
    srt = StreamingRuntime(SyntheticSource(MODE, FS, S), MODE, alpha=0.5, fidelity=fidelity,
                           config_overrides=over, device=cuda_device)
    for t in range(3):
        mrt.ring.put(np.ascontiguousarray(sig[t * 4 * S:(t + 1) * 4 * S]))
    for t in range(8):
        srt.ring.put(np.ascontiguousarray(sig[t * S:(t + 1) * S]))
    with count_launches() as seen:
        img = mrt.process_blocks(2)
    torch.cuda.synchronize()
    # K1's words entry (its variants go on with the demod) on every shard.
    assert sum(n for key, n in seen.items() if key[0] == "k1" and len(key) > 4) == 8
    np.testing.assert_array_equal(img, srt.process_blocks(8))
