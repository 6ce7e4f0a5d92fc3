"""Time shards and stream shards of ``parallel.sharded`` on a mesh of CPU
shards (``make_mesh(devices=["cpu"] * n)``): against the JAX package's
functions on its 8-device CPU mesh, and against the port's own
single-device steps span by span.

Shapes: 640x480 @ 60 Hz at 4 Msps onto 150x200 screens.

Tolerances, and why:

* port mesh against JAX mesh: both with ``resampler="gather"`` (the JAX
  package's Pallas kernel does not run inside its ``shard_map`` on the CPU,
  and K1's read is held against it in ``tests/test_torch_exact_cuts.py``)
  and integer sync, as the JAX test of this function runs it: 1e-5 of the
  largest value, the tolerance of the single-device "integer" case in
  ``tests/test_torch_pipeline.py`` (measured 2.3e-7), syncs equal, sync
  scores to 1e-4 relative as there (window sums reassociate; 1.1e-5
  measured);
* mesh against single-device step, K1 on both: the same float32 operations
  on the same windows (the EMA combine's ``A·e + B`` is ``ema_fold``'s
  ``α^F·e + Σ``), so equal to the bit;
* the stream-sharded batched step against the unsharded one: frames and EMA
  to the bit (K3's fold takes each stream on its own, in frame order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.parallel import sharded as psharded
from tempest_tpu_torch.parallel.mesh import make_mesh
from tempest_tpu_torch.pipeline import offline as poff

MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 4e6
SPF = FS / MODE.refresh
SHAPE = (150, 200)
ALPHA = 0.5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capture():
    return tp.generate_iq(MODE, FS, int(FS * 0.8), snr_db=20.0, seed=3)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


# -------------------------------------------------------- the offline step
def test_sharded_reconstruct_matches_jax(capture):
    """``tests/test_pipeline.py::test_sharded_reconstruct_matches_single_chip``
    through both packages: 8 shards of 5 frames, circular halo, float64
    frame starts on the global grid, the associative EMA combine."""
    jsharded = pytest.importorskip("tempest_tpu.parallel.sharded")
    jmesh = pytest.importorskip("tempest_tpu.parallel.mesh")
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    import jax.numpy as jnp

    F = 5
    S = int(np.ceil(SPF * F)) + 1
    common = dict(sample_rate=FS, mode=MODE, n_frames=F, render_size=SHAPE, resampler="gather")
    iq = capture.iq[: 8 * S].reshape(8, S)
    jstep = jsharded.sharded_reconstruct_fn(joff.ReconstructionConfig(**common), jmesh.make_mesh(8))
    ej, fj, sj, cj = jstep(jnp.asarray(iq), jnp.zeros(SHAPE, jnp.float32), jnp.float32(ALPHA))
    step = psharded.sharded_reconstruct_fn(tp.ReconstructionConfig(**common), _cpu_mesh(8))
    assert step.n_shards == 8 and step.shard_samples_min == jstep.shard_samples_min
    ema, frames, sync, score = step(iq, np.zeros(SHAPE, np.float32), ALPHA)
    assert frames.shape == (8 * F, *SHAPE) and sync.shape == (8 * F, 2)
    assert _rel(frames, fj) < 1e-5 and _rel(ema, ej) < 1e-5
    np.testing.assert_array_equal(sync.numpy(), np.asarray(sj))
    np.testing.assert_allclose(score.numpy(), np.asarray(cj), rtol=1e-4)
    # The associative combine is the sequential fold over the same frames.
    e = np.zeros(SHAPE, np.float64)
    for f in frames.numpy():
        e = ALPHA * e + (1 - ALPHA) * f
    assert _rel(ema, e) < 1e-5


def test_sharded_reconstruct_equals_the_single_device_step_span_by_span(capture):
    """K1 and sub-pixel sync on 4 shards whose spans are shorter than a
    carry-phase window (the halo is read): each shard's frames are the
    single-device carry-phase step's on its window, to the bit; the last
    shard's halo wraps to the stream's head."""
    F = 3
    S = int(np.ceil(SPF * F)) + 1
    cfg = tp.ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=F, render_size=SHAPE,
                                  align_subpixel=True)
    step = psharded.sharded_reconstruct_fn(cfg, _cpu_mesh(4))
    words = capture.iq[: 4 * S].view(np.float32).reshape(4, 2 * S)
    ema, frames, sync, _ = step(words, np.zeros(SHAPE, np.float32), ALPHA)
    carry = dataclasses.replace(cfg, carry_phase=True, input_format="iq_interleaved")
    single = poff.make_reconstruct_fn(carry, device="cpu")
    need = carry.block_samples
    assert need > S                               # the window reaches into the halo
    ema1 = torch.zeros(SHAPE)
    for d in range(4):
        phase = (-(d * S)) % SPF
        # The mesh rounds its starts in float64, the single step in float32:
        # at these positions both give the same starts.
        np.testing.assert_array_equal(
            np.floor(phase + SPF * np.arange(F) + 0.5).astype(np.int32),
            poff.carry_phase_starts(phase, SPF, F))
        window = np.concatenate([capture.iq[d * S: (d + 1) * S],
                                 capture.iq[((d + 1) % 4) * S:][: need - S]])
        ema1, f1, s1, _ = single(window.view(np.float32), ema1, ALPHA, phase)
        assert torch.equal(frames[d * F:(d + 1) * F], f1)
        assert torch.equal(sync[d * F:(d + 1) * F], s1)
    assert torch.equal(ema, ema1)


def test_ema_combine_is_ema_fold_to_the_bit():
    """``A·e + B`` with ``A`` the float32 tensor power ``ema_fold`` takes and
    ``B`` its fold from zero: the same arithmetic as folding the spans one
    after the other."""
    rng = np.random.default_rng(2)
    spans = [torch.from_numpy(rng.standard_normal((36, 8, 9)).astype(np.float32))
             for _ in range(4)]
    ema = torch.from_numpy(rng.standard_normal((8, 9)).astype(np.float32))
    mesh = _cpu_mesh(4)
    for alpha in (0.1, 0.7, 0.93):
        b = [poff.ema_fold(torch.zeros(8, 9), f, alpha) for f in spans]
        got = psharded._ema_combine(mesh, "blocks", b, ema, alpha, 36)
        want = ema
        for f in spans:
            want = poff.ema_fold(want, f, alpha)
        assert torch.equal(got, want)


# ---------------------------------------------------------- the live step
@pytest.mark.parametrize("fidelity", [False, True], ids=["default", "fidelity"])
@pytest.mark.parametrize("n_frames", [None, 5], ids=["frames_per_window", "halo"])
def test_streaming_step_equals_the_single_device_step(capture, fidelity, n_frames):
    """The live step on 4 spans of 0.1 s from a position off the grid, with
    the runtime's chains: rounded cuts and sub-pixel sync, or exact cuts
    with the residuals in K1.  With 5 frames a span the window passes the
    span's end, so the halo (and for the last shard the tail) is read."""
    S = int(FS * 0.1)
    frames_per_span = n_frames or tp.runtime.stream.frames_per_window(S, SPF)
    cfg = tp.ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=frames_per_span,
                                  render_size=SHAPE, carry_phase=True,
                                  input_format="iq_interleaved", subsample_align=fidelity,
                                  do_align=not fidelity, align_subpixel=not fidelity)
    step = psharded.sharded_streaming_reconstruct_fn(cfg, _cpu_mesh(4), S)
    need = cfg.block_samples
    assert step.overlap == max(need - S, 1) and (need > S) == (n_frames == 5)
    base = 12_345
    iq = capture.iq[base: base + 4 * S + step.overlap]
    phases = [(-(base + d * S)) % SPF for d in range(4)]
    ema, frames, sync, score = step(
        iq[: 4 * S].view(np.float32).reshape(4, 2 * S),
        np.ascontiguousarray(iq[4 * S:]).view(np.float32), np.zeros(SHAPE, np.float32),
        ALPHA, phases)
    single = poff.make_reconstruct_fn(cfg, device="cpu")
    ema1 = torch.zeros(SHAPE)
    F = cfg.n_frames
    for d in range(4):
        window = np.ascontiguousarray(iq[d * S: d * S + need]).view(np.float32)
        ema1, f1, s1, c1 = single(window, ema1, ALPHA, phases[d])
        assert torch.equal(frames[d * F:(d + 1) * F], f1)
        assert torch.equal(sync[d * F:(d + 1) * F], s1)
        assert torch.equal(score[d * F:(d + 1) * F], c1)
    assert torch.equal(ema, ema1)


def test_streaming_step_matches_jax(capture):
    """The live step against the JAX package's on 8 shards of 0.05 s from a
    position off the grid (both on the ``gather`` read, integer sync; the
    last shard's halo is the next block's head in both)."""
    jsharded = pytest.importorskip("tempest_tpu.parallel.sharded")
    jmesh = pytest.importorskip("tempest_tpu.parallel.mesh")
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    import jax.numpy as jnp

    S = int(FS * 0.05)
    common = dict(sample_rate=FS, mode=MODE, n_frames=1, render_size=SHAPE, carry_phase=True,
                  input_format="iq_interleaved", resampler="gather")
    base = 7_777
    iq = capture.iq[base: base + 8 * S + 1]
    rows = iq[: 8 * S].view(np.float32).reshape(8, 2 * S)
    tail = np.ascontiguousarray(iq[8 * S:]).view(np.float32)
    phases = np.array([(-(base + d * S)) % SPF for d in range(8)])
    jstep = jsharded.sharded_streaming_reconstruct_fn(joff.ReconstructionConfig(**common),
                                                      jmesh.make_mesh(8), S)
    ej, fj, sj, _ = jstep(rows, tail, jnp.zeros(SHAPE, jnp.float32), jnp.float32(ALPHA), phases)
    step = psharded.sharded_streaming_reconstruct_fn(tp.ReconstructionConfig(**common),
                                                     _cpu_mesh(8), S)
    assert (step.n_shards, step.n_frames, step.overlap, step.shard_samples) == (
        jstep.n_shards, jstep.n_frames, jstep.overlap, jstep.shard_samples)
    ema, frames, sync, _ = step(rows, tail, np.zeros(SHAPE, np.float32), ALPHA, phases)
    assert _rel(frames, fj) < 1e-5 and _rel(ema, ej) < 1e-5
    np.testing.assert_array_equal(sync.numpy(), np.asarray(sj))


def test_streaming_step_takes_an_envelope():
    """``input_format="envelope"`` (the mesh combine front's output): rows of
    one value a sample, on the device, equal to the single-device step."""
    S = int(FS * 0.1)
    cfg = tp.ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=4, render_size=SHAPE,
                                  carry_phase=True, input_format="envelope")
    env = torch.from_numpy(np.abs(tp.generate_iq(MODE, FS, 2 * S + 1, seed=8).iq))
    step = psharded.sharded_streaming_reconstruct_fn(cfg, _cpu_mesh(2), S)
    ema, frames, _, _ = step(env[: 2 * S].reshape(2, S), env[2 * S:], torch.zeros(SHAPE), ALPHA,
                             [0.0, (-S) % SPF])
    single = poff.make_reconstruct_fn(cfg, device="cpu")
    ema1, f0, _, _ = single(env[: cfg.block_samples], torch.zeros(SHAPE), ALPHA, 0.0)
    ema1, f1, _, _ = single(env[S: S + cfg.block_samples], ema1, ALPHA, (-S) % SPF)
    assert torch.equal(frames, torch.cat([f0, f1])) and torch.equal(ema, ema1)


# --------------------------------------------------------- stream shards
@pytest.mark.parametrize("carry", [False, True], ids=["static", "carry_phase"])
def test_sharded_batched_serving_equals_the_batched_step(carry):
    """``tests/test_pipeline.py:223`` and ``:490``: 8 streams over 4 shards,
    2 a shard, against the unsharded batched step on all 8 (which
    ``tests/test_torch_batched.py`` holds against the JAX package)."""
    cfg = tp.ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=2, render_size=SHAPE,
                                  input_format="iq_interleaved", carry_phase=carry)
    n = cfg.block_samples
    iq = np.stack([tp.generate_iq(MODE, FS, n, snr_db=25.0, seed=s).iq[:n].view(np.float32)
                   for s in range(8)])
    ema0 = np.zeros((8, *SHAPE), np.float32)
    extra = (np.linspace(0.0, 0.9 * SPF, 8),) if carry else ()
    sharded = psharded.sharded_batched_reconstruct_fn(cfg, _cpu_mesh(4))
    ema_s, frames_s, sync_s, score_s = sharded(iq, ema0, ALPHA, *extra)
    ema_p, frames_p, sync_p, score_p = poff.make_batched_reconstruct_fn(cfg, device="cpu")(
        iq, ema0, ALPHA, *extra)
    assert frames_s.shape == frames_p.shape == (8, 2, *SHAPE)
    assert torch.equal(frames_s, frames_p) and torch.equal(sync_s, sync_p)
    assert torch.equal(ema_s, ema_p)
    with pytest.raises(ValueError, match="6 streams do not split over 4 shards"):
        sharded(iq[:6], ema0[:6], ALPHA, *(e[:6] for e in extra))


def test_sharded_steps_refuse_what_they_cannot_split(capture):
    cfg = tp.ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=3, render_size=SHAPE)
    step = psharded.sharded_reconstruct_fn(cfg, _cpu_mesh(4))
    short = int(np.ceil(SPF * 3)) - 1
    with pytest.raises(ValueError, match="need ≥"):
        step(capture.iq[: 4 * short].reshape(4, short), np.zeros(SHAPE, np.float32), ALPHA)
    with pytest.raises(ValueError, match="3 rows for a mesh of 4"):
        step(capture.iq[: 3 * 300_000].reshape(3, -1), np.zeros(SHAPE, np.float32), ALPHA)
    with pytest.raises(ValueError, match="iq_planar"):
        psharded.sharded_reconstruct_fn(dataclasses.replace(cfg, input_format="iq_planar"),
                                        _cpu_mesh(4))(np.zeros((4, 2, 10)), None, ALPHA)
    with pytest.raises(ValueError, match="carry_phase=True"):
        psharded.sharded_streaming_reconstruct_fn(cfg, _cpu_mesh(4), 400_000)
    live = dataclasses.replace(cfg, carry_phase=True, input_format="iq_interleaved")
    with pytest.raises(ValueError, match="halo .* exceeds the shard"):
        psharded.sharded_streaming_reconstruct_fn(live, _cpu_mesh(4), 100_000)
    with pytest.raises(ValueError, match="'iq_interleaved' or 'envelope'"):
        psharded.sharded_streaming_reconstruct_fn(
            dataclasses.replace(live, input_format="complex64"), _cpu_mesh(4), 400_000)
