"""The port's live mesh runtime (``runtime.mesh_stream.MeshStreamingRuntime``)
on meshes of CPU shards: against the port's single-device runtime fed the
same stream in span-sized blocks, against the JAX package's mesh runtime on
its 8-device CPU mesh, and through the cases of ``tests/test_runtime.py``
(``:724``-``:933``) and ``tests/test_combine.py`` (``:324``, ``:370``).

Shapes: 640x480 @ 60 Hz at 4 Msps, 150x200 screens; live combining at
8 Msps, two carriers, 2 MHz channels, blocks of 2²¹ samples.

Tolerances, and why:

* against the single-device runtime: K1 on both, the same windows and the
  same float32 operations (the EMA combine is ``ema_fold``'s arithmetic),
  so EMA, frames and syncs equal to the bit;
* against the JAX mesh runtime: both on the ``gather`` read (the JAX
  package's Pallas kernel does not run inside its ``shard_map``; K1 is held
  against that read in ``tests/test_torch_exact_cuts.py``), integer sync:
  1e-5 of the largest value and equal syncs, the single-device "integer"
  tolerance of ``tests/test_torch_pipeline.py``; the fidelity chain on the
  exact ``gather`` read likewise;
* the port's fidelity mesh (K1, float64 residuals) against the JAX fidelity
  mesh on its quantised phase bins (``mxu3``, 16 bins, a bfloat16
  envelope): the JAX package's own bound between its quantised tables and
  its exact read, mean under 1% and maximum under 8% of the range off the
  edge rows (``tests/test_pipeline.py::test_subsample_align_mxu3_matches_gather_path``);
* live combining against the single-device combining runtime: weights to
  0.03 and PSNR within 1 dB, as in the JAX test — the mesh front quantises
  the refresh to a whole frame period of channel samples, the single-device
  front reads the mode's refresh, so the comb lags differ by under a sample.
"""

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.io.dat import write_complex_binary
from tempest_tpu_torch.parallel.mesh import make_mesh
from tempest_tpu_torch.render.screen import aligned_psnr
from tempest_tpu_torch.runtime.mesh_stream import MeshStreamingRuntime
from tempest_tpu_torch.runtime.sources import SyntheticSource, open_source
from tempest_tpu_torch.runtime.stream import StreamingRuntime

MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 4e6
SHAPE = (150, 200)
OVER = {"render_size": SHAPE}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _stream(n_samples, seed=12):
    return np.asarray(tp.generate_iq(MODE, FS, n_samples, snr_db=20.0, seed=seed).iq,
                      np.complex64)


def _feed(rt, sig, block, count):
    for t in range(count):
        rt.ring.put(np.ascontiguousarray(sig[t * block:(t + 1) * block]))


def _truth():
    return tp.downgrade_image(torch.from_numpy(
        tp.generate_iq(MODE, FS, 1024, snr_db=25.0, seed=3).frame), SHAPE).numpy()


def _collect(rt, n):
    """(image, every frame, every sync) of ``process_blocks(n)``: the sink
    is called once a frame with the info of its dispatch."""
    frames, infos = [], []

    def sink(frame, info):
        frames.append(frame)
        if not infos or infos[-1] is not info:
            infos.append(info)

    img = rt.process_blocks(n, sink=sink, emit_every_frame=True)
    return img, np.stack(frames), np.concatenate([i["sync"] for i in infos])


# --------------------------------------------- the single-device contract
@pytest.mark.parametrize("fidelity", [False, True], ids=["default", "fidelity"])
def test_mesh_runtime_equals_the_single_device_runtime_on_span_blocks(fidelity):
    """``tests/test_runtime.py:724`` and ``:763`` held to the bit: 2
    dispatches of 4 spans of 0.1 s (4 frames a span) against 8 blocks of
    0.1 s through the single-device runtime."""
    n_sh, T, S = 4, 2, int(FS * 0.1)
    sig = _stream((T + 1) * n_sh * S)
    mrt = MeshStreamingRuntime(SyntheticSource(MODE, FS, n_sh * S), MODE, _cpu_mesh(n_sh),
                               alpha=0.5, fidelity=fidelity, config_overrides=OVER)
    srt = StreamingRuntime(SyntheticSource(MODE, FS, S), MODE, alpha=0.5, fidelity=fidelity,
                           config_overrides=OVER, device="cpu")
    assert mrt.config == srt.config and mrt._n_frames == 4
    _feed(mrt, sig, n_sh * S, T + 1)
    _feed(srt, sig, S, T * n_sh)
    img_m, frames_m, sync_m = _collect(mrt, T)
    img_s, frames_s, sync_s = _collect(srt, T * n_sh)
    assert mrt.frames_out == srt.frames_out == T * n_sh * 4
    np.testing.assert_array_equal(img_m, img_s)
    np.testing.assert_array_equal(frames_m, frames_s)
    np.testing.assert_array_equal(sync_m, sync_s)
    assert mrt.abs_pos == srt.abs_pos == T * n_sh * S
    h = mrt.health()["mesh"]
    assert h["n_shards"] == n_sh and h["pending_block"] is True
    assert h["shard_samples"] == S and h["frames_per_shard"] == 4 and h["halo_samples"] == 1
    assert h["devices"] == ["cpu"] * n_sh and h["processes"] is False
    assert img_m.dispatched == h["dispatched"] == h["dispatched_total"] == T


def test_fm_chain_on_the_mesh():
    """``tests/test_runtime.py:832``: the FM discriminator on every shard,
    equal to the single-device FM runtime, and a recognisable screen."""
    S = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, 8 * S, snr_db=25.0, seed=13, modulation="fm")
    sig = np.empty((3, 8 * S), np.complex64)
    for b in sig:
        src.read(b)
    over = {**OVER, "demod": "fm"}
    mrt = MeshStreamingRuntime(SyntheticSource(MODE, FS, 8 * S), MODE, _cpu_mesh(8), alpha=0.5,
                               config_overrides=over)
    srt = StreamingRuntime(SyntheticSource(MODE, FS, S), MODE, alpha=0.5, config_overrides=over,
                           device="cpu")
    assert mrt.config.demod == "fm"
    _feed(mrt, sig.reshape(-1), 8 * S, 3)
    _feed(srt, sig.reshape(-1), S, 16)
    img = mrt.process_blocks(2)
    np.testing.assert_array_equal(img, srt.process_blocks(16))
    p, _ = aligned_psnr(_truth(), img)
    assert p > 7.0, p


# ------------------------------------------------- against the JAX runtime
@pytest.mark.parametrize("chain", ["default", "fidelity", "fidelity_quantised"])
def test_mesh_runtime_matches_the_jax_mesh_runtime(chain, tmp_path):
    """Both mesh runtimes on 8 shards of 0.05 s, two dispatches of one
    stream.  The JAX default-chain checkpoint then resumes in the port's
    mesh runtime."""
    jmesh = pytest.importorskip("tempest_tpu.parallel.mesh")
    jrun = pytest.importorskip("tempest_tpu.runtime.mesh_stream")
    jsrc = pytest.importorskip("tempest_tpu.runtime.sources")
    n_sh, T, S = 8, 2, int(FS * 0.05)
    sig = _stream((T + 1) * n_sh * S)
    fidelity = chain != "default"
    over = {"default": {**OVER, "resampler": "gather", "align_subpixel": False},
            "fidelity": {**OVER, "resampler": "gather"},
            "fidelity_quantised": OVER}[chain]
    jrt = jrun.MeshStreamingRuntime(jsrc.SyntheticSource(MODE, FS, n_sh * S), MODE,
                                    jmesh.make_mesh(n_sh), alpha=0.5, fidelity=fidelity,
                                    fidelity_bins=16, config_overrides=over)
    prt = MeshStreamingRuntime(SyntheticSource(MODE, FS, n_sh * S), MODE, _cpu_mesh(n_sh),
                               alpha=0.5, fidelity=fidelity, fidelity_bins=16,
                               config_overrides=over)
    syncs = {"j": [], "p": []}
    for rt, key in ((jrt, "j"), (prt, "p")):
        _feed(rt, sig, n_sh * S, T + 1)
        rt.process_blocks(T, sink=lambda img, info, key=key: syncs[key].append(info["sync"]))
    ema_j, ema_p = np.asarray(jrt._ema), prt.ema.numpy()
    assert prt.frames_out == jrt.frames_out and prt.abs_pos == jrt._abs_pos
    np.testing.assert_array_equal(np.concatenate(syncs["p"]), np.concatenate(syncs["j"]))
    if chain == "fidelity_quantised":
        d = np.abs(ema_p - ema_j)[2:-2] / np.ptp(ema_j)
        assert d.mean() < 0.01 and d.max() < 0.08, (d.mean(), d.max())
        return
    assert np.abs(ema_p - ema_j).max() / np.abs(ema_j).max() < 1e-5
    if chain == "default":
        path = str(tmp_path / "jax_mesh.npz")
        jrt.save_checkpoint(path)
        rt2 = MeshStreamingRuntime(SyntheticSource(MODE, FS, n_sh * S), MODE, _cpu_mesh(n_sh),
                                   alpha=0.1, config_overrides=over)
        rt2.load_checkpoint(path)
        assert rt2.alpha == 0.5 and rt2.abs_pos == jrt._abs_pos == T * n_sh * S
        assert rt2.frames_out == jrt.frames_out
        np.testing.assert_array_equal(rt2.ema.numpy(), ema_j)


# ------------------------------------------------------ the runtime's cases
def test_phase_survives_ring_drops():
    """``tests/test_runtime.py:861``: blocks overwritten before they are
    taken; the pending block's phase comes from its production sequence, so
    the geometry matches an uninterrupted stream's."""
    S = int(FS * 0.05)
    block = 8 * S
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=22)
    blocks = []
    buf = np.empty(block, np.complex64)
    for _ in range(6):
        src.read(buf)
        blocks.append(buf.copy())

    def run(ring_depth, n_dispatch):
        rt = MeshStreamingRuntime(SyntheticSource(MODE, FS, block), MODE, _cpu_mesh(8),
                                  alpha=0.5, ring_depth=ring_depth, config_overrides=OVER)
        for b in blocks:
            rt.ring.put(b)
        return rt, rt.process_blocks(n_dispatch)

    rt_c, clean = run(8, 5)
    assert rt_c.ring.overflows == 0
    rt_d, dropped = run(3, 2)     # blocks 0-2 overwritten before they are taken
    assert rt_d.ring.overflows == 3 and rt_d.abs_pos == rt_c.abs_pos == 5 * block
    d = np.abs(clean - dropped) / (clean.max() - clean.min() + 1e-9)
    assert d.mean() < 0.02, d.mean()


def test_checkpoint_resume_continues_the_grid(tmp_path):
    """``tests/test_runtime.py:897``: a resumed mesh session rebuilds the
    step and goes on at the saved position (the lookahead does not shift
    it)."""
    S = int(FS * 0.05)
    block = 8 * S
    rt = MeshStreamingRuntime(SyntheticSource(MODE, FS, block, snr_db=25.0, seed=7), MODE,
                              _cpu_mesh(8), alpha=0.5, config_overrides=OVER)
    rt.start()
    try:
        rt.process_blocks(2)
    finally:
        rt.stop()
    path = str(tmp_path / "mesh.npz")
    rt.save_checkpoint(path)
    rt2 = MeshStreamingRuntime(SyntheticSource(MODE, FS, block, snr_db=25.0, seed=7), MODE,
                               _cpu_mesh(8), alpha=0.1, config_overrides=OVER)
    rt2.load_checkpoint(path)
    assert rt2.alpha == 0.5 and rt2.frames_out == rt.frames_out
    np.testing.assert_array_equal(rt2.ema.numpy(), rt.ema.numpy())
    saved = rt2.abs_pos
    rt2.start()
    try:
        rt2.process_blocks(1)
    finally:
        rt2.stop()
    assert rt2.abs_pos == saved + block and rt2.frames_out > rt.frames_out


def test_reconstruction_quality_and_mode_hot_swap():
    """``tests/test_runtime.py:933``: producer thread and ring in the loop,
    a recognisable screen; a mode change rebuilds the mesh step and drops
    the pending block."""
    S = int(FS * 0.05)
    rt = MeshStreamingRuntime(SyntheticSource(MODE, FS, 8 * S, snr_db=25.0, seed=3), MODE,
                              _cpu_mesh(8), alpha=0.5, config_overrides=OVER)
    rt.start()
    try:
        img = rt.process_blocks(3)
    finally:
        rt.stop()
    assert img.dispatched == 3 and rt.frames_out == 3 * 8 * rt._n_frames
    p, _ = aligned_psnr(_truth(), img)
    assert p > 10.0, p
    rt.set_line_count(MODE.height + 1)
    assert rt.mode.height == MODE.height + 1
    assert rt.health()["mesh"]["pending_block"] is False


def test_process_blocks_reports_a_short_run():
    """When the ring closes before ``n_blocks`` were dispatched, the call
    says so: on its image and in ``health()``, not by stopping silently."""
    S = int(FS * 0.05)
    rt = MeshStreamingRuntime(SyntheticSource(MODE, FS, 4 * S), MODE, _cpu_mesh(4), alpha=0.5,
                              config_overrides=OVER)
    _feed(rt, _stream(3 * 4 * S), 4 * S, 3)
    rt.ring.close()
    img = rt.process_blocks(5)
    assert img.dispatched == 2 and img.shape == SHAPE
    h = rt.health()["mesh"]
    assert h["dispatched"] == 2 and h["dispatched_total"] == 2 and h["pending_block"] is True
    assert rt.process_blocks(1).dispatched == 0


def test_mesh_refuses_blocks_it_cannot_split():
    with pytest.raises(ValueError, match="must divide into 3 equal shard spans"):
        MeshStreamingRuntime(SyntheticSource(MODE, FS, 400_001), MODE, _cpu_mesh(3))
    with pytest.raises(ValueError, match="power-of-two block size"):
        MeshStreamingRuntime(SyntheticSource(MODE, FS, 3 << 20), MODE, _cpu_mesh(4),
                             combine=[0.5e6], combine_bw=2e6)


# ------------------------------------------------------- live combining
CARRIERS = [-2.4e6, 1.8e6]
WIDE_FS = 8e6


@pytest.fixture(scope="module")
def wide_capture(tmp_path_factory):
    cap = tp.generate_iq_harmonics(MODE, WIDE_FS, int(WIDE_FS * 1.3), CARRIERS,
                                   amplitudes=[1.0, 0.8], snr_db=8.0, seed=4)
    path = tmp_path_factory.mktemp("wide") / "h.dat"
    write_complex_binary(cap.iq, str(path), "single")
    truth = tp.downgrade_image(torch.from_numpy(cap.frame), SHAPE).numpy()
    return path, truth


def _replay(path, block):
    return open_source("replay", sample_rate=WIDE_FS, block_size=block, path=str(path))


def test_mesh_live_combine_matches_the_single_device_combining_runtime(wide_capture):
    """``tests/test_combine.py:324``: carrier-sharded front, envelope kept on
    the device as the pending payload, time-sharded chain at the channel
    rate — against the single-device combining runtime on the same file."""
    path, truth = wide_capture
    rt = MeshStreamingRuntime(_replay(path, 1 << 21), MODE, _cpu_mesh(4), alpha=0.6,
                              combine=CARRIERS, combine_bw=2e6, config_overrides=OVER)
    assert rt.config.input_format == "envelope"
    assert rt.health()["combine"]["centers_hz"] == CARRIERS
    rt.start()
    try:
        img = rt.process_blocks(3)
    finally:
        rt.stop()
    w_mesh = rt.combine_weights[0].numpy()
    rt1 = StreamingRuntime(_replay(path, int(WIDE_FS * 0.25)), MODE, alpha=0.6,
                           combine=CARRIERS, combine_bw=2e6, config_overrides=OVER, device="cpu")
    rt1.start()
    try:
        img1 = rt1.process_blocks(5)
    finally:
        rt1.stop()
    np.testing.assert_allclose(w_mesh, rt1.combine_weights[0].numpy(), atol=0.03)
    p_mesh, _ = aligned_psnr(truth, img)
    p_single, _ = aligned_psnr(truth, img1)
    assert p_mesh > p_single - 1.0 and p_mesh > 10.0, (p_mesh, p_single)


def test_mesh_live_combine_composes_with_fidelity(wide_capture):
    """``tests/test_combine.py:370``: the fused envelope feeds the exact-cut
    chain at the channel rate, on every shard."""
    path, truth = wide_capture
    rt = MeshStreamingRuntime(_replay(path, 1 << 21), MODE, _cpu_mesh(4), alpha=0.6,
                              fidelity=True, combine=CARRIERS, combine_bw=2e6,
                              config_overrides=OVER)
    assert rt.config.input_format == "envelope" and rt.config.subsample_align
    rt.start()
    try:
        img = rt.process_blocks(3)
    finally:
        rt.stop()
    p, _ = aligned_psnr(truth, img)
    assert p > 10.0, p


def test_combine_weights_are_published_with_the_block_they_fused(wide_capture, monkeypatch):
    """The weights on ``combine_weights`` after a dispatch are those of the
    block whose envelope was dispatched — not the lookahead block's, fused
    one block later (a fault of the JAX mesh runtime)."""
    path, _ = wide_capture
    blocks = np.fromfile(path, np.complex64)[: 3 << 21].reshape(3, 1 << 21)
    rt = MeshStreamingRuntime(_replay(path, 1 << 21), MODE, _cpu_mesh(2), alpha=0.6,
                              combine=CARRIERS, combine_bw=2e6, config_overrides=OVER)
    fused = []
    front = rt._mesh_front

    def recording_front(words):
        out = front(words)
        fused.append(out[1].clone())
        return out

    monkeypatch.setattr(rt, "_mesh_front", recording_front)
    for b in blocks:
        rt.ring.put(b)
    published = []
    rt.process_blocks(2, sink=lambda img, info: published.append(rt.combine_weights[0].clone()))
    assert len(fused) == 3 and len(published) == 2
    assert not torch.equal(fused[0], fused[1])
    for k in range(2):
        assert torch.equal(published[k], fused[k])
