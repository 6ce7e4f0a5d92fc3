"""Parity of the port's streaming chain with the JAX package's, on the CPU.

Small config: 640x480 @ 60 Hz (800x525 total) at 2 Msps onto 48x64
screens, 3 frames per block, except where a test says otherwise.  The JAX
side runs ``resampler="pallas"`` in interpret mode, the kernel K1 ports."""

import dataclasses
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempest_tpu.pipeline.offline as joff
from tempest_tpu.runtime.stream import StreamingRuntime as JaxRuntime
from tempest_tpu.utils.checkpoint import RuntimeState, save_state
from tempest_tpu_torch.io.synthetic import generate_iq, render_frame
from tempest_tpu_torch.ops.resample import downgrade_image
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.render.screen import aligned_psnr
from tempest_tpu_torch.runtime.sources import SyntheticSource
from tempest_tpu_torch.runtime.stream import StreamingRuntime, state_from_jax
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

MODE = ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 2e6
SHAPE = (48, 64)
ALPHA = 0.5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def _configs(**kw):
    common = dict(sample_rate=FS, mode=MODE, n_frames=3, render_size=SHAPE,
                  input_format="iq_interleaved", carry_phase=True)
    common.update(kw)
    return joff.ReconstructionConfig(resampler="pallas", **common), poff.ReconstructionConfig(**common)


# ------------------------------------------------------------ frame starts
def test_carry_phase_starts_match_jax_step(monkeypatch):
    """At the full slice (1080p60, 20 Msps, 36 frames) the starts reach
    11.7 M samples, where float32 spacing is 1.0.  The JAX step's own starts
    are read out of its compiled program by standing in for its frame stage.

    XLA's CPU backend evaluates the expression in whole vectors of 8 or 16
    lanes (frames 0-31) exactly as stated, one rounding per operation, and
    the 4 leftover frames in a scalar loop that fuses ``phase + spf·k`` into
    one multiply-add.  The port reproduces the stated arithmetic, so it must
    equal the JAX step on the vector frames and, on the tail, differ only
    where the JAX step took the fused rounding."""
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    n_frames = 36
    cfg = joff.ReconstructionConfig(
        sample_rate=20e6, mode=mode, n_frames=n_frames, render_size=(8, 8),
        input_format="iq_interleaved", carry_phase=True, resampler="pallas", do_align=False)

    def starts_out(env, frame_starts, config, frame_len, frac_offsets=None):
        n = frame_starts.shape[0]
        return (jnp.zeros((n, *config.render_size), jnp.float32),
                jnp.stack([frame_starts, frame_starts], axis=1), jnp.zeros((n,)))

    monkeypatch.setattr(joff, "process_frames", starts_out)
    step = joff.make_reconstruct_fn(cfg)
    spf = cfg.samples_per_frame
    phases = [0.0, 0.5, spf - 1e-3] + list(np.random.default_rng(0).uniform(0, spf, 29))
    body = n_frames - n_frames % 8
    k = np.arange(n_frames, dtype=np.float64)
    f64_differs = 0
    for phase in phases:
        _, _, sync, _ = step(jnp.zeros(16, jnp.float32), jnp.zeros((8, 8), jnp.float32),
                             jnp.float32(ALPHA), float(phase))
        ref = np.asarray(sync)[:, 0]
        got = poff.carry_phase_starts(float(phase), spf, n_frames)
        np.testing.assert_array_equal(got[:body], ref[:body])
        fused = np.floor((np.float64(np.float32(spf)) * k + np.float64(np.float32(phase)))
                         .astype(np.float32) + np.float32(0.5)).astype(np.int32)
        tail = slice(body, None)
        assert ((got[tail] == ref[tail]) | (fused[tail] == ref[tail])).all(), phase
        f64_differs += int((np.floor(phase + spf * k + 0.5) != got).any())
    # Float64 rounding would have cut differently: the f32 reproduction matters.
    assert f64_differs > 0


# ------------------------------------------------------------- the step
@pytest.fixture(scope="module")
def capture():
    jcfg, _ = _configs()
    n = jcfg.block_samples
    cap = generate_iq(MODE, FS, 3 * n, snr_db=18.0, seed=5)
    return cap, n


ALIGN_CASES = {  # config fields, tolerance
    "no_align": (dict(do_align=False), 1e-5),
    "integer": (dict(do_align=True), 1e-5),
    "subpixel_linear_roll": (dict(align_subpixel=True, align_impl="roll"), 1e-4),
    "subpixel_linear_matmul": (dict(align_subpixel=True, align_impl="matmul"), 1e-4),
    "subpixel_cubic": (dict(align_subpixel=True, align_interp="cubic", align_impl="roll"), 1e-4),
}


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_carry_phase_step_three_blocks_match_jax(capture, case):
    """Three consecutive blocks with the phase carried across them.  Without
    alignment the frames and EMA agree within 1e-5 relative (the fixed-point
    bound of the Pallas kernel); with sub-pixel alignment within 1e-4, since
    the sync fraction moves by ~1e-5 px between the libraries' reductions,
    and the syncs agree to 1e-3 px with equal integer parts."""
    kw, tol = ALIGN_CASES[case]
    jcfg, pcfg = _configs(**kw)
    cap, n = capture
    spf = jcfg.samples_per_frame
    jstep, pstep = joff.make_reconstruct_fn(jcfg), poff.make_reconstruct_fn(pcfg, device="cpu")
    ej = jnp.zeros(SHAPE, jnp.float32)
    ep = torch.zeros(SHAPE)
    for b in range(3):
        words = np.ascontiguousarray(cap.iq[b * n:(b + 1) * n]).view(np.float32)
        phase = (-(b * n)) % spf
        ej, fj, sj, scj = jstep(jnp.asarray(words), ej, jnp.float32(ALPHA), phase)
        ep, fp, sp, scp = pstep(words, ep, ALPHA, phase)
        assert fp.shape == (3, *SHAPE) and sp.shape == (3, 2)
        assert _rel(fp, fj) < tol
        assert _rel(ep, ej) < tol
        sj, sp = np.asarray(sj), sp.numpy()
        assert sp.dtype == sj.dtype
        np.testing.assert_array_equal(np.round(sp), np.round(sj))
        assert np.abs(sp - sj).max() < 1e-3
        if pcfg.do_align:
            np.testing.assert_allclose(scp.numpy(), np.asarray(scj), rtol=1e-4)


def test_reconstruct_frames_complex_input_matches_jax():
    """``reconstruct_frames`` on host complex64 input (viewed as interleaved
    float32 words on the way to the device), 1e-5 relative."""
    common = dict(sample_rate=FS, mode=MODE, n_frames=3, render_size=SHAPE, do_align=False)
    jcfg = joff.ReconstructionConfig(resampler="pallas", **common)
    pcfg = poff.ReconstructionConfig(**common)
    cap = generate_iq(MODE, FS, jcfg.block_samples + 100, snr_db=18.0, seed=8)
    ref = joff.reconstruct_frames(cap.iq, jcfg, alpha=ALPHA)
    got = poff.reconstruct_frames(cap.iq, pcfg, alpha=ALPHA, device="cpu")
    assert got.image.shape == SHAPE and got.frames.shape == (3, *SHAPE)
    assert _rel(got.image, ref.image) < 1e-5
    assert _rel(got.frames, ref.frames) < 1e-5
    # A complex tensor goes through |z| directly.
    step = poff.make_reconstruct_fn(pcfg, device="cpu")
    z = torch.from_numpy(cap.iq[:pcfg.block_samples])
    ema, frames, _, _ = step(z, np.zeros(SHAPE, np.float32), ALPHA)
    assert _rel(ema, ref.image) < 1e-5


@pytest.mark.parametrize("option", [
    dict(resampler="mxu3"), dict(resampler="mxu"), dict(resampler="rows"),
    dict(resampler="aligned"), dict(resampler="fft"),
], ids=lambda o: "-".join(o.values()))
def test_unported_options_raise(option):
    """Nothing of the JAX package is left out of the port any more: the
    resampler names that raised here until the operator surface build and
    run a block, the mesh functions that raised until the multi-device
    slice take a mesh and run (``tests/test_torch_sharded_time.py``), and
    only a name that neither package knows raises."""
    from tempest_tpu_torch.parallel.mesh import make_mesh
    from tempest_tpu_torch.parallel import sharded as psharded

    cfg = poff.ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=3, render_size=SHAPE,
                                    input_format="envelope", **option)
    env = np.random.default_rng(0).random(cfg.block_samples, dtype=np.float32)
    ema, frames, _, _ = poff.make_reconstruct_fn(cfg, device="cpu")(
        env, np.zeros(SHAPE, np.float32), ALPHA)
    assert frames.shape == (3, *SHAPE) and bool(torch.isfinite(ema).all())
    # The same block as two spans of a mesh: each shard's frames from its
    # span and the halo that follows it.
    S = cfg.block_samples // 2
    step = psharded.sharded_reconstruct_fn(dataclasses.replace(cfg, n_frames=1),
                                           make_mesh(devices=["cpu"] * 2))
    ema2, frames2, _, _ = step(env[: 2 * S].reshape(2, S), np.zeros(SHAPE, np.float32), ALPHA)
    assert frames2.shape == (2, *SHAPE) and bool(torch.isfinite(ema2).all())
    with pytest.raises(ValueError, match="unknown resampler"):
        poff.make_reconstruct_fn(dataclasses.replace(cfg, resampler="mxu9"), device="cpu")


@pytest.mark.parametrize("variant", ["plain", "invert", "exact_cuts", "carry_phase"])
def test_envelope_input_format_matches_jax_and_the_complex_route(variant):
    """``input_format="envelope"`` passes a demodulated envelope through
    (only ``invert`` applies): the same EMA as the JAX step on that envelope
    (1e-4 of the peak: K1's float32 positions against the Pallas kernel's
    fixed point; the Pallas kernel takes no residual, so exact cuts are held
    to the complex route alone), and the values of the complex route, whose
    demod is the same ``abs``."""
    cap = generate_iq(MODE, FS, int(FS * 0.12), snr_db=20.0, seed=3)
    env = np.abs(cap.iq).astype(np.float32)
    kw = dict(sample_rate=FS, mode=MODE, n_frames=4, render_size=SHAPE, align_subpixel=True,
              invert=variant == "invert", subsample_align=variant == "exact_cuts",
              carry_phase=variant == "carry_phase")
    cfg_j = joff.ReconstructionConfig(resampler="pallas", input_format="envelope", **kw)
    cfg_e = poff.ReconstructionConfig(input_format="envelope", **kw)
    cfg_c = poff.ReconstructionConfig(input_format="complex64", **kw)
    ema0 = np.zeros(SHAPE, np.float32)
    if variant == "carry_phase":
        n, phase = cfg_e.block_samples, 1234.5
        ref = joff.make_reconstruct_fn(cfg_j)(jnp.asarray(env[:n]), jnp.asarray(ema0),
                                               jnp.float32(ALPHA), phase)
        got = poff.make_reconstruct_fn(cfg_e, device="cpu")(env[:n], ema0, ALPHA, phase)
        via = poff.make_reconstruct_fn(cfg_c, device="cpu")(cap.iq[:n], ema0, ALPHA, phase)
        ref_img, got_img, via_img = np.asarray(ref[0]), got[0].numpy(), via[0].numpy()
    else:
        ref_img = (None if variant == "exact_cuts"
                   else joff.reconstruct_frames(env, cfg_j, alpha=ALPHA).image)
        got_img = poff.reconstruct_frames(env, cfg_e, alpha=ALPHA, device="cpu").image
        via_img = poff.reconstruct_frames(cap.iq, cfg_c, alpha=ALPHA, device="cpu").image
    if ref_img is not None:
        assert _rel(got_img, ref_img) < 1e-4
    np.testing.assert_allclose(got_img, via_img, rtol=2e-4, atol=2e-5)


def test_config_block_geometry_matches_jax():
    for carry in (False, True):
        for n_frames in (1, 3, 36):
            kw = dict(sample_rate=20e6, mode=ALL_VIDEO_MODES["1920x1080 @ 60Hz"],
                      n_frames=n_frames, carry_phase=carry)
            j, p = joff.ReconstructionConfig(**kw), poff.ReconstructionConfig(**kw)
            assert p.block_samples == j.block_samples
            assert p.samples_per_frame == j.samples_per_frame
    assert poff.ReconstructionConfig(**kw).block_samples == 12_333_335


# ------------------------------------------------------------- the runtime
def _runtime_blocks(block, n_blocks, seed):
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=seed)
    out = np.empty((n_blocks, block), np.complex64)
    for b in range(n_blocks):
        src.read(out[b])
    return out


def test_streaming_runtime_end_to_end():
    """The port's runtime on a live SyntheticSource through its producer
    thread: the phase carry keeps the blanking position from jumping."""
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=2)
    rt = StreamingRuntime(src, MODE, alpha=ALPHA, config_overrides={"render_size": SHAPE},
                          device="cpu")
    images, syncs = [], []
    rt.start()
    try:
        rt.process_blocks(3, sink=lambda img, info: (images.append(img.copy()),
                                                     syncs.append(info["sync"])))
    finally:
        rt.stop()
    assert len(images) == 3 and images[-1].shape == SHAPE
    assert rt.frames_out == 3 * rt.config.n_frames
    all_sync = np.concatenate(syncs)
    for axis, n in ((0, SHAPE[0]), (1, SHAPE[1])):
        d = np.abs(np.diff(np.round(all_sync[:, axis]).astype(int)))
        assert np.minimum(d, n - d).max() <= 2, all_sync[:, axis]
    assert images[-1].std() > 0.01


def test_streaming_runtime_matches_jax_runtime():
    """Both runtimes fed the same blocks (no producer thread, so no block is
    dropped): equal frame grid, EMA within 1e-4 relative, syncs to 1e-3 px."""
    block = int(FS * 0.1)
    blocks = _runtime_blocks(block, 3, seed=4)
    over = {"render_size": SHAPE}
    jrt = JaxRuntime(SyntheticSource(MODE, FS, block), MODE, alpha=ALPHA,
                     config_overrides={**over, "resampler": "pallas"})
    prt = StreamingRuntime(SyntheticSource(MODE, FS, block), MODE, alpha=ALPHA,
                           config_overrides=over, device="cpu")
    assert prt.config.n_frames == jrt.config.n_frames
    syncs = {"j": [], "p": []}
    for rt, key in ((jrt, "j"), (prt, "p")):
        for b in blocks:
            rt.ring.put(b)
        rt.process_blocks(3, sink=lambda img, info, key=key: syncs[key].append(info["sync"]))
    ema_j, ema_p = jrt._ema, prt.ema.numpy()
    assert _rel(ema_p, ema_j) < 1e-4
    sj, sp = np.concatenate(syncs["j"]), np.concatenate(syncs["p"])
    assert np.abs(sp - sj).max() < 1e-3
    assert prt.abs_pos == jrt._abs_pos == 3 * block


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint written by the JAX runtime loads in the port, and the
    next block gives the EMA the JAX runtime gives when it continues; a live
    JAX state handed over with ``state_from_jax`` does the same."""
    block = int(FS * 0.1)
    blocks = _runtime_blocks(block, 3, seed=6)
    over = {"render_size": SHAPE}
    jrt = JaxRuntime(SyntheticSource(MODE, FS, block), MODE, alpha=ALPHA,
                     config_overrides={**over, "resampler": "pallas"})
    for b in blocks[:2]:
        jrt.ring.put(b)
    jrt.process_blocks(2)
    path = str(tmp_path / "jax_state.npz")
    jrt.save_checkpoint(path)
    live_ema, live_pos = np.array(jrt._ema), jrt._abs_pos

    prt = StreamingRuntime(SyntheticSource(MODE, FS, block), MODE, alpha=0.1,
                           config_overrides=over, device="cpu")
    prt.load_checkpoint(path)
    assert prt.alpha == ALPHA and prt.abs_pos == 2 * block
    assert prt.frames_out == jrt.frames_out
    np.testing.assert_array_equal(prt.ema.numpy(), live_ema)

    jrt.ring.put(blocks[2])
    jrt.process_blocks(1)
    prt.ring.put(blocks[2])
    prt.process_blocks(1)
    assert prt.abs_pos == jrt._abs_pos == 3 * block
    assert _rel(prt.ema.numpy(), jrt._ema) < 1e-4

    # The same hand-over from a live JAX state, through the port's step.
    ema, pos = state_from_jax(live_ema, live_pos, device="cpu")
    step = poff.make_reconstruct_fn(prt.config, device="cpu")
    words = np.ascontiguousarray(blocks[2][:prt.config.block_samples]).view(np.float32)
    out, *_ = step(words, ema, ALPHA, (-pos) % prt.config.samples_per_frame)
    assert _rel(out.numpy(), jrt._ema) < 1e-4


@pytest.mark.parametrize("extra", [dict(combine_centers=[0.2e6]),
                                   dict(combine_centers=[0.2e6, -0.3e6], fidelity=True)],
                         ids=["combine", "combine_with_fidelity"])
def test_checkpoint_of_unported_chain_raises(tmp_path, extra):
    """Checkpoints with live-combine centres resume since the combine front
    is ported.  What still raises at resume is a chain no runtime can run:
    excision with the FM discriminator."""
    state = RuntimeState(ema=np.zeros((600, 800), np.float32), abs_pos=1000, mode=MODE,
                         sample_rate=FS, alpha=0.2, combine_bw=0.5e6, **extra)
    path = str(tmp_path / "state.npz")
    save_state(state, path)
    block = int(FS * 0.25)
    rt = StreamingRuntime(SyntheticSource(MODE, FS, block), MODE, device="cpu")
    rt.load_checkpoint(path)
    assert rt.config.input_format == "envelope" and rt.abs_pos == 1000
    assert rt.config.subsample_align == bool(extra.get("fidelity"))
    assert rt.health()["combine"]["centers_hz"] == extra["combine_centers"]

    unsound = RuntimeState(ema=state.ema, abs_pos=1000, mode=MODE, sample_rate=FS, alpha=0.2,
                           combine_bw=0.5e6, combine_demod="fm", combine_excise_db=0.0, **extra)
    save_state(unsound, path)
    with pytest.raises(ValueError, match="excise_db with demod='fm'"):
        StreamingRuntime(SyntheticSource(MODE, FS, block), MODE, device="cpu").load_checkpoint(path)


def test_port_chain_psnr_matches_jax_gather_chain():
    """End-to-end fidelity against the capture's ground truth: the port's
    runtime must reach the aligned PSNR of the JAX runtime with the gather
    resampler on the same blocks, less 0.3 dB — the bar ``chip_smoke.py``
    holds the full slice to on the card."""
    block = int(FS * 0.1)
    blocks = _runtime_blocks(block, 3, seed=9)
    truth = downgrade_image(torch.from_numpy(render_frame(MODE)), SHAPE).numpy()
    over = {"render_size": SHAPE}
    jrt = JaxRuntime(SyntheticSource(MODE, FS, block), MODE, alpha=ALPHA,
                     config_overrides={**over, "resampler": "gather"})
    prt = StreamingRuntime(SyntheticSource(MODE, FS, block), MODE, alpha=ALPHA,
                           config_overrides=over, device="cpu")
    for rt in (jrt, prt):
        for b in blocks:
            rt.ring.put(b)
    ref_db, _ = aligned_psnr(truth, jrt.process_blocks(3))
    db, _ = aligned_psnr(truth, prt.process_blocks(3))
    assert db > ref_db - 0.3, (db, ref_db)
