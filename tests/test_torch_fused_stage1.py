"""Stage 1 of the chain inside K1's words load: the bfloat16 rounding of the
``mxu3``, ``mxu4`` and ``mxu_batched`` chains and the FM discriminator
(``frames_to_screens_from_words(..., demod=, bf16=)``), and the routes that
hand their words to it.

On the CPU the words entry runs its plain version (``words_envelope_plain``:
``am_envelope_from_iq`` or ``fm_demod_from_iq``, then ``round_to_bfloat16``,
then ``frames_to_screens_plain``), so it must equal that chain to the bit,
and every step that takes it must equal the step that demodulates and rounds
as passes to the bit.  Against the JAX package (its demod, the rounding as
``astype(bfloat16)``, ``frames_to_screens_pallas`` in interpret mode) it is
held sample by sample and pixel by pixel.  The unrounded samples agree to
one float32 ulp; the rounded ones are equal but where JAX's unrounded
sample lies within one float32 ulp of a bfloat16 rounding boundary: the two
packages' ``atan2`` differ in the last bit (1.9e-9 rad measured on these
words), and such a sample may round to the neighbouring value (2 of 100,001
samples of the int16 words under FM).  The screens are held to the
fixed-point bound of the K1 parity test, 1e-5 of the largest output on
smooth I/Q, and a pixel that reads a sample rounded the other way may move
by that sample's difference times its weight, no more.

The ``cuda`` cases run each new instantiation of K1 on the card against its
plain version on the same card, to the bit: the kernel rounds every product
and sum on its own as torch's passes do, calls ``atan2f`` as ``torch.atan2``
does, and rounds with ``__float2bfloat16_rn`` as torch's cast does.

The JAX package is imported inside the tests that use it, so that the
``cuda`` cases load where JAX is not installed."""

import dataclasses

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.bench import bench
from tempest_tpu_torch.ops import resample_kernel as rk
from tempest_tpu_torch.ops.demod import am_envelope_from_iq, fm_demod_from_iq
from tempest_tpu_torch.ops.resample import _screen_geometry, round_to_bfloat16
from tempest_tpu_torch.parallel import sharded
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.runtime.sources import SyntheticSource
from tempest_tpu_torch.runtime.stream import StreamingRuntime
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

MODE = ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 2e6
SHAPE = (48, 64)
FRAME_LEN = int(np.floor(FS / MODE.refresh))
REL = 1e-5
# What the words load makes of the words besides plain AM: (demod, bf16).
LOADS = {"am_bf16": ("am", True), "fm": ("fm", False), "fm_bf16": ("fm", True)}
# The slice's shapes on the card and the screens that take the kernel's other
# work splits (``chip_smoke.OTHER_SHAPES``).
OTHER_SHAPES = ((600, 99), (601, 402), (300, 2048), (48, 99))


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


def _words(n_samples: int, dtype, seed: int, modulation: str = "am") -> np.ndarray:
    """Interleaved I/Q words of a synthetic capture: int16 as an SDR
    delivers them, or the float32 view of the complex samples."""
    cap = tp.generate_iq(MODE, FS, n_samples, snr_db=18.0, seed=seed, modulation=modulation)
    words = cap.iq.view(np.float32)
    if dtype == np.int16:
        words = np.clip(np.round(words * 8192.0), -32768, 32767).astype(np.int16)
    return np.ascontiguousarray(words)


def _edge_starts(n_samples: int) -> np.ndarray:
    """Three frame starts: the first at sample 0 (FM's 0 and the 4 taps'
    clamp), the last so late that its bottom rows read past the block end."""
    start, _, _, _, _ = _screen_geometry(FRAME_LEN, MODE.height, MODE.width, SHAPE)
    last = n_samples - int(np.maximum(start, 0).max()) - 20
    return np.array([0, FRAME_LEN // 3, last], np.int32)


def _envelope(words: torch.Tensor, demod: str, bf16: bool) -> torch.Tensor:
    env = fm_demod_from_iq(words) if demod == "fm" else am_envelope_from_iq(words)
    return round_to_bfloat16(env) if bf16 else env


# ------------------------------------------------------------ the words entry
@pytest.mark.parametrize("variant", ["rounded_cuts", "residuals", "quantised_table"])
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("load", list(LOADS))
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_words_entry_equals_the_plain_chain_to_the_bit(dtype, load, taps, variant):
    demod, bf16 = LOADS[load]
    n = 3 * FRAME_LEN + 1
    words = torch.from_numpy(_words(n, dtype, seed=5, modulation=demod))
    starts = torch.from_numpy(_edge_starts(n))
    fracs = (torch.from_numpy(np.random.default_rng(3).random(3).astype(np.float32))
             if variant == "residuals" else None)
    phases = 16 if variant == "quantised_table" else None
    with count_launches() as seen:
        got = rk.frames_to_screens_from_words(words, starts, FRAME_LEN, MODE.height, MODE.width,
                                              SHAPE, fracs, taps, phases, demod=demod, bf16=bf16)
    # A CPU tensor launches nothing, so nothing is counted.
    assert not seen
    geom = rk.screen_geometry(FRAME_LEN, MODE.height, MODE.width, SHAPE, torch.device("cpu"),
                              phases)
    ref = rk.frames_to_screens_plain(_envelope(words, demod, bf16), starts, geom, fracs, taps)
    assert got.shape == (3, *SHAPE) and torch.equal(got, ref)
    assert torch.equal(rk.words_envelope_plain(words, demod, bf16), _envelope(words, demod, bf16))


@pytest.mark.parametrize("load", list(LOADS))
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_words_entry_matches_jax_demod_rounding_then_pallas(dtype, load):
    """Smooth I/Q (slow sinusoids): a smooth envelope and discriminator, so
    that the Pallas kernel's 16.16 fixed point stays within 1e-5 of the
    largest output; the last frame reads past the block end.  Rounded to
    bfloat16, a pixel may also move by what it reads of the samples that
    round the other way (module docstring)."""
    jdemod = pytest.importorskip("tempest_tpu.ops.demod")
    pallas = pytest.importorskip("tempest_tpu.ops.pallas_resample")
    jnp = pytest.importorskip("jax.numpy")
    demod, bf16 = LOADS[load]
    n = 3 * FRAME_LEN + 1
    t = np.arange(n)
    i = 1.5 + np.sin(2 * np.pi * t / 797.0)
    q = 0.7 + 0.3 * np.cos(2 * np.pi * t / 91.0)
    words = np.stack([i, q], axis=1).reshape(-1).astype(np.float32)
    if dtype == np.int16:
        words = np.round(words * 8192.0).astype(np.int16)
    starts = _edge_starts(n)[1:]
    jfn = jdemod.fm_demod_from_iq if demod == "fm" else jdemod.am_envelope_from_iq
    env = jfn(jnp.asarray(words))
    # The samples: the port's unrounded demod within one float32 ulp of
    # JAX's; rounded, the same values but where JAX's unrounded sample lies
    # within one float32 ulp of a bfloat16 rounding boundary.
    jenv = np.asarray(env)
    tw = torch.from_numpy(words)
    assert np.all(np.abs(rk.words_envelope_plain(tw, demod).numpy() - jenv)
                  <= np.spacing(np.abs(jenv)))
    extra = np.zeros((2, *SHAPE), np.float32)
    if bf16:
        env = env.astype(jnp.bfloat16).astype(jnp.float32)
        jround = np.asarray(env)
        pround = rk.words_envelope_plain(tw, demod, bf16).numpy()
        low = (jenv.view(np.uint32) & 0xFFFF).astype(np.int64)
        at_boundary = np.abs(low - 0x8000) <= 1
        assert np.all((pround == jround) | at_boundary)
        # A pixel that reads a sample rounded the other way moves by that
        # sample's difference times its weight: the difference resampled.
        extra = rk.frames_to_screens_plain(
            torch.from_numpy(np.abs(pround - jround)), torch.from_numpy(starts),
            rk.screen_geometry(FRAME_LEN, MODE.height, MODE.width, SHAPE, torch.device("cpu")),
        ).numpy()
    ref = np.asarray(pallas.frames_to_screens_pallas(
        env, jnp.asarray(starts), FRAME_LEN, MODE.height, MODE.width, SHAPE, interpret=True))
    got = rk.frames_to_screens_from_words(
        tw, torch.from_numpy(starts), FRAME_LEN, MODE.height, MODE.width, SHAPE, demod=demod,
        bf16=bf16).numpy()
    assert got.shape == ref.shape == (2, *SHAPE)
    assert np.all(np.abs(got - ref) <= REL * np.abs(ref).max() + extra)


def test_words_entry_rejects_an_unknown_demod():
    words = torch.zeros(2 * 40000, dtype=torch.int16)
    starts = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="demod"):
        rk.frames_to_screens_from_words(words, starts, FRAME_LEN, MODE.height, MODE.width, SHAPE,
                                        demod="pm")


def test_launch_cost_counts_the_load():
    """The bound's operations: AM four a sample, FM seven (four products,
    two sums, the arc tangent), the rounding one more; instructions by
    ``FM_INSTRUCTIONS`` and ``BF16_INSTRUCTIONS``."""
    raster = (333333, 1125, 2200, (600, 800))
    args = (12_333_335, 4, 36, *raster)
    codes = {load: rk.word_code(torch.int16, *load)[0] for load in
             (("am", False), ("fm", False), ("fm", True), ("am", True))}
    nbytes, am_ops, am_tr = rk.launch_cost(*args, codes["am", False])
    _, fm_ops, fm_tr = rk.launch_cost(*args, codes["fm", False])
    _, bf_ops, _ = rk.launch_cost(*args, codes["fm", True])
    samples = am_tr
    assert samples == fm_tr and 0 < samples <= 12_333_335
    assert fm_ops - am_ops == 3 * samples and bf_ops - fm_ops == samples
    assert rk.launch_cost(*args, codes["am", True])[0] == nbytes
    # A bool reads as the envelope or the plain AM load.
    assert rk.launch_cost(*args, True) == rk.launch_cost(*args, codes["am", False])
    am_i = rk.launch_instructions(*args, codes["am", False])
    fm_i = rk.launch_instructions(*args, codes["fm", True])
    assert fm_i - am_i == pytest.approx(
        samples * (rk.FM_INSTRUCTIONS[4] + rk.BF16_INSTRUCTIONS - rk.DEMOD_INSTRUCTIONS[4]))


# ------------------------------------------------------------ the routes
def _config(**kw):
    common = dict(sample_rate=FS, mode=MODE, n_frames=3, render_size=SHAPE,
                  input_format="iq_interleaved", align_subpixel=True)
    common.update(kw)
    return poff.ReconstructionConfig(**common)


def _spy(monkeypatch):
    """Record the keyword options of each call of the step's two K1 entries."""
    calls = {"words": [], "envelope": []}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name].append(kwargs)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(poff, "frames_to_screens_from_words",
                        count("words", poff.frames_to_screens_from_words))
    monkeypatch.setattr(poff, "frames_to_screens", count("envelope", poff.frames_to_screens))
    return calls


# name -> (config options, the words entry's options, word type)
FUSED = {
    "mxu3": (dict(resampler="mxu3", num_phases=16), {"num_phases": 16, "bf16": True}, np.int16),
    "mxu4": (dict(resampler="mxu4", interp_taps=4), {"num_phases": 64, "bf16": True}, np.float32),
    "mxu_batched": (dict(resampler="mxu_batched"), {"num_phases": 64, "bf16": True}, np.int16),
    "mxu3_exact_cuts": (dict(resampler="mxu3", carry_phase=True, subsample_align=True),
                        {"bf16": True}, np.int16),
    "fm": (dict(demod="fm"), {"demod": "fm"}, np.int16),
    "fm_4_taps_exact_cuts": (dict(demod="fm", interp_taps=4, carry_phase=True,
                                  subsample_align=True), {"demod": "fm"}, np.float32),
    "fm_mxu3": (dict(demod="fm", resampler="mxu3"),
                {"num_phases": 64, "demod": "fm", "bf16": True}, np.float32),
}


@pytest.mark.parametrize("case", list(FUSED))
def test_step_hands_stage1_to_the_words_entry_and_equals_the_passes(monkeypatch, case):
    """The single step takes K1's words entry with the rounding and the
    demod as its options, once a block and never the envelope entry; its
    outputs are those of the demod and rounding as passes, to the bit."""
    options, want, dtype = FUSED[case]
    cfg = _config(**options)
    words = _words(cfg.block_samples, dtype, seed=7, modulation=cfg.demod)
    assert poff.fuses_demod(cfg, torch.from_numpy(words))
    calls = _spy(monkeypatch)
    phase = (1234.5,) if cfg.carry_phase else ()
    ema0 = np.zeros(SHAPE, np.float32)
    got = poff.make_reconstruct_fn(cfg, device="cpu")(words, ema0, 0.5, *phase)
    assert calls == {"words": [want], "envelope": []}
    env = poff.demodulate(torch.from_numpy(words), cfg)
    ref = poff.make_reconstruct_fn(dataclasses.replace(cfg, input_format="envelope"),
                                   device="cpu")(env, ema0, 0.5, *phase)
    assert len(calls["envelope"]) == 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["fm_batched", "invert_mxu3"])
def test_invert_and_batched_fm_take_the_words_entry(monkeypatch, case):
    """The two routes that demodulated as a pass until K1 took the block
    maximum and each stream's own clamp: FM in the batched step (each
    stream's output equals its single-stream step's, to the bit) and
    ``invert`` (the step equals the inverted envelope's through K1, to the
    bit).  One call of the words entry, with the stream count or the
    inversion among its options, and none of the envelope entry."""
    calls = _spy(monkeypatch)
    if case == "fm_batched":
        cfg = _config(demod="fm", resampler="mxu3")
        words = np.stack([_words(cfg.block_samples, np.int16, seed=s, modulation="fm")
                          for s in (1, 2)])
        assert poff.fuses_demod(cfg, torch.from_numpy(words))
        ema0 = np.zeros((2, *SHAPE), np.float32)
        out = poff.make_batched_reconstruct_fn(cfg, device="cpu")(words, ema0, 0.5)
        assert calls == {"words": [{"num_phases": 64, "demod": "fm", "bf16": True,
                                    "streams": 2}], "envelope": []}
        single = poff.make_reconstruct_fn(cfg, device="cpu")
        for b in range(2):
            ema_s, frames, sync, score = single(words[b], ema0[b], 0.5)
            assert torch.equal(out[1][b], frames) and torch.equal(out[0][b], ema_s)
            assert torch.equal(out[2][b], sync) and torch.equal(out[3][b], score)
        return
    cfg = _config(invert=True, resampler="mxu3")
    iq = _words(cfg.block_samples, np.int16, seed=3)
    assert poff.fuses_demod(cfg, torch.from_numpy(iq))
    ema0 = np.zeros(SHAPE, np.float32)
    got = poff.make_reconstruct_fn(cfg, device="cpu")(iq, ema0, 0.5)
    assert calls == {"words": [{"num_phases": 64, "bf16": True, "invert": True}], "envelope": []}
    env = poff.demodulate(torch.from_numpy(iq), cfg)
    ref = poff.make_reconstruct_fn(dataclasses.replace(cfg, input_format="envelope", invert=False),
                                   device="cpu")(env, ema0, 0.5)
    assert len(calls["envelope"]) == 1
    assert got[1].shape == (3, *SHAPE) and bool(torch.isfinite(got[1]).all())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["fm_complex64", "fm_gather"])
def test_excepted_routes_keep_the_demod_as_a_pass(monkeypatch, case):
    """Routes ``fuses_demod`` names: complex input, a plain resampler."""
    calls = _spy(monkeypatch)
    if case == "fm_complex64":
        cfg = _config(demod="fm", input_format="complex64")
        iq = tp.generate_iq(MODE, FS, cfg.block_samples, snr_db=18.0, seed=3, modulation="fm").iq
    else:
        cfg = _config(demod="fm", resampler="gather")
        iq = _words(cfg.block_samples, np.int16, seed=3)
        assert not poff.fuses_demod(cfg, torch.from_numpy(iq))
    _, frames, _, _ = poff.make_reconstruct_fn(cfg, device="cpu")(iq, np.zeros(SHAPE, np.float32),
                                                                  0.5)
    assert calls["words"] == [] and len(calls["envelope"]) == (0 if case == "fm_gather" else 1)
    assert frames.shape == (3, *SHAPE) and bool(torch.isfinite(frames).all())


def test_batched_step_rounds_in_the_words_entry(monkeypatch):
    """``mxu_batched`` on B streams of int16 words: one call of the words
    entry with the rounding for all B·F frames, each stream equal to its
    single-stream step to the bit (the rounding is per sample, and each
    stream's reads are clamped into its own block)."""
    calls = _spy(monkeypatch)
    cfg = _config(resampler="mxu_batched", carry_phase=True)
    words = np.stack([_words(cfg.block_samples, np.int16, seed=s) for s in (1, 2, 3)])
    ema0 = np.zeros((3, *SHAPE), np.float32)
    phases = [0.0, 100.25, 20000.75]
    out = poff.make_batched_reconstruct_fn(cfg, device="cpu")(words, ema0, 0.5, phases)
    assert calls == {"words": [{"num_phases": 64, "bf16": True, "streams": 3}], "envelope": []}
    single = poff.make_reconstruct_fn(cfg, device="cpu")
    for b in range(3):
        ema_s, frames, sync, _ = single(words[b], ema0[b], 0.5, phases[b])
        assert torch.equal(out[1][b], frames) and torch.equal(out[0][b], ema_s)
        assert torch.equal(out[2][b], sync)


@pytest.mark.parametrize("case", ["fm", "mxu3"])
def test_shard_window_takes_the_words_entry_and_equals_the_pass(monkeypatch, case):
    """A time shard's window (``parallel/sharded.py`` ``_span_frames``) hands
    its words to K1: under FM the 0 lands on the window's first sample,
    where ``demodulate(ext)`` puts it, so the result equals the pass's."""
    cfg = _config(**({"demod": "fm"} if case == "fm" else {"resampler": "mxu3"}))
    words = _words(cfg.block_samples + 5000, np.int16, seed=9, modulation=cfg.demod)
    ext = torch.from_numpy(words[2 * 777: 2 * (777 + cfg.block_samples)].copy())
    starts = poff.carry_phase_starts(321.5, cfg.samples_per_frame, cfg.n_frames)
    calls = _spy(monkeypatch)
    got = sharded._span_frames(cfg, ext, starts, 0.5)
    assert len(calls["words"]) == 1 and calls["envelope"] == []
    zero = torch.zeros(SHAPE)
    ref = poff._process_and_fold(poff.demodulate(ext, cfg), torch.from_numpy(starts), cfg,
                                 FRAME_LEN, zero, 0.5)
    assert len(calls["envelope"]) == 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_fm_runtime_blocks_go_through_the_words_entry(monkeypatch):
    """The streaming runtime under FM hands each block's words to the words
    entry with ``demod="fm"``: one call a block, none of the envelope
    entry."""
    calls = _spy(monkeypatch)
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=2)
    rt = StreamingRuntime(src, MODE, alpha=0.5, device="cpu",
                          config_overrides={"render_size": SHAPE, "demod": "fm"})
    buf = np.empty(block, np.complex64)
    for _ in range(2):
        src.read(buf)
        rt.ring.put(buf)
    rt.process_blocks(2)
    assert calls == {"words": [{"demod": "fm"}] * 2, "envelope": []}


def test_bench_chain_takes_the_words_entry_and_holds_against_jax_mxu3(monkeypatch):
    """``bench_config`` at a small mode, 300x100 screens (the JAX package's
    ``mxu3`` tables need a tall screen), three blocks of the bench's phase
    loop: every step hands its int16 words to K1 with the rounding, and the
    EMA holds against the JAX package's ``mxu3`` step under the bounds of
    ``tests/test_torch_bench.py`` (its docstring): the residuals' binning
    times the largest step of the rounded envelope, 2⁻⁸ of the largest output
    for the bfloat16 weights, the syncs' difference times the largest pixel
    step."""
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    jnp = pytest.importorskip("jax.numpy")
    shape, fs, n_frames, iters = (300, 100), 4e6, 3, 3
    cfg = bench.bench_config("640x480 @ 60Hz", fs, n_frames, render_size=shape)
    n, spf = cfg.block_samples, cfg.samples_per_frame
    cap = tp.generate_iq(cfg.mode, fs, n, snr_db=18.0, seed=5)
    words = np.clip(np.round(cap.iq.view(np.float32) * 8192), -32768, 32767).astype(np.int16)
    calls = _spy(monkeypatch)
    line, ema = bench.run(cfg, iters, "cpu", words)
    assert line["value"] > 0
    assert calls["envelope"] == [] and calls["words"] and all(
        kw == {"bf16": True} for kw in calls["words"])
    jcfg = joff.ReconstructionConfig(
        sample_rate=fs, mode=cfg.mode, n_frames=n_frames, render_size=shape,
        input_format="iq_interleaved", carry_phase=True, subsample_align=True, do_align=True,
        align_subpixel=True, resampler="mxu3", phase_bins=64, einsum_bf16=True)
    jstep, pstep = joff.make_reconstruct_fn(jcfg), tp.make_reconstruct_fn(cfg, "cpu")
    ej, ep = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    ds, step_max = 0.0, 0.0
    for i in range(iters):
        phase = (-i * n) % spf
        ej, _, sj, _ = jstep(jnp.asarray(words), ej, jnp.float32(bench.ALPHA), phase)
        ep, fp, sp, _ = pstep(words, ep, bench.ALPHA, phase)
        sj, sp = np.asarray(sj), sp.numpy()
        np.testing.assert_array_equal(np.floor(sp), np.floor(sj))
        ds = max(ds, float(np.abs(sp - sj).max()))
        f = fp.numpy()
        step_max = max(step_max, float(np.abs(np.diff(f, axis=1)).max()
                                       + np.abs(np.diff(f, axis=2)).max()))
    assert torch.equal(ema, ep)
    delta = rk.screen_geometry(int(spf), cfg.mode.height, cfg.mode.width, shape,
                               torch.device("cpu")).delta
    assert ds < 1e-3 + 1 / (128 * delta)
    env = round_to_bfloat16(am_envelope_from_iq(torch.from_numpy(words[: 2 * n]))).numpy()
    ej = np.asarray(ej)
    bound = np.abs(np.diff(env)).max() / 128 + 2.0 ** -8 * float(np.abs(ej).max()) + ds * step_max
    assert float(np.abs(ema.numpy() - ej).max()) <= bound * 1.001


# ------------------------------------------------------------- on the card
def _slice_block(device, dtype, demod):
    """36 frames of 1080p60 at 20 Msps: random words over the int16 range
    (as float32 values for float32 words), carried-phase starts, residuals."""
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    spf = 20e6 / mode.refresh
    n = int(np.ceil(36 * spf)) + 1
    rng = np.random.default_rng(1 if demod == "fm" else 0)
    words = rng.integers(-20000, 20000, size=2 * n + 1).astype(np.int16)
    words = torch.from_numpy(words.astype(dtype)).to(device)
    starts, fracs = poff.exact_cut_starts(1000.25, spf, 36)
    return (mode, int(np.floor(spf)), words, torch.from_numpy(starts).to(device),
            torch.from_numpy(fracs).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["rounded", "residuals"])
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("load", list(LOADS))
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_words_load_on_the_card_equals_plain(cuda_device, dtype, load, taps, exact):
    """Each new instantiation of K1 at the slice's shapes (1080p60, 20 Msps,
    36 frames, 600x800), with the first frame at sample 0 and the last cut by
    the block end, from an unaligned source, and at the screens of the other
    work splits: equal to its plain version to the bit, one launch counted
    under its load."""
    demod, bf16 = LOADS[load]
    mode, frame_len, words, starts, fracs = _slice_block(cuda_device, dtype, demod)
    fracs = fracs if exact else None
    raster = (frame_len, mode.height, mode.width, (600, 800))
    geom = rk.screen_geometry(*raster, cuda_device)
    with count_launches() as seen:
        got = rk.frames_to_screens_from_words(words, starts, *raster, fracs, taps, demod=demod,
                                              bf16=bf16)
    assert seen["k1", taps, exact, demod, bf16] == 1 == seen["k1"]
    ref = rk.frames_to_screens_plain(_envelope(words, demod, bf16), starts, geom, fracs, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    n = words.shape[0] // 2
    short = int(starts[-1]) + frame_len - 4000
    edge = torch.tensor([0, frame_len + 3, int(starts[-1])], dtype=torch.int32,
                        device=cuda_device)
    edge_fracs = None if fracs is None else fracs[:3].contiguous()
    for lo in (0, 2):   # words from the block's start, then off 16-byte alignment
        cut = words[lo: 2 * short]
        env = _envelope(cut, demod, bf16)
        for shape in ((600, 800),) + OTHER_SHAPES:
            other = (frame_len, mode.height, mode.width, shape)
            got = rk.frames_to_screens_from_words(cut, edge, *other, edge_fracs, taps,
                                                  demod=demod, bf16=bf16)
            ref = rk.frames_to_screens_plain(env, edge, rk.screen_geometry(*other, cuda_device),
                                             edge_fracs, taps)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (lo, shape)
    assert n > short


@pytest.mark.cuda
@pytest.mark.parametrize("load", ["am_bf16", "fm", "fm_bf16"])
def test_words_load_on_the_card_with_extreme_float_words(cuda_device, load):
    """Float32 words that int16 never gives: magnitudes near the float32
    limit (their squares overflow), subnormals, infinities and NaNs of a
    broken capture.  ``__float2bfloat16_rn`` and torch's cast give the same
    bits on every such value, and the kernel and its plain version agree:
    equal NaN positions, equal bits elsewhere."""
    demod, bf16 = LOADS[load]
    mode, frame_len, words, starts, _ = _slice_block(cuda_device, np.float32, demod)
    rng = np.random.default_rng(4)
    specials = torch.tensor([3.0e38, -3.0e38, 1.0e-40, -1.0e-40, float("inf"), -float("inf"),
                             float("nan"), 0.0, -0.0, 65504.0, 1.0e20, 3.3895314e38],
                            dtype=torch.float32, device=cuda_device)
    idx = torch.from_numpy(rng.integers(0, words.shape[0], 4000)).to(cuda_device)
    words = words.clone()
    words[idx] = specials[torch.arange(4000, device=cuda_device) % specials.numel()]
    raster = (frame_len, mode.height, mode.width, (600, 800))
    geom = rk.screen_geometry(*raster, cuda_device)
    got = rk.frames_to_screens_from_words(words, starts, *raster, None, 2, demod=demod, bf16=bf16)
    ref = rk.frames_to_screens_plain(_envelope(words, demod, bf16), starts, geom, None, 2)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], ref[~nan])
    assert bool(nan.any())
    if demod == "am":
        assert bool(torch.isinf(ref).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mxu3_exact_cuts", "fm", "fm_4_taps_exact_cuts", "fm_mxu3"])
def test_steps_on_the_card_take_the_words_load_and_equal_the_passes(cuda_device, case):
    """On the card, the step that hands its words to K1 against the step
    that demodulates and rounds as passes and hands K1 the envelope: the
    same frames, sync, score and EMA to the bit, one K1 launch a step."""
    options, _, dtype = FUSED[case]
    cfg = _config(**options, sample_rate=20e6, mode=ALL_VIDEO_MODES["1920x1080 @ 60Hz"],
                  n_frames=36, render_size=(600, 800))
    rng = np.random.default_rng(2)
    words = torch.from_numpy(rng.integers(-20000, 20000, 2 * cfg.block_samples)
                             .astype(np.int16).astype(dtype)).to(cuda_device)
    phase = (1234.5,) if cfg.carry_phase else ()
    ema0 = torch.zeros((600, 800), device=cuda_device)
    with count_launches() as seen:
        got = poff.make_reconstruct_fn(cfg, cuda_device)(words, ema0, 0.5, *phase)
    # One K1 launch, of the words entry: its variant goes on with the demod.
    (variant,) = [key for key in seen if key[0] == "k1" and key != "k1"]
    assert seen["k1"] == 1 and variant[3] == cfg.demod
    env = poff.demodulate(words, cfg)
    ref = poff.make_reconstruct_fn(dataclasses.replace(cfg, input_format="envelope"),
                                   cuda_device)(env, ema0, 0.5, *phase)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ---------------------------------------------- the int16 FM load's arc tangent
# int16 values at the ends of their range and on the axes: every I/Q pair of
# two of them gives a quadruple whose discriminator lies on an axis, on a
# diagonal (|y| = |x|), at (0, 0) with either sign of zero, or at the products'
# extremes (2^30 each, 2^31 summed).
EDGE_VALUES = (0, 1, -1, 2, -2, 3, -3, 100, -100, 181, -181, 16384, -16384, 12345, -23456,
               32766, -32767, 32767, -32768)


def _edge_quadruples() -> np.ndarray:
    """Interleaved int16 words: for every two pairs (a, b) of EDGE_VALUES
    pairs, pair a then pair b, so that every such quadruple is one sample."""
    pairs = np.array([(i, q) for i in EDGE_VALUES for q in EDGE_VALUES], np.int16)
    a = np.repeat(pairs, len(pairs), axis=0)
    b = np.tile(pairs, (len(pairs), 1))
    return np.stack([a, b], axis=1).reshape(-1)


def test_fm_int16_words_on_the_cpu_is_the_plain_fm_and_matches_jax():
    """On the CPU the check entry of the int16 FM load runs its plain
    version: ``words_envelope_plain(words, "fm")`` to the bit, and the JAX
    package's discriminator within one float32 ulp (the two ``atan2``
    differ in the last bit), on random words and on every edge quadruple."""
    jdemod = pytest.importorskip("tempest_tpu.ops.demod")
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(11)
    random = rng.integers(-32768, 32768, 2 * 20_001).astype(np.int16)
    for words in (random, _edge_quadruples()):
        tw = torch.from_numpy(words)
        got = rk.fm_int16_words(tw)
        plain = rk.words_envelope_plain(tw, "fm")
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
        ref = np.asarray(jdemod.fm_demod_from_iq(jnp.asarray(words)))
        assert got.shape == ref.shape and float(got[0]) == 0.0
        assert np.all(np.abs(got.numpy() - ref) <= np.spacing(np.abs(ref)))
    with pytest.raises(TypeError):
        rk.fm_int16_words(torch.zeros(8, dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("words", ["random", "edges"])
def test_int16_fm_arc_tangent_on_the_card_equals_torch_on_every_sample(cuda_device, words):
    """The int16 FM load's arc tangent without the division's slow path
    (``atan2_int16``) against ``torch.atan2`` after the same roundings, every
    sample compared bit for bit: 2^26 random quadruples of int16 words, then
    every edge quadruple (each sign of zero at (0, 0) included)."""
    if words == "random":
        rng = np.random.default_rng(12)
        data = rng.integers(-32768, 32768, 2 * ((1 << 26) + 1)).astype(np.int16)
    else:
        data = _edge_quadruples()
    tw = torch.from_numpy(data).to(cuda_device)
    with count_launches() as seen:
        got = rk.fm_int16_words(tw)
    assert seen["fm_check", "int16"] == 1 == seen["fm_check"]
    ref = rk.words_envelope_plain(tw, "fm")
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (data.size // 2,)
    assert int((got.view(torch.int32) != ref.view(torch.int32)).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fm", "fm_bf16"])
@pytest.mark.parametrize("exact", [False, True], ids=["rounded", "residuals"])
@pytest.mark.parametrize("taps", [2, 4])
def test_int16_fm_load_at_640x480_on_the_card_equals_plain(cuda_device, taps, exact, bf16):
    """The int16 FM load at the shapes ``auto_reconstruct(demod="fm")``
    launches at 640x480 @ 60 Hz, 32 Msps (11 frames, 600x800): each warp's
    segment of a run longer than at the slice; with the first frame at
    sample 0 (its first sample 0), the last cut by the block end, from an
    unaligned source and at the screens of the other work splits: equal to
    its plain version to the bit."""
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    spf = 32e6 / mode.refresh
    frame_len = int(np.floor(spf))
    n = int(np.ceil(11 * spf)) + 1
    rng = np.random.default_rng(3)
    words = torch.from_numpy(rng.integers(-32768, 32768, 2 * n + 1).astype(np.int16)).to(
        cuda_device)
    starts, fracs = (torch.from_numpy(a).to(cuda_device)
                     for a in poff.exact_cut_starts(1000.25, spf, 11))
    fracs = fracs if exact else None
    raster = (frame_len, mode.height, mode.width, (600, 800))
    got = rk.frames_to_screens_from_words(words, starts, *raster, fracs, taps, demod="fm",
                                          bf16=bf16)
    ref = rk.frames_to_screens_plain(_envelope(words, "fm", bf16), starts,
                                     rk.screen_geometry(*raster, cuda_device), fracs, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    short = int(starts[-1]) + frame_len - 4000
    edge = torch.tensor([0, frame_len + 3, int(starts[-1])], dtype=torch.int32,
                        device=cuda_device)
    edge_fracs = None if fracs is None else fracs[:3].contiguous()
    for lo in (0, 2):
        cut = words[lo: 2 * short]
        env = _envelope(cut, "fm", bf16)
        for shape in ((600, 800),) + OTHER_SHAPES:
            other = (frame_len, mode.height, mode.width, shape)
            got = rk.frames_to_screens_from_words(cut, edge, *other, edge_fracs, taps,
                                                  demod="fm", bf16=bf16)
            ref = rk.frames_to_screens_plain(env, edge, rk.screen_geometry(*other, cuda_device),
                                             edge_fracs, taps)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (lo, shape)
