"""K1's float32 FM load (``csrc/resample.cu``: ``fm_f32_word``, ``atan2_fast``,
the float32 branch of ``demod_run``) and the block maximum's FM loads.

The load takes ``atan2f``'s own operations without their branches where
every lane of a warp has operands inside the domain where those branches are
not taken (``atan2_in_domain``), and ``atan2f`` where one has not: the same
bits either way.  Float32 words come at three scales: integer valued within
the int16 range (an SDR's or a ``.dat`` replay's int16 captures, as the
runtime uploads them), unit scale (the synthetic generator's, ``|v| <= 4``),
and random exponents over the whole float32 range (subnormals among them),
where products leave the domain now and then.

On the CPU the check entry ``fm_float32_words`` and the words entry run
their plain versions, and the plain float32 FM envelope is held against the
JAX package's ``fm_demod_from_iq`` at the three scales: within one float32
ulp of it, NaN where it is NaN.  At random exponents JAX's CPU runtime
flushes subnormal operands and results to zero (the port keeps them, as
``atan2f`` does on the card), so the samples that have a subnormal input,
product, sum or result are left out of that comparison (about a sixth of
them); every other sample is held.

The ``cuda`` cases hold the kernels against their plain versions on the
card, to the bit: the check entry on every sample at each scale and on
every edge quadruple (both zeros, subnormals, the infinities, NaN,
``FLT_MAX``, products that overflow, the domain's bounds); K1's float32 FM
load at each scale with 2 and 4 taps, with and without residuals, rounded
to bfloat16 and inverted, on 1 and 4 streams; the block maximum's FM loads
at each scale, on 1 and 4 streams."""

import numpy as np
import pytest
import torch

from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.ops import resample_kernel as rk
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

SCALES = ("int16", "unit", "exponents")
TINY = np.finfo(np.float32).tiny
# Values of float32 words whose every quadruple of two pairs is an edge of
# the arc tangent or of its domain (products at 2^±60 and just beyond it).
EDGE_VALUES = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1e-40, TINY, -TINY, 1.0, -1.0, 3.0, 2.0 ** -30,
     -1.5 * 2.0 ** -30, 2.0 ** -30 * (1 - 2.0 ** -24), 2.0 ** 30, -1.5 * 2.0 ** 30,
     2.0 ** 30 * (1 + 2.0 ** -23), 2.0 ** 31, 1e19, -2.0 ** 64, np.finfo(np.float32).max,
     -np.finfo(np.float32).max, np.inf, -np.inf, np.nan], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the float32 FM load has no CPU mode")
    return torch.device("cuda", 0)


def float_words(scale: str, n_pairs: int, seed: int) -> np.ndarray:
    """Interleaved float32 I/Q words, ``n_pairs`` pairs at ``scale``."""
    rng = np.random.default_rng(seed)
    if scale == "int16":
        return rng.integers(-32768, 32768, 2 * n_pairs).astype(np.float32)
    if scale == "unit":
        return rng.uniform(-4.0, 4.0, 2 * n_pairs).astype(np.float32)
    bits = rng.integers(0, 1 << 32, 2 * n_pairs, dtype=np.uint64).astype(np.uint32)
    v = bits.view(np.float32).copy()
    v[~np.isfinite(v)] = 1.0   # random exponents, finite (the edges hold the rest)
    return v


def edge_words() -> np.ndarray:
    """Interleaved float32 words: pair a then pair b for every two pairs of
    ``EDGE_VALUES``, so that every such quadruple is one sample."""
    pairs = np.array([(i, q) for i in EDGE_VALUES for q in EDGE_VALUES], np.float32)
    return np.stack([np.repeat(pairs, len(pairs), axis=0), np.tile(pairs, (len(pairs), 1))],
                    axis=1).reshape(-1)


def same_bits(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """Equal NaN positions, equal bits elsewhere."""
    nan = torch.isnan(ref)
    return (bool(torch.equal(torch.isnan(got), nan))
            and bool(torch.equal(got[~nan].view(torch.int32), ref[~nan].view(torch.int32))))


def _subnormal(a: np.ndarray) -> np.ndarray:
    a = np.abs(a)
    return (a > 0) & (a < TINY)


# ------------------------------------------------------------------- the CPU
@pytest.mark.parametrize("scale", SCALES)
def test_plain_float32_fm_matches_jax(scale):
    """The plain float32 FM envelope (what the load is held to on the card)
    against the JAX package's ``fm_demod_from_iq``: within one float32 ulp,
    NaN where it is NaN; at random exponents the samples with a subnormal
    input, product, sum or result left out (JAX's CPU flushes them)."""
    jdemod = pytest.importorskip("tempest_tpu.ops.demod")
    jnp = pytest.importorskip("jax.numpy")
    words = float_words(scale, 20_001, 21)
    got = rk.words_envelope_plain(torch.from_numpy(words), "fm").numpy()
    ref = np.asarray(jdemod.fm_demod_from_iq(jnp.asarray(words)))
    assert got.shape == ref.shape and float(got[0]) == 0.0
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    keep = ~nan
    if scale == "exponents":
        p = words.reshape(-1, 2)
        re0, im0, re1, im1 = p[:-1, 0], p[:-1, 1], p[1:, 0], p[1:, 1]
        with np.errstate(all="ignore"):
            prods = (im1 * re0, re1 * im0, re1 * re0, im1 * im0)
            parts = prods + (prods[0] - prods[1], prods[2] + prods[3], re0, im0, re1, im1)
        flushed = np.zeros(got.shape, bool)
        for a in parts:
            flushed[1:] |= _subnormal(a)
        flushed |= _subnormal(got)
        assert flushed.mean() < 0.25
        keep &= ~flushed
    assert np.all(np.abs(got[keep] - ref[keep]) <= np.spacing(np.abs(ref[keep])))


def test_fm_float32_words_on_the_cpu_is_the_plain_fm():
    """The check entry runs its plain version on the CPU, to the bit, on
    every edge quadruple; it takes float32 words only."""
    tw = torch.from_numpy(edge_words())
    got = rk.fm_float32_words(tw)
    assert got.shape == (tw.numel() // 2,)
    assert same_bits(got, rk.words_envelope_plain(tw, "fm"))
    with pytest.raises(TypeError):
        rk.fm_float32_words(torch.zeros(8, dtype=torch.int16))


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES + ("edges",))
def test_float32_fm_arc_tangent_on_the_card_equals_torch(cuda_device, scale):
    """The float32 FM load's arc tangent (``fm_f32_word``'s vote between
    ``atan2_fast`` and ``atan2f``) against ``torch.atan2`` after the same
    roundings, every sample bit for bit: 2^22 samples at each scale, and
    every edge quadruple."""
    words = edge_words() if scale == "edges" else float_words(scale, (1 << 22) + 1, 22)
    tw = torch.from_numpy(words).to(cuda_device)
    with count_launches() as seen:
        got = rk.fm_float32_words(tw)
    assert seen == {"fm_check": 1, ("fm_check", "float32"): 1}
    ref = rk.words_envelope_plain(tw, "fm")
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (words.size // 2,)
    assert same_bits(got, ref)


def _small_block(scale: str, n_frames: int, streams: int = 1):
    """Words and frame starts of ``n_frames`` frames of 640x480 @ 60 Hz at
    32 Msps (runs of five scan lines and more, as ``auto_reconstruct``
    launches it there) in ``streams`` equal streams, and the raster."""
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    spf = 32e6 / mode.refresh
    frame_len = int(np.floor(spf))
    per = n_frames // streams
    length = int(np.ceil((per + 1) * spf))
    starts = np.concatenate([poff.carry_phase_starts(0.0, spf, per) + s * length
                             for s in range(streams)]).astype(np.int32)
    words = float_words(scale, streams * length, 23)
    return words, starts, (frame_len, mode.height, mode.width, (600, 800))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fm", "fm_bf16"])
@pytest.mark.parametrize("exact", [False, True], ids=["rounded", "residuals"])
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("scale", SCALES)
def test_float32_fm_load_on_the_card_equals_plain(cuda_device, scale, taps, exact, bf16):
    """K1's float32 FM load, 11 frames of 640x480 at 32 Msps on the balanced
    walk, also with the first frame at sample 0 and the last cut by the block
    end and from an unaligned source: equal to its plain version to the
    bit."""
    words, starts, raster = _small_block(scale, 11)
    tw = torch.from_numpy(words).to(cuda_device)
    ts = torch.from_numpy(starts).to(cuda_device)
    fracs = (torch.from_numpy(np.random.default_rng(4).uniform(0, 1, len(starts))
                              .astype(np.float32)).to(cuda_device) if exact else None)
    geom = rk.screen_geometry(*raster, cuda_device)
    edge = torch.tensor([0, raster[0] + 3, int(starts[-1])], dtype=torch.int32,
                        device=cuda_device)
    cut = 2 * (int(starts[-1]) + raster[0] - 4000)
    for w, st, res in ((tw, ts, fracs), (tw[:cut], edge, None if fracs is None else fracs[:3]),
                       (tw[2:cut], edge, None if fracs is None else fracs[:3])):
        got = rk.frames_to_screens_from_words(w, st, *raster, res, taps, demod="fm", bf16=bf16)
        ref = rk.frames_to_screens_plain(rk.words_envelope_plain(w, "fm", bf16), st, geom, res,
                                         taps)
        torch.cuda.synchronize()
        assert same_bits(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("invert", [False, True], ids=["plain", "inverted"])
@pytest.mark.parametrize("streams", [1, 4])
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("scale", SCALES)
def test_float32_fm_streams_and_inversion_on_the_card_equal_plain(cuda_device, scale, taps,
                                                                   streams, invert):
    """The float32 FM load on 1 and 4 streams laid end to end (each clamped
    into its own samples), with and without the inversion by each stream's
    maximum (``words_maxima``, the block maximum's float32 FM load): equal
    to the plain version to the bit."""
    words, starts, raster = _small_block(scale, 8, streams)
    tw = torch.from_numpy(words).to(cuda_device)
    ts = torch.from_numpy(starts).to(cuda_device)
    got = rk.frames_to_screens_from_words(tw, ts, *raster, None, taps, demod="fm",
                                          invert=invert, streams=streams)
    ref = rk.frames_to_screens_plain(rk.words_envelope_plain(tw, "fm", False, invert, streams),
                                     ts, rk.screen_geometry(*raster, cuda_device), None, taps,
                                     streams)
    torch.cuda.synchronize()
    assert same_bits(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 4])
@pytest.mark.parametrize("scale", SCALES + ("int16 words",))
def test_block_maximum_fm_loads_on_the_card_equal_torch_max(cuda_device, scale, streams):
    """The block maximum's FM loads (float32 pairs through the vote, among
    the lanes that read whole words) against ``torch.max`` of the plain
    envelope to the bit, on a block whose streams end off a 16-byte word and
    from an unaligned source (every word sample by sample)."""
    rng = np.random.default_rng(24)
    n = streams * 1_234_567
    if scale == "int16 words":
        words = rng.integers(-32768, 32768, 2 * n).astype(np.int16)
    else:
        words = float_words(scale, n, 24)
    tw = torch.from_numpy(words).to(cuda_device)
    for w in (tw, tw[2:2 + 2 * (n - streams)]):
        got = rk.words_maxima(w, "fm", streams)
        ref = rk.words_maxima_plain(w, "fm", streams)
        torch.cuda.synchronize()
        assert same_bits(got, ref)
