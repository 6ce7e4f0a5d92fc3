"""K1's 4-tap (Catmull-Rom) read, a kernel of its own since it was redesigned
for the H100 (``csrc/resample.cu`` ``catmull_rom_tiles_kernel``): its tile
plan, the float32 identities its arithmetic rests on, and, on the card,
every variant against the plain version to the bit.

The identities are exact statements about float32 (no tolerance): for
``0 <= pos < 2^23``, ``pos + 2^23`` rounded down is ``floor(pos) + 2^23``;
``2·t²`` and ``4·t²`` are exact, so a fused multiply-add of them rounds as
the plain version's product and difference do.  On the card: ``python -m
pytest --noconftest tests/test_torch_k1_taps4.py -m cuda``."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.ops import resample_kernel as rk
from tempest_tpu_torch.ops.demod import am_envelope_from_iq
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

# (mode, sample rate): the slice's geometry and the one where the taps rule
# of auto_reconstruct picks Catmull-Rom.
GEOMETRIES = {"1080p60_20Msps": ("1920x1080 @ 60Hz", 20e6),
              "640x480_32Msps": ("640x480 @ 60Hz", 32e6)}
SHAPE = (600, 800)


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


def _round_down_f32(x: Fraction) -> np.float32:
    """The float32 next to x toward minus infinity, for 2^23 <= x < 2^24
    (where the float32 step is 1)."""
    return np.float32(int(x // 1))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("sample_bytes", [4, 8])
def test_the_4_tap_plan_fits_a_block(geometry, sample_bytes):
    """The two stage buffers and the float pairs' envelope fit a block (the
    columns' table is added on the card only where the SM holds as many
    blocks with it); the default rows where they do."""
    name, fs = GEOMETRIES[geometry]
    mode = ALL_VIDEO_MODES[name]
    raster = (int(fs / mode.refresh), mode.height, mode.width, SHAPE)
    for exact in (False, True):
        reach = sum(rk.line_reach(4, exact))
        rows, cap = rk.tile_plan(*raster, sample_bytes, reach, 4)
        assert rows == rk.ROWS_PER_TILE[sample_bytes]
        assert cap == rk.tile_run_cap(*raster, rows, reach)
        used = cap * (2 * sample_bytes + (4 if sample_bytes == 8 else 0))
        assert used <= rk.MAX_SHARED_BYTES_4
    # A screen of few rows halves the rows of the 4-tap plan as of the 2-tap.
    few = raster[:3] + ((30, 40),)
    assert rk.tile_plan(*few, sample_bytes, 2, 4)[0] < rk.ROWS_PER_TILE[sample_bytes]


def test_floor_by_a_round_down_add_of_two_to_the_23():
    rng = np.random.default_rng(0)
    pos = np.concatenate([
        np.float32([0.0, 0.5, 1.0, np.nextafter(np.float32(1), np.float32(0)), 2047.999,
                    np.nextafter(np.float32(2 ** 23), np.float32(0))]),
        (rng.random(2000) * 4000).astype(np.float32),
        (rng.random(500) * 2e-6).astype(np.float32)])
    for p in pos:
        x = _round_down_f32(Fraction(float(p)) + 2 ** 23)
        assert int(np.float32(x).view(np.int32)) - 0x4B000000 == int(np.floor(p))
        assert np.float32(x - np.float32(2 ** 23)) == np.floor(p)


def test_the_fused_weights_round_as_the_plain_ones():
    """w0's ``2·t² - t³`` and w2's ``4·t² - 3·t³`` as one rounding of the
    exact value (a fused multiply-add) equal the plain version's rounded
    product, then rounded difference, on fractions across [0, 1) and tiny
    ones."""
    rng = np.random.default_rng(1)
    ts = np.concatenate([rng.random(3000).astype(np.float32),
                         (rng.random(300) * 1e-9).astype(np.float32),
                         np.float32([0.0, 0.5, np.nextafter(np.float32(1), np.float32(0))])])
    t2 = ts * ts
    t3 = t2 * ts
    t3x3 = np.float32(3) * t3
    for a, b, c in zip(t2, t3, t3x3):
        fused0 = np.float32(float(Fraction(float(a)) * 2 - Fraction(float(b))))
        fused2 = np.float32(float(Fraction(float(a)) * 4 - Fraction(float(c))))
        assert fused0 == np.float32(np.float32(2) * a - b)
        assert fused2 == np.float32(np.float32(4) * a - c)
    w0, _, w2, _ = rk.catmull_rom_weights(torch.from_numpy(ts))
    np.testing.assert_array_equal(
        w0.numpy(), np.float32(0.5) * ((np.float32(2) * t2 - t3) - ts))
    np.testing.assert_array_equal(
        w2.numpy(), np.float32(0.5) * ((np.float32(4) * t2 - t3x3) + ts))


# ------------------------------------------------------------- on the card
def _block(geometry, device, n_frames=8):
    name, fs = GEOMETRIES[geometry]
    mode = ALL_VIDEO_MODES[name]
    spf = fs / mode.refresh
    n = int(np.ceil(n_frames * spf)) + 1 + int(np.ceil(spf))
    rng = np.random.default_rng(7)
    words = torch.from_numpy(rng.integers(-20000, 20000, 2 * n).astype(np.int16)).to(device)
    starts, fracs = poff.exact_cut_starts(1000.25, spf, n_frames)
    return (int(np.floor(spf)), mode, words, torch.from_numpy(starts).to(device),
            torch.from_numpy(fracs).to(device))


def _entry(entry, words):
    env = am_envelope_from_iq(words)
    return env, {"envelope": (rk.frames_to_screens, env, 1),
                 "int16_words": (rk.frames_to_screens_from_words, words, 2),
                 "float32_words": (rk.frames_to_screens_from_words, words.to(torch.float32),
                                   2)}[entry]


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["rounded", "residuals"])
@pytest.mark.parametrize("entry", ["envelope", "int16_words", "float32_words"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_every_4_tap_variant_equals_plain(cuda_device, geometry, entry, exact):
    """The block's frames, then a frame at sample 0 (tap -1 clamps onto it)
    and one that reads past the block end, from a source off 16-byte
    alignment: the same bits as the plain version, one launch counted under
    its variant."""
    frame_len, mode, words, starts, fracs = _block(geometry, cuda_device)
    env, (fn, data, per_sample) = _entry(entry, words)
    raster = (frame_len, mode.height, mode.width, SHAPE)
    geom = rk.screen_geometry(*raster, cuda_device)
    residuals = fracs if exact else None
    # The words entry counts its load too: plain AM.
    variant = (4, exact) + (() if entry == "envelope" else ("am", False))
    with count_launches() as seen:
        got = fn(data, starts, *raster, residuals, 4)
    assert seen == {"k1": 1, ("k1", *variant): 1}
    ref = rk.frames_to_screens_plain(env, starts, geom, residuals, 4)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.equal(got, ref)

    n = 3 * frame_len - 4000
    edge = torch.tensor([0, frame_len + 3, 2 * frame_len + 1], dtype=torch.int32,
                        device=cuda_device)
    edge_res = fracs[:3].contiguous() if exact else None
    for lo in (0, 1):        # from sample 0, then one sample on: off alignment
        cut = data[lo * per_sample: (lo + n) * per_sample]
        got = fn(cut, edge, *raster, edge_res, 4)
        ref = rk.frames_to_screens_plain(env[lo: lo + n], edge, geom, edge_res, 4)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), lo


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16])
def test_the_tile_height_changes_no_bit(cuda_device, monkeypatch, rows):
    """Tiles of 1 to 16 rows (a block walks over more or fewer tiles, each
    loaded a tile ahead): the same bits as the plain version."""
    frame_len, mode, words, starts, fracs = _block("1080p60_20Msps", cuda_device, n_frames=4)
    raster = (frame_len, mode.height, mode.width, SHAPE)
    monkeypatch.setattr(rk, "ROWS_PER_TILE", {4: rows, 8: max(1, rows // 2)})
    got = rk.frames_to_screens_from_words(words, starts, *raster, fracs, 4)
    ref = rk.frames_to_screens_plain(am_envelope_from_iq(words), starts,
                                     rk.screen_geometry(*raster, cuda_device), fracs, 4)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [2, 4])
def test_int16_words_at_the_ends_of_their_range(cuda_device, taps):
    """The demod's square root on int16 words: every I with Q = 0 and every
    Q with I = 0 (sums of squares from 0 to 2^30), pairs of 0, ±1, ±2 and
    the extremes (up to 2^31), then random words.  Both kernels give the
    plain version's bits."""
    frame_len, mode, _, starts, _ = _block("1080p60_20Msps", cuda_device, n_frames=3)
    n = int(starts[-1]) + 2 * frame_len
    every = np.arange(-32768, 32768, dtype=np.int16)
    zero = np.zeros_like(every)
    rng = np.random.default_rng(5)
    ends = np.int16([0, 1, -1, 2, -2, 32767, -32767, -32768])
    pairs = np.concatenate([
        np.stack([every, zero], 1), np.stack([zero, every], 1),
        rng.choice(ends, (200_000, 2)),
        rng.integers(-32768, 32768, (n - 2 * every.size - 200_000, 2)).astype(np.int16)])
    words = torch.from_numpy(pairs.reshape(-1)).to(cuda_device)
    raster = (frame_len, mode.height, mode.width, SHAPE)
    got = rk.frames_to_screens_from_words(words, starts, *raster, None, taps)
    ref = rk.frames_to_screens_plain(am_envelope_from_iq(words), starts,
                                     rk.screen_geometry(*raster, cuda_device), None, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [2, 4])
def test_int16_fm_words_at_the_ends_of_their_range(cuda_device, taps):
    """The int16 FM load (its arc tangent without the division's slow path)
    on pairs of 0, ±1, ±2 and the extremes, on runs of equal pairs (y = 0,
    x from 0 to 2^31) and of pairs on the axes, then random words.  Both
    kernels give the plain version's bits."""
    frame_len, mode, _, starts, _ = _block("1080p60_20Msps", cuda_device, n_frames=3)
    n = int(starts[-1]) + 2 * frame_len
    rng = np.random.default_rng(6)
    ends = np.int16([0, 1, -1, 2, -2, 32767, -32767, -32768])
    every = np.arange(-32768, 32768, dtype=np.int16)
    zero = np.zeros_like(every)
    pairs = np.concatenate([
        np.repeat(rng.choice(ends, (20_000, 2)), 3, axis=0),
        np.stack([every, zero], 1), np.stack([zero, every], 1),
        rng.choice(ends, (200_000, 2)),
        rng.integers(-32768, 32768, (n - 60_000 - 2 * every.size - 200_000, 2)).astype(np.int16)])
    words = torch.from_numpy(pairs.reshape(-1)).to(cuda_device)
    raster = (frame_len, mode.height, mode.width, SHAPE)
    got = rk.frames_to_screens_from_words(words, starts, *raster, None, taps, demod="fm")
    ref = rk.frames_to_screens_plain(rk.words_envelope_plain(words, "fm"), starts,
                                     rk.screen_geometry(*raster, cuda_device), None, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
