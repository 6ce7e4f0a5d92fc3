"""K1's balanced walk over its tiles, the FM loads' (``csrc/resample.cu``
``walk_start``, ``walk_tile``, ``walk_next``; ``ops/resample_kernel.py``
``balanced_walk``, ``walk_tiles``): the launch's rows, frame after frame,
cut into one range a block, ranges that differ by one row at most, each
rendered in tiles of at most the plan's rows that end at a frame's end.

On the CPU: the plan against a plain reckoning (every row of every frame in
exactly one tile of one block; the stage buffer holds the run of the plan's
rows from any row).  On the card (``cuda``): the load at launches of fewer
rows than blocks and of a few more tiles than a wave, equal to the plain
version to the bit.  The JAX package has no counterpart: the walk is the
kernel's work split, not a function of the package."""

import numpy as np
import pytest
import torch

from tempest_tpu_torch.ops import resample_kernel as rk
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

# (mode, sample rate): the slice's geometry and 640x480 @ 32 Msps, where
# auto_reconstruct(demod="fm") launches the 4-tap load.
GEOMETRIES = {"1080p60_20Msps": ("1920x1080 @ 60Hz", 20e6),
              "640x480_32Msps": ("640x480 @ 60Hz", 32e6)}


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


def test_only_int16_fm_words_take_the_balanced_walk():
    """FM words take the balanced walk, int16 and (since the float32 FM
    load's redesign) float32, rounded and inverted or not; AM words and the
    envelope the strided one."""
    codes = {(dtype, demod, bf16, invert): rk.word_code(dtype, demod, bf16, invert)[0]
             for dtype in (torch.int16, torch.float32) for demod in ("am", "fm")
             for bf16 in (False, True) for invert in (False, True)}
    for (dtype, demod, _, _), code in codes.items():
        assert rk.balanced_walk(code) == (demod == "fm")
    assert not rk.balanced_walk(0)   # the envelope


@pytest.mark.parametrize("n_frames, h, rows, blocks", [
    (36, 600, 8, 528),    # the slice, 2 taps: 40.9 rows a block
    (36, 600, 8, 660),    # the slice, 4 taps
    (11, 600, 8, 396),    # 640x480 at 32 Msps, 4 taps: 16.7 rows a block
    (1, 600, 8, 660),     # fewer rows than blocks: some blocks have none
    (3, 7, 4, 5),         # ranges across several frames
    (2, 48, 8, 13),       # a few more tiles than blocks
    # float32 words: their plan's rows, two to four blocks an SM.
    (36, 600, rk.ROWS_PER_TILE_FM[8], 264),   # the slice: 81.8 rows a block
    (36, 600, rk.ROWS_PER_TILE_FM[8], 528),
    (11, 600, rk.ROWS_PER_TILE_FM[8], 396),   # 640x480 at 32 Msps
    (1, 600, rk.ROWS_PER_TILE_FM[8], 528),
])
def test_the_walk_renders_every_row_once_in_even_shares(n_frames, h, rows, blocks):
    """Every (frame, row) in exactly one tile of one block; a tile of at most
    the plan's rows inside one frame; a block's tiles neighbours, its rows
    the launch's share (the shares differ by one row at most)."""
    seen = np.zeros((n_frames, h), np.int64)
    shares = []
    for b in range(blocks):
        tiles = rk.walk_tiles(n_frames, h, rows, blocks, b)
        shares.append(sum(t[2] for t in tiles))
        for (f, r0, n), nxt in zip(tiles, tiles[1:] + [None]):
            assert 1 <= n <= rows and 0 <= r0 and r0 + n <= h
            seen[f, r0:r0 + n] += 1
            if nxt is not None:   # the next tile starts where this one ends
                assert (nxt[0] * h + nxt[1]) == f * h + r0 + n
    assert (seen == 1).all()
    total = n_frames * h
    assert sum(shares) == total
    assert max(shares) - min(shares) <= 1
    assert max(shares) == -(-total // blocks)


@pytest.mark.parametrize("sample_bytes", [4, 8], ids=["int16", "float32"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("taps", [2, 4])
def test_the_balanced_plan_holds_the_run_from_any_row(geometry, taps, sample_bytes):
    """The stage buffer of the balanced walk holds the run of the plan's rows
    from every row, by a plain reckoning over the line tables, and the plan
    keeps its rows where the strided plan would halve them to fill the
    card; int16 and float32 words, each with its rows a tile (float32 fewer
    where the SM would hold too few blocks)."""
    name, fs = GEOMETRIES[geometry]
    mode = ALL_VIDEO_MODES[name]
    frame_len = int(np.floor(fs / mode.refresh))
    raster = (frame_len, mode.height, mode.width, (600, 800))
    reach = sum(rk.line_reach(taps, True))
    rows, cap = rk.tile_plan(*raster, sample_bytes, reach, taps, balanced=True)
    if sample_bytes == 4:
        assert rows == rk.ROWS_PER_TILE_FM[4]
    else:
        # float32: ROWS_PER_TILE_FM's rows where an SM holds FM_MIN_BLOCKS
        # blocks of the plan's shared memory (stages and envelope, 20 bytes a
        # sample, and the kernel's static tables), else fewer: 5 rows at the
        # slice, 4 at 640x480 at 32 Msps, where 5 would leave one block an SM.
        static = 768 if taps == 2 else 2 * 768 + 16

        def blocks(r):
            need = rk.tile_run_cap(*raster, r, reach, True) * 20 + static
            return rk.SM_SHARED_BYTES // (need + rk.BLOCK_RESERVED_BYTES)

        assert rows == {"1080p60_20Msps": 5, "640x480_32Msps": 4}[geometry]
        assert blocks(rows) >= rk.FM_MIN_BLOCKS or rows == rk.ROWS_PER_TILE[8]
        assert rows == rk.ROWS_PER_TILE_FM[8] or blocks(rows + 1) < rk.FM_MIN_BLOCKS
    geom = rk.screen_geometry(*raster, torch.device("cpu"))
    starts = geom.line_start.numpy().astype(np.int64)
    need = max(int(starts[min(r + rows, 600) - 1, 1] + geom.span - starts[r, 0]) + reach
               for r in range(600))
    assert cap >= need + 6 and cap % 4 == 0
    assert cap == rk.tile_run_cap(*raster, rows, reach, True)
    assert cap >= rk.tile_run_cap(*raster, rows, reach)
    # One frame on a card of 132 SMs: the strided plan halves its rows.
    assert rk.tile_plan(*raster, sample_bytes, reach, taps, 1, 132, balanced=True)[0] == rows
    assert rk.tile_plan(*raster, sample_bytes, reach, taps, 1, 132)[0] < rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32], ids=["int16", "float32"])
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("n_frames", [1, 2, 14])
def test_the_walk_on_the_card_renders_every_row(cuda_device, n_frames, taps, dtype):
    """640x480 at 32 Msps: one frame (600 rows, fewer than the card's
    blocks), two frames, and 14 frames (8,400 rows: 21-22 a block at 3
    blocks an SM on 132 SMs, a few more than three tiles of 7 rows), the
    memory the output will take first filled with NaN (a block of that size,
    freed to the allocator's cache): every pixel written, equal to the plain
    version to the bit."""
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    spf = 32e6 / mode.refresh
    frame_len = int(np.floor(spf))
    n = int(np.ceil((n_frames + 1) * spf))
    rng = np.random.default_rng(9)
    words = torch.from_numpy(rng.integers(-32768, 32768, 2 * n).astype(np.int16)).to(
        cuda_device, dtype)
    starts = torch.from_numpy(poff.carry_phase_starts(0.0, spf, n_frames)).to(cuda_device)
    raster = (frame_len, mode.height, mode.width, (600, 800))
    del_me = torch.full((n_frames, 600, 800), float("nan"), device=cuda_device)
    del del_me
    got = rk.frames_to_screens_from_words(words, starts, *raster, None, taps, demod="fm")
    ref = rk.frames_to_screens_plain(rk.words_envelope_plain(words, "fm"), starts,
                                     rk.screen_geometry(*raster, cuda_device), None, taps)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(got).any())
    assert torch.equal(got, ref)
