"""K1 over a candidate set in one launch
(``ops.resample_kernel.frames_to_screens_candidates``): the stacked table,
the plain version and, on the card, the kernel against it.

Each candidate's screens are held to the bit against ``frames_to_screens``
of that candidate alone: the candidate launch reads the same line tables
(views of the stacked table) and does each pixel's float32 operations in the
same order.  Against the Pallas kernel the tolerance is that of
``tests/test_torch_resample_kernel.py`` (1e-5 of the largest output: its
fixed-point fractions).  On the card: ``python -m pytest --noconftest
tests/test_torch_k1_candidates.py -m cuda``."""

import numpy as np
import pytest
import torch

from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.ops import resample_kernel as rk
from tempest_tpu_torch.io.synthetic import generate_iq
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES, candidate_modes

REL = 1e-5
CPU = torch.device("cpu")


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


def _rasters(tol_hz=0.5):
    return tuple((m.height, m.width) for _, m in candidate_modes(60.0, tol_hz=tol_hz))


def _block(fs, n_frames, seed, extra=1):
    """A random envelope of ``n_frames`` frame periods at ``fs`` and 60 Hz, and
    the frames' rounded starts."""
    spf = fs / 60.0
    n = int(np.ceil(n_frames * spf)) + extra
    env = np.random.default_rng(seed).random(n, dtype=np.float32)
    starts = np.round(np.arange(n_frames) * spf).astype(np.int32)
    return int(np.floor(spf)), torch.from_numpy(env), torch.from_numpy(starts)


@pytest.mark.parametrize("num_phases", [None, 16])
@pytest.mark.parametrize("shape", [(150, 200), (48, 99)])
def test_the_stacked_table_equals_each_candidate_s_screen_geometry(shape, num_phases):
    frame_len = int(4e6 / 60.0)
    rasters = _rasters()
    table = rk.candidate_table(frame_len, rasters, shape, CPU, num_phases)
    assert len(table.geometries) == len(rasters) > 10
    n, h = len(rasters), shape[0]
    head = table.table[: 5 * n].view(n, 5)
    before, caps = 0, []
    for c, (y_t, x_t) in enumerate(rasters):
        ref = rk.screen_geometry(frame_len, y_t, x_t, shape, CPU, num_phases)
        got = table.geometries[c]
        assert torch.equal(got.line_start, ref.line_start)
        assert torch.equal(got.line_frac, ref.line_frac)
        assert torch.equal(got.wr, ref.wr)
        assert (got.delta, got.span, got.out_shape) == (ref.delta, ref.span, ref.out_shape)
        rows, cap = rk.tile_plan(frame_len, y_t, x_t, shape, 4)
        tiles = -(-h // rows)
        assert head[c].tolist() == [int(np.float32(ref.delta).view(np.int32)), ref.span, rows,
                                    tiles, before]
        before += tiles
        caps.append(cap)
    assert table.tiles_per_frame == before
    assert table.run_cap == max(caps)
    assert table.table.numel() == 5 * n + 5 * n * h
    # Built once per set: a second search over the same set reuses it.
    assert rk.candidate_table(frame_len, rasters, shape, CPU, num_phases) is table


@pytest.mark.parametrize("num_phases", [None, 16])
def test_the_plain_candidate_screens_equal_each_candidate_s_screens(num_phases):
    frame_len, env, starts = _block(4e6, 2, seed=7)
    rasters = _rasters()
    got = rk.frames_to_screens_candidates(env, starts, frame_len, rasters, (150, 200),
                                          num_phases)
    table = rk.candidate_table(frame_len, rasters, (150, 200), CPU, num_phases)
    assert torch.equal(got, rk.frames_to_screens_candidates_plain(env, starts, table))
    assert got.shape == (len(rasters), 2, 150, 200)
    for c, (y_t, x_t) in enumerate(rasters):
        one = rk.frames_to_screens(env, starts, frame_len, y_t, x_t, (150, 200), None, 2,
                                   num_phases)
        assert torch.equal(got[c], one), c


def test_candidate_screens_match_the_pallas_kernel():
    pallas = pytest.importorskip("tempest_tpu.ops.pallas_resample")
    jnp = pytest.importorskip("jax.numpy")
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    fs, shape = 2e6, (48, 64)
    env = np.abs(generate_iq(mode, fs, int(2.2 * fs / 60.0), snr_db=18.0, seed=5).iq)
    env = env.astype(np.float32)
    frame_len = int(np.floor(fs / 60.0))
    starts = np.array([0, frame_len // 3], np.int32)
    rasters = [(525, 800), (500, 840), (628, 1056)]
    got = rk.frames_to_screens_candidates(torch.from_numpy(env), torch.from_numpy(starts),
                                          frame_len, rasters, shape).numpy()
    for c, (y_t, x_t) in enumerate(rasters):
        ref = np.asarray(pallas.frames_to_screens_pallas(
            jnp.asarray(env), jnp.asarray(starts), frame_len, y_t, x_t, shape, interpret=True))
        assert np.abs(got[c] - ref).max() / np.abs(ref).max() < REL, c


def test_candidates_launch_cost_counts_the_union_of_the_reads():
    """The candidates read one envelope: its samples are charged once, at
    least as many as the widest candidate addresses and at most all of
    theirs; every candidate's screens and the table are charged."""
    frame_len = int(20e6 / 60.0)
    rasters = _rasters()
    table = rk.candidate_table(frame_len, rasters, (150, 200), CPU, 16)
    nbytes, flops = rk.candidates_launch_cost(12_333_335, 2, table)
    alone = [rk.frame_samples_read(frame_len, y, x, (150, 200)) for y, x in rasters]
    assert max(alone) <= table.samples_per_frame <= sum(alone)
    pixels = len(rasters) * 2 * 150 * 200
    assert nbytes == (2 * table.samples_per_frame * 4 + 8 + 4 * table.table.numel()
                      + 4 * pixels)
    assert flops == pixels * 20
    # A block shorter than the frames' reads is charged as a whole.
    assert rk.candidates_launch_cost(1000, 2, table)[0] == nbytes - (
        2 * table.samples_per_frame - 1000) * 4


def test_candidate_entry_refusals():
    frame_len, env, starts = _block(4e6, 2, seed=1)
    with pytest.raises(ValueError, match="empty candidate set"):
        rk.frames_to_screens_candidates(env, starts, frame_len, [], (150, 200))
    with pytest.raises(ValueError, match="1-D"):
        rk.frames_to_screens_candidates(env[None], starts, frame_len, [(525, 800)], (150, 200))


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("num_phases", [None, 16])
@pytest.mark.parametrize("shape", [(150, 200), (600, 800)])
def test_candidate_kernel_equals_its_plain_version(cuda_device, shape, num_phases):
    """The 26 modes within 0.5 Hz of 60 Hz on 2 frames of 1080p60 at 20 Msps
    (the smoke's search) in one launch: their run caps differ, and every
    candidate's screens equal the plain version's to the bit."""
    frame_len, env, starts = _block(20e6, 2, seed=3)
    env, starts = env.to(cuda_device), starts.to(cuda_device)
    rasters = _rasters()
    table = rk.candidate_table(frame_len, rasters, shape, cuda_device, num_phases)
    caps = {rk.tile_plan(frame_len, y_t, x_t, shape, 4)[1] for y_t, x_t in rasters}
    assert len(caps) > 1
    with count_launches() as seen:
        got = rk.frames_to_screens_candidates(env, starts, frame_len, rasters, shape, num_phases)
    assert seen == {"k1": 1, ("k1", 2, False, "candidates"): 1}
    ref = rk.frames_to_screens_candidates_plain(env, starts, table)
    torch.cuda.synchronize()
    assert got.shape == (len(rasters), 2, *shape)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(150, 200), (48, 99)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_candidate_kernel_at_the_block_edges(cuda_device, shape):
    """A frame at sample 0 and one whose bottom rows read past the block end
    (the clamped path), from a source off 16-byte alignment, at a width of
    one column a work item: the same bits as each candidate alone."""
    frame_len, env, _ = _block(20e6, 3, seed=4)
    env = env.to(cuda_device)[1: 2 * frame_len + frame_len // 2]
    starts = torch.tensor([0, frame_len + 3, 2 * frame_len - 7], dtype=torch.int32,
                          device=cuda_device)
    rasters = _rasters()[:9]
    got = rk.frames_to_screens_candidates(env, starts, frame_len, rasters, shape, 16)
    for c, (y_t, x_t) in enumerate(rasters):
        one = rk.frames_to_screens(env, starts, frame_len, y_t, x_t, shape, None, 2, 16)
        assert torch.equal(got[c], one), c
