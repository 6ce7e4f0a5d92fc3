"""The port's counterparts of the repo's ``bench.py`` and ``bench_all.py``
(``tempest_tpu_torch.bench``) on the CPU, at small sizes, and the tile plan
of K1's single-frame launch.

The bench chain against the JAX package's ``make_reconstruct_fn`` of the same
config through the same phase loop, on a capture's int16 words with a clear
blanking peak (640x480 @ 60 Hz at 4 Msps, 3 frames a block onto 150x200
screens, 3 iterations).  Tolerances, each stated where it is used:

* syncs with equal integer parts, the rows' centres to 1e-3 px
  (``tests/test_torch_pipeline.py``, sub-pixel sync); the columns' to that
  and the residuals' binning, 1/128 sample, which is 1/(128·delta) columns
  (delta: samples a column);
* the EMA to the sum of what ``tests/test_torch_resamplers.py`` states for
  ``mxu3`` with exact cuts and ``einsum_bf16``: the JAX package bins each
  frame's residual into 64 phases (at most 1/128 sample, times the largest
  step of the bfloat16-rounded envelope) and rounds its interpolation
  weights to bfloat16 (2⁻⁸ of the largest output); and the sub-pixel shift's
  part: the syncs' largest difference times the largest step between
  neighbouring pixels of the frames.  The EMA is a convex combination of
  aligned frames, which are convex combinations of the frames, so each bound
  carries to it.

``bench_all``: ``main(["--device", "cpu", ...])`` once, at 1 Msps and one
iteration a scenario; each of its lines against the JAX script's metric name
and unit (read from ``bench_all.py`` itself), in that script's order.
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.bench import bench, bench_all
from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.native import native_available
from tempest_tpu_torch.ops import resample_kernel as rk
from tempest_tpu_torch.ops.resample import round_to_bfloat16

ROOT = Path(__file__).resolve().parents[1]
MODE_NAME = "640x480 @ 60Hz"
FS = 4e6
N_FRAMES = 3
SHAPE = (150, 200)
ITERS = 3
BENCH_PY_KEYS = ("metric", "value", "unit", "vs_baseline", "ms_per_block", "iters", "n_frames",
                 "block_samples")
# bench_all.py's lines in its order: (the metric as that script's source
# writes it, the port's metric at --device cpu, the unit).
JAX_LINES = [
    ('"AM envelope demod (int16 ingest)"', "AM envelope demod (int16 ingest)",
     "Msamples/s/chip"),
    ('"autocorrelation timing estimation"', "autocorrelation timing estimation",
     "Msamples/s/chip"),
    ('"signal->screen resample (1 frame)"', "signal->screen resample (1 frame)",
     "Msamples/s/chip"),
    ('"full chain 1080p60"', "full chain 1080p60", "Msamples/s/chip"),
    ('f"batched serving x{bsz} streams 1080p60 (aggregate)"',
     "batched serving x4 streams 1080p60 (aggregate)", "Msamples/s/chip"),
    ('"streaming fidelity 1080p60 (quantised exact-cut tables)"',
     "streaming fidelity 1080p60 (quantised exact-cut tables)", "Msamples/s/chip"),
    ('"live-combine front (K=3 channelise + MRC fusion)"',
     "live-combine front (K=3 channelise + MRC fusion)", "Msamples/s/chip"),
    ('f"sharded mode search ({len(cands)} candidates, {mesh.devices.size} dev)"',
     "sharded mode search (26 candidates, 8 dev)", "Msamples/s/chip"),
    ('f"host ring put+take ({label})"', "host ring put+take (python)", "Msamples/s"),
    ('f"host ring put+take ({label})"', "host ring put+take (C++ native)", "Msamples/s"),
    ('"streaming host loop 1080p60 (source->ring->device->EMA)"',
     "streaming host loop 1080p60 (source->ring->device->EMA)", "Msamples/s/chip"),
    ('f"mesh streaming host loop 1080p60 ({n_dev} shards)"',
     "mesh streaming host loop 1080p60 (8 shards)", "Msamples/s"),
]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def words():
    """A block of int16 I/Q words of a synthetic capture (a clear blanking
    peak), scaled as an SDR delivers them."""
    cfg = bench.bench_config(MODE_NAME, FS, N_FRAMES, render_size=SHAPE)
    cap = tp.generate_iq(tp.ALL_VIDEO_MODES[MODE_NAME], FS, cfg.block_samples, snr_db=18.0,
                         seed=5)
    return np.clip(np.round(cap.iq.view(np.float32) * 8192), -32768, 32767).astype(np.int16)


def test_bench_config_is_bench_py_s():
    cfg = bench.bench_config()
    assert (cfg.sample_rate, cfg.mode, cfg.n_frames, cfg.block_samples) == (
        20e6, tp.ALL_VIDEO_MODES["1920x1080 @ 60Hz"], 36, 12_333_335)
    assert (cfg.input_format, cfg.carry_phase, cfg.subsample_align, cfg.do_align,
            cfg.align_subpixel, cfg.resampler, cfg.phase_bins, cfg.einsum_bf16) == (
        "iq_interleaved", True, True, True, True, "mxu3", 64, True)


def test_bench_chain_matches_jax(words):
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    jnp = pytest.importorskip("jax.numpy")

    cfg = bench.bench_config(MODE_NAME, FS, N_FRAMES, render_size=SHAPE)
    line, ema = bench.run(cfg, ITERS, "cpu", words)
    n, spf = cfg.block_samples, cfg.samples_per_frame
    jcfg = joff.ReconstructionConfig(
        sample_rate=FS, mode=cfg.mode, n_frames=N_FRAMES, render_size=SHAPE,
        input_format="iq_interleaved", carry_phase=True, subsample_align=True, do_align=True,
        align_subpixel=True, resampler="mxu3", phase_bins=64, einsum_bf16=True)
    jstep, pstep = joff.make_reconstruct_fn(jcfg), tp.make_reconstruct_fn(cfg, "cpu")
    ej, ep = jnp.zeros(SHAPE, jnp.float32), torch.zeros(SHAPE)
    ds, ds_rows, step_max = 0.0, 0.0, 0.0
    for i in range(ITERS):
        phase = (-i * n) % spf
        ej, _, sj, _ = jstep(jnp.asarray(words), ej, jnp.float32(bench.ALPHA), phase)
        ep, fp, sp, _ = pstep(words, ep, bench.ALPHA, phase)
        sj, sp = np.asarray(sj), sp.numpy()
        np.testing.assert_array_equal(np.floor(sp), np.floor(sj))
        ds = max(ds, float(np.abs(sp - sj).max()))
        ds_rows = max(ds_rows, float(np.abs(sp - sj)[:, 0].max()))
        f = fp.numpy()
        step_max = max(step_max, float(np.abs(np.diff(f, axis=1)).max()
                                       + np.abs(np.diff(f, axis=2)).max()))
    delta = rk.screen_geometry(int(spf), cfg.mode.height, cfg.mode.width, SHAPE,
                               torch.device("cpu")).delta
    assert ds_rows < 1e-3 and ds < 1e-3 + 1 / (128 * delta)
    # bench.run's EMA is the same loop's.
    assert torch.equal(ema, ep)
    env = round_to_bfloat16(tp.am_envelope_from_iq(torch.from_numpy(words[: 2 * n]))).numpy()
    ej = np.asarray(ej)
    largest = float(np.abs(ej).max())
    bound = np.abs(np.diff(env)).max() / 128 + 2.0 ** -8 * largest + ds * step_max
    assert float(np.abs(ema.numpy() - ej).max()) <= bound * 1.001


def test_bench_line_has_bench_py_s_keys(words):
    cfg = bench.bench_config(MODE_NAME, FS, N_FRAMES, render_size=SHAPE)
    line, _ = bench.run(cfg, 2, "cpu", words)
    assert set(BENCH_PY_KEYS) | {"device", "power_limit_w"} == set(line)
    assert line["metric"] == bench.METRIC and line["unit"] == "Msamples/s/chip"
    assert line["value"] > 0 and line["vs_baseline"] == line["value"] / 20.0
    assert (line["iters"], line["n_frames"], line["block_samples"]) == (
        2, N_FRAMES, cfg.block_samples)
    assert line["ms_per_block"] == pytest.approx(cfg.block_samples / line["value"] / 1e3)
    assert (line["device"], line["power_limit_w"]) == ("cpu", None)
    json.dumps(line)


def test_bench_main_prints_one_line(capsys, monkeypatch):
    """``main`` builds ``bench.py``'s config and prints one JSON line; the
    run itself is held above, so it is stubbed here."""
    seen = {}

    def fake_run(config, iters, device):
        seen.update(config=config, iters=iters, device=device)
        return {"metric": bench.METRIC, "value": 1.0}, None

    monkeypatch.setattr(bench, "run", fake_run)
    bench.main(["--device", "cpu", "--iters", "5"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and json.loads(out[0])["metric"] == bench.METRIC
    assert seen["config"] == bench.bench_config() and seen["iters"] == 5
    assert seen["device"] == "cpu"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run(bench.bench_config(MODE_NAME, FS, N_FRAMES, render_size=SHAPE), 1)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench_all.main(["--iters", "1"])


@pytest.fixture(scope="module")
def bench_all_lines():
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        results = bench_all.main(["--device", "cpu", "--fs", "1e6", "--iters", "1"])
    lines = [json.loads(text) for text in printed.getvalue().splitlines()]
    assert lines == results
    return lines


def test_bench_all_prints_the_jax_script_s_lines_in_its_order(bench_all_lines):
    want = [port for _, port, _ in JAX_LINES if native_available() or "C++" not in port]
    assert [line["metric"] for line in bench_all_lines] == want


@pytest.mark.parametrize("jax_metric, metric, unit", JAX_LINES, ids=[p for _, p, _ in JAX_LINES])
def test_bench_all_scenario(bench_all_lines, jax_metric, metric, unit):
    """Each scenario at 1 Msps, one iteration: the JAX script's metric (as
    its source writes it) and unit, a positive rate, the device named."""
    source = (ROOT / "bench_all.py").read_text()
    assert jax_metric in source and f'"unit": "{unit}"' in source
    if "C++" in metric and not native_available():
        assert metric not in [line["metric"] for line in bench_all_lines]
        return
    line = next(line for line in bench_all_lines if line["metric"] == metric)
    assert line["unit"] == unit and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 20.0)
    assert (line["device"], line["power_limit_w"]) == ("cpu", None)
    if "host loop" in metric:
        assert line["blocks_per_s"] > 0
        assert line["realtime_factor"] == pytest.approx(line["value"])


def test_scenario_functions_take_device_fs_iters_rng():
    """Every scenario is one function ``(device, fs, iters, rng)``, in the
    JAX script's order."""
    import inspect

    assert len(bench_all.SCENARIOS) == len(JAX_LINES)
    for fn in bench_all.SCENARIOS:
        assert list(inspect.signature(fn).parameters) == ["device", "fs", "iters", "rng"]


def test_a_short_streaming_run_cannot_pass_as_a_rate(monkeypatch):
    """Scenario 8 reads the count the mesh runtime reports: a run that
    dispatched fewer blocks than asked for raises."""
    real = bench_all.MeshStreamingRuntime.process_blocks

    def short(self, n_blocks, *args, **kwargs):
        return real(self, max(n_blocks - 1, 1) if n_blocks > 2 else n_blocks, *args, **kwargs)

    monkeypatch.setattr(bench_all.MeshStreamingRuntime, "process_blocks", short)
    monkeypatch.setattr(bench_all, "CPU_SHARDS", 2)
    with pytest.raises(RuntimeError, match="dispatched 7 of 8 blocks"):
        bench_all.mesh_streaming(torch.device("cpu"), 1e6, 1, np.random.default_rng(0))


# ---------------------------------------------- K1's single-frame tile plan
SLICE = (333_333, 1125, 2576)   # one 1080p60 frame at 20 Msps: frame length, lines, width


@pytest.mark.parametrize("sample_bytes", [4, 8])
def test_one_frame_fills_the_card_and_many_frames_keep_their_plan(sample_bytes):
    """On a card of 132 SMs one 600x800 frame gets at least 132 tiles (75 of
    8 rows before); a 36-frame launch keeps ``ROWS_PER_TILE`` and its stage
    buffer, as does a launch that is told of no card."""
    sms = 132
    rows, cap = rk.tile_plan(*SLICE, (600, 800), sample_bytes, 0, 2, 1, sms)
    assert -(-600 // rows) >= sms and rows <= rk.ROWS_PER_TILE[sample_bytes]
    assert cap == rk.tile_run_cap(*SLICE, (600, 800), rows)
    many = rk.tile_plan(*SLICE, (600, 800), sample_bytes, 0, 2, 36, sms)
    assert many == rk.tile_plan(*SLICE, (600, 800), sample_bytes)
    assert many[0] == rk.ROWS_PER_TILE[sample_bytes]
    for taps in (2, 4):
        assert rk.tile_plan(*SLICE, (600, 800), sample_bytes, 1, taps, 36, sms) == \
            rk.tile_plan(*SLICE, (600, 800), sample_bytes, 1, taps)


@pytest.mark.parametrize("fill, rows", [(0, 8), (1, 4), (2, 2), (4, 1)])
def test_fill_tiles_per_sm_sets_the_single_frame_rows(monkeypatch, fill, rows):
    monkeypatch.setattr(rk, "FILL_TILES_PER_SM", fill)
    assert rk.tile_plan(*SLICE, (600, 800), 4, 0, 2, 1, 132)[0] == rows


def test_launch_plan_is_made_once_per_raster(monkeypatch):
    """The plan of a launch (line tables, tile plan, cost) is cached; it is
    made again where ``ROWS_PER_TILE`` or ``FILL_TILES_PER_SM`` change."""
    plan = rk._plan
    args = (333_333, 1, 4, *SLICE, (600, 800), torch.device("cpu"), None, False, 2, False)
    a = plan(*args)
    assert plan(*args) is a
    assert a.cost == rk.launch_cost(333_333, 4, 1, *SLICE, (600, 800), False)
    assert a.span == a.geom.span and a.rows == 8   # no card: no SMs to fill
    monkeypatch.setitem(rk.ROWS_PER_TILE, 4, 4)
    assert plan(*args).rows == 4


def test_frame_to_screen_on_the_cpu_counts_no_launch():
    mode = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
    sig = torch.from_numpy(np.random.default_rng(0).random(33_333, dtype=np.float32))
    with count_launches() as seen:
        got = rk.frame_to_screen(sig, mode.height, mode.width, (48, 64), 0.25)
    geom = rk.screen_geometry(33_333, mode.height, mode.width, (48, 64), sig.device)
    ref = rk.frames_to_screens_plain(sig, torch.zeros(1, dtype=torch.int32), geom,
                                     torch.full((1,), 0.25))[0]
    assert torch.equal(got, ref) and not seen
