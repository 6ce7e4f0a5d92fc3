"""``tempest_tpu_torch.utils.profiling`` and ``utils.roofline``, the package's
export list, and K1's cost function.

``Metrics`` is the JAX package's class (same source text, checked in
``tests/test_torch_copies.py``) and is held against it on the same calls.
``RooflineReport`` is held against the JAX package's report on the same
counts and peaks: the arithmetic is a handful of float64 divisions, so the
two agree to 1e-12 relative.  ``roofline()`` has no counterpart to compare
numbers with (the JAX one asks XLA's cost model): its counts are checked
against what the operations' shapes give, exactly.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.ops import resample_kernel
from tempest_tpu_torch.utils import roofline as proof
from tempest_tpu_torch.utils.profiling import Metrics, annotate, trace
from tempest_tpu_torch.utils.roofline import H100_PEAKS, RooflineReport, report_launch, roofline


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_metrics_match_the_jax_package():
    jax_prof = pytest.importorskip("tempest_tpu.utils.profiling")
    ours, theirs = Metrics(), jax_prof.Metrics()
    for m in (ours, theirs):
        m.count("blocks")
        m.count("blocks", 2.0)
        m.count("samples", 1e6)
        m.gauge("backlog", 3.0)
    a, b = ours.snapshot(), theirs.snapshot()
    assert a["counters"] == b["counters"] == {"blocks": 3.0, "samples": 1e6}
    assert a["gauges"] == b["gauges"] == {"backlog": 3.0}
    assert set(a) == set(b) == {"uptime_s", "counters", "rates_per_s", "gauges"}
    assert ours.rate("blocks") > 0 and ours.rate("missing") == 0.0
    assert json.loads(ours.json())["counters"]["blocks"] == 3.0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "traces"
    x = torch.ones(1024)
    for _ in range(2):
        with trace(str(log_dir)) as prof:
            with annotate("tt_region"):
                (x * 2.0).sum()
    files = sorted(os.listdir(log_dir))
    assert files == ["trace_0.json", "trace_1.json"]
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "tt_region" for e in events)
    assert any("tt_region" in evt.key for evt in prof.key_averages())


def test_roofline_report_arithmetic_matches_the_jax_package():
    jax_roof = pytest.importorskip("tempest_tpu.utils.roofline")
    peaks = {"flops_per_s": 5e12, "bytes_per_s": 1e12}
    for flops, nbytes in ((1e9, 1e9), (1e12, 1e9), (0.0, 1e6), (1e6, 0.0)):
        ours = RooflineReport(flops, nbytes, 10.0)
        theirs = jax_roof.RooflineReport(flops, nbytes, 10.0)
        assert ours.arithmetic_intensity == theirs.arithmetic_intensity
        assert ours.bound(peaks) == theirs.bound(peaks)
        assert ours.speed_of_light_s(peaks) == pytest.approx(
            theirs.speed_of_light_s(peaks), rel=1e-12)
        assert ours.achieved_fraction(2e-3, peaks) == pytest.approx(
            theirs.achieved_fraction(2e-3, peaks), rel=1e-12)
    assert RooflineReport(1.0, 1.0, 0.0).achieved_fraction(0.0) == 0.0


def test_h100_peaks_are_the_data_sheet_and_no_tpu_figure():
    assert H100_PEAKS["bytes_per_s"] == 3.35e12
    assert H100_PEAKS["flops_per_s"] == 67e12
    assert set(H100_PEAKS) == {"flops_per_s", "bytes_per_s"}
    rep = RooflineReport(flops=67e9, bytes_accessed=3.35e9, transcendentals=0.0)
    assert rep.speed_of_light_s() == pytest.approx(1e-3)
    assert rep.bound() == "compute"   # on the ridge
    assert RooflineReport(1e9, 1e9, 0.0).bound() == "memory"
    text = RooflineReport(2e9, 1e9, 0.0).summary(measured_s=1e-3)
    assert "2.00 GFLOP" in text and "1.000 GB accessed" in text and "memory-bound" in text
    assert "% of roof" in text
    assert not hasattr(proof, "V5E_PEAKS")


def test_roofline_counts_operations_from_their_shapes():
    a = torch.ones(64, 32)
    b = torch.ones(32, 16)

    def fn(a, b):
        c = a @ b                   # reads a, b; writes c: 2*32 ops per element
        d = c.t()                   # a view: nothing moves
        return torch.sqrt(d + 1.0)  # add: read c, write; sqrt: read, write

    rep = roofline(fn, a, b)
    mm_bytes = 4 * (64 * 32 + 32 * 16 + 64 * 16)
    ew_bytes = 2 * 4 * (2 * 64 * 16)
    assert rep.bytes_accessed == mm_bytes + ew_bytes
    assert rep.flops == 2 * 32 * 64 * 16 + 2 * 64 * 16
    assert rep.transcendentals == 64 * 16
    assert rep.kernel_launches == 0 and rep.kernel_bytes == 0


def test_roofline_takes_what_a_kernel_wrapper_reports():
    cost = resample_kernel.launch_cost(1000, 4, 2, 400, 12, 30, (6, 8), False)

    def fn():
        report_launch(*cost)
        return torch.zeros(4) + 1.0

    rep = roofline(fn)
    assert rep.kernel_launches == 1
    assert rep.kernel_bytes == cost[0] and rep.kernel_flops == cost[1]
    assert rep.bytes_accessed == cost[0] + 3 * 16   # zeros written; read and written by the add
    # Outside a roofline run a report goes nowhere and costs nothing.
    report_launch(*cost)
    assert roofline(lambda: None).kernel_launches == 0


def _samples_a_frame_addresses(raster, reach):
    """The union of the scan lines' spans, marked sample by sample."""
    line_start, _, _, _, span = resample_kernel._line_tables(*raster)
    read = np.zeros(int(line_start.max()) + span + reach, dtype=bool)
    for s in line_start.reshape(-1):
        read[s: s + span + reach] = True
    return int(read.sum())


@pytest.mark.parametrize("taps,exact,demod,sample_bytes", [
    (2, False, False, 4), (2, True, True, 4), (4, False, True, 8), (4, True, False, 4)])
@pytest.mark.parametrize("shape", [(600, 800), (150, 200)])
def test_launch_cost_is_the_stated_arithmetic(taps, exact, demod, sample_bytes, shape):
    """The bytes are the samples the line tables address, not the block: a
    600-row screen of the 1125-line raster reads every line (36 frames of
    the 37 frame periods a block holds), a 150-row screen 300 lines of it."""
    n, frames, (h, w) = 12_333_335, 36, shape
    raster = (333_333, 1125, 2576, shape)
    nbytes, flops, roots = resample_kernel.launch_cost(n, sample_bytes, frames, *raster, demod,
                                                       taps, exact)
    reach = (2 if taps == 4 else 0) + (1 if exact else 0)
    read = frames * _samples_a_frame_addresses(raster, reach)
    if shape == (600, 800):
        assert 36 * 333_333 <= read <= 36 * 333_340
    else:
        assert 0.25 * 333_333 < read / frames < 0.29 * 333_333
    pixels = frames * h * w
    assert nbytes == read * sample_bytes + (8 if exact else 4) * frames + 20 * h + 4 * pixels
    per_tap = 8 if taps == 2 else 30
    assert flops == pixels * (4 + 2 * per_tap) + (4 * read if demod else 0)
    assert roots == (read if demod else 0)
    # A block shorter than the frames' lines is charged as a whole.
    assert resample_kernel.launch_cost(1000, sample_bytes, frames, *raster, demod, taps,
                                       exact)[0] == nbytes - (read - 1000) * sample_bytes


# Names that ``tempest_tpu/__init__.py`` exports and the port lacks: none.
MISSING_FROM_THE_PORT: set[str] = set()
# The multi-device layer, which neither package's ``__init__`` exports in
# the JAX package (it lives in ``parallel/`` and ``runtime/mesh_stream.py``):
# every public name of those modules resolves in the port's module of the
# same name, and the port exports them from its top level too.
MESH_MODULES = ("parallel.mesh", "parallel.distributed", "parallel.sharded",
                "runtime.mesh_stream")
JAX_ONLY_MESH_NAMES = {"P", "NamedSharding"}   # JAX's own classes, re-exported there
# A module of the JAX package whose counterpart has another path, and the
# names that change with it: the Pallas kernel's module is K1's.
PORT_MODULE_OF = {
    "ops.pallas_resample": ("ops.resample_kernel", {
        "frames_to_screens_pallas": "frames_to_screens",
        "frame_to_screen_pallas": "frame_to_screen"}),
}
# Public names of the JAX package's modules that the port leaves out, each
# with its reason.
NOT_IN_THE_PORT = {
    # The TPU's exact-cut formulation (one-hot matmuls rebuilt on the device);
    # K1 takes the frames' residuals in float64 instead (ops/resample.py).
    "ops.resample": {"StreamingExactPlan", "frames_to_screens_mxu3_exact"},
    # A TPU v5e's peak rates: no figure of the port's card.
    "utils.roofline": {"V5E_PEAKS"},
    "parallel.mesh": JAX_ONLY_MESH_NAMES,
}


def test_every_public_name_of_the_jax_package_resolves_in_the_port():
    import importlib

    tt = pytest.importorskip("tempest_tpu")
    public = {n for n in vars(tt) if not n.startswith("_")
              and not isinstance(getattr(tt, n), type(os))}   # no sub-modules
    missing = {n for n in public if not hasattr(tp, n)}
    assert missing == MISSING_FROM_THE_PORT, sorted(missing)
    for name in ("make_batched_reconstruct_fn", "mode_search_static", "WebOperatorView",
                 "Metrics", "trace", "annotate", "roofline", "H100_PEAKS", "RooflineReport",
                 "RENDER_SIZE", "downgrade_image", "linear_resample", "sig_to_image"):
        assert hasattr(tp, name), name
    for module in MESH_MODULES:
        theirs = importlib.import_module(f"tempest_tpu.{module}")
        ours = importlib.import_module(f"tempest_tpu_torch.{module}")
        names = set(theirs.__all__) - JAX_ONLY_MESH_NAMES
        assert names <= set(ours.__all__), (module, sorted(names - set(ours.__all__)))
        assert names <= set(vars(tp)) | {"ModeSearchResult"}, (module, sorted(names - set(vars(tp))))
    assert set(importlib.import_module("tempest_tpu.ops.spectrum").__all__) <= set(
        importlib.import_module("tempest_tpu_torch.ops.spectrum").__all__)
    # Every module of the JAX package that states an ``__all__``: each of its
    # names is in the ``__all__`` of the port's module of the same path, but
    # the stated exceptions.
    root = Path(tt.__file__).parent
    compared = 0
    for path in sorted(root.rglob("*.py")):
        module = ".".join(path.relative_to(root).with_suffix("").parts)
        theirs = importlib.import_module(f"tempest_tpu.{module}")
        if not hasattr(theirs, "__all__"):
            continue
        port_module, renamed = PORT_MODULE_OF.get(module, (module, {}))
        ours = set(importlib.import_module(f"tempest_tpu_torch.{port_module}").__all__)
        wanted = {renamed.get(n, n) for n in theirs.__all__} - NOT_IN_THE_PORT.get(module, set())
        assert wanted <= ours, (module, sorted(wanted - ours))
        compared += 1
    assert compared == 28


def test_no_not_implemented_error_is_left_in_the_port():
    """Every module of the JAX package is ported: no function of the port
    raises ``NotImplementedError`` (the mesh functions did until the
    multi-device slice), and the mesh functions take a mesh and run."""
    from pathlib import Path

    root = Path(tp.__file__).parent
    hits = [(path.name, i + 1) for path in sorted(root.rglob("*.py"))
            for i, line in enumerate(path.read_text().splitlines())
            if "NotImplementedError" in line]
    assert hits == []
    mode = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
    res = tp.sharded_mode_search(np.ones(140_000, np.float32), 4e6, 60.0,
                                 [("640x480 @ 60Hz", mode)], tp.make_mesh(devices=["cpu"] * 2),
                                 render_size=(30, 40))
    assert res.scores.shape == (1,) and res.best_index == 0



def test_invert_am_demod_matches_jax():
    """``invert_am_demod``: ``1 - |z|/max|z|``; one division after the same
    float32 magnitude, so 1e-6 absolute on values in [0, 1]."""
    jdemod = pytest.importorskip("tempest_tpu.ops.demod")
    rng = np.random.default_rng(3)
    z = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    ref = np.asarray(jdemod.invert_am_demod(z))
    got = tp.invert_am_demod(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
