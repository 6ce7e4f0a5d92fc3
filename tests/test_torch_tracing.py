"""The port's spans and counters (``tempest_tpu_torch.utils.profiling``) at
its layer boundaries, on the CPU: nothing recorded and no profiler range
opened while the tracer is off; the nesting, parents, request ids, self
times, byte counts and launch counts while it is on; a ``torch.profiler``
session turning it on by itself; where a ring take's time lands; the
runtimes' block spans; and the JAX package's ring cases on the port's ring,
which records its spans inside ``put`` and ``take``.

Shapes: 640x480 @ 60 Hz at 2 Msps, 60x80 screens, blocks of 0.25 s.  The
kernels' launch counts are checked here through their launch sites with a
library that launches nothing (the kernels have no CPU mode), and on the
card by the ``cuda`` test at the end.
"""

import threading
import time

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch import _build
from tempest_tpu_torch.ops import align_kernel, resample_kernel, sync_kernel
from tempest_tpu_torch.ops import scan as pscan
from tempest_tpu_torch.parallel.mesh import make_mesh
from tempest_tpu_torch.pipeline.offline import (
    ReconstructionConfig,
    auto_reconstruct,
    combined_reconstruct,
    make_batched_reconstruct_fn,
    make_reconstruct_fn,
)
from tempest_tpu_torch.runtime.mesh_stream import MeshStreamingRuntime
from tempest_tpu_torch.runtime.ring import RingBuffer
from tempest_tpu_torch.runtime.sources import SyntheticSource
from tempest_tpu_torch.runtime.stream import StreamingRuntime
from tempest_tpu_torch.utils import profiling, roofline

MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 2e6
SHAPE = (60, 80)
BLOCK = int(FS * 0.25)
WIDE_FS, WIDE_BW = 8e6, 2e6
STEP_SPANS = {"step", "step.cuts", "step.upload_cuts", "step.launch"}


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _no_ranges(monkeypatch):
    """Make opening a profiler range raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse, raising=False)


def _config(n_frames=6, **kw):
    return ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=n_frames, render_size=SHAPE,
        input_format="iq_interleaved", carry_phase=True, subsample_align=True,
        align_subpixel=True, resampler="mxu3", **kw)


def _words(n_complex, seed=3):
    iq = tp.generate_iq(MODE, FS, n_complex, snr_db=20.0, seed=seed).iq
    words = np.stack([iq.real, iq.imag], axis=1).reshape(-1) * 8000.0
    return torch.from_numpy(words.astype(np.int16))


def _step_once():
    config = _config()
    step = make_reconstruct_fn(config, "cpu")
    words = _words(config.block_samples)
    return step(words, torch.zeros(SHAPE), 0.1, 1234.5), config


def _batched_once():
    config = _config()
    step = make_batched_reconstruct_fn(config, device="cpu")
    words = torch.stack([_words(config.block_samples, seed=s) for s in (3, 4)])
    return step(words, torch.zeros((2, *SHAPE)), 0.1, [10.0, 20.5])


def _capture():
    return np.asarray(tp.generate_iq(MODE, FS, int(FS * 0.3), snr_db=20.0, seed=5).iq,
                      np.complex64)


def _wide_capture():
    """Two harmonics of one screen, the weaker inverted, in 0.3 s at 8 Msps:
    the smallest capture in which the band scan finds both."""
    cap = tp.generate_iq_harmonics(MODE, WIDE_FS, int(WIDE_FS * 0.3), [-2.4e6, 1.8e6],
                                   amplitudes=[1.0, 0.7], depths=[0.8, -0.8], snr_db=6.0,
                                   seed=5)
    return np.asarray(cap.iq, np.complex64)


def _blocks(count, seed=12):
    iq = tp.generate_iq(MODE, FS, count * BLOCK, snr_db=20.0, seed=seed).iq
    return np.asarray(iq, np.complex64).reshape(count, BLOCK)


def _runtime(mesh=False):
    source = SyntheticSource(MODE, FS, BLOCK)
    over = {"render_size": SHAPE}
    if mesh:
        return MeshStreamingRuntime(source, MODE, make_mesh(4, devices=["cpu"] * 4),
                                    config_overrides=over)
    return StreamingRuntime(source, MODE, device="cpu", config_overrides=over)


def _stream(rt, blocks, sink=None):
    """Every block through ``rt``: the mesh's lookahead holds the last one
    back."""
    for b in blocks:
        rt.ring.put(b)
    lookahead = isinstance(rt, MeshStreamingRuntime)
    return rt.process_blocks(len(blocks) - lookahead, sink=sink)


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


# ----------------------------------------------------------------- off
@pytest.mark.parametrize("path", ["step", "batched_step", "ring", "auto_reconstruct",
                                  "combined_reconstruct", "runtime", "mesh_runtime"])
def test_off_records_nothing_and_opens_no_range(path, monkeypatch):
    _no_ranges(monkeypatch)
    assert not profiling.enabled()
    if path == "step":
        _step_once()
    elif path == "batched_step":
        _batched_once()
    elif path == "ring":
        ring = RingBuffer(4, depth=2)
        ring.put(np.ones(4, np.complex64))
        assert ring.take()[0] == 1
    elif path == "auto_reconstruct":
        auto_reconstruct(_capture(), FS, device="cpu")
    elif path == "combined_reconstruct":
        combined_reconstruct(_wide_capture(), WIDE_FS, None, chan_bw=WIDE_BW, alpha=0.7,
                             device="cpu")
    else:
        _stream(_runtime(mesh=path == "mesh_runtime"), _blocks(2), sink=lambda img, info: None)
    assert profiling.records() == []
    assert profiling.summary() == {"spans": {}, "counters": {}}
    assert profiling.metrics().counters == {}


def test_off_span_is_one_shared_no_op():
    a, b = profiling.annotate("x"), profiling.annotate("y", request=3)
    assert a is b
    with a as span:
        span.request = 7
        assert span.request is None
    profiling.count("n", 5)
    assert profiling.records() == [] and profiling.summary()["counters"] == {}


# ------------------------------------------------------------------ on
def test_enable_gives_nesting_parents_requests_and_self_times():
    profiling.enable()
    with profiling.annotate("outer", request="r1"):
        time.sleep(0.02)
        with profiling.annotate("inner"):
            time.sleep(0.03)
            with profiling.annotate("leaf", request="r2"):
                time.sleep(0.01)
        with profiling.annotate("inner"):
            pass
    recs = _by_name(profiling.records())
    (outer,), inners, (leaf,) = recs["outer"], recs["inner"], recs["leaf"]
    assert outer.parent == -1 and all(r.parent == outer.id for r in inners)
    assert leaf.parent == inners[0].id
    assert outer.request == "r1" and all(r.request == "r1" for r in inners)
    assert leaf.request == "r2"
    assert {r.thread for r in profiling.records()} == {threading.get_ident()}
    spans = profiling.summary()["spans"]
    assert spans["inner"]["count"] == 2 and spans["outer"]["count"] == 1
    children = sum(r.t1 - r.t0 for r in inners) * 1e-9
    assert spans["outer"]["self_s"] == pytest.approx(
        (outer.t1 - outer.t0) * 1e-9 - children, abs=1e-9)
    assert spans["outer"]["self_s"] >= 0.02
    assert spans["inner"]["total_s"] == pytest.approx(
        spans["inner"]["self_s"] + spans["leaf"]["total_s"], abs=1e-9)
    assert spans["leaf"]["self_s"] == spans["leaf"]["total_s"] >= 0.01
    profiling.disable()
    with profiling.annotate("after"):
        pass
    assert "after" not in profiling.summary()["spans"]


def test_step_spans_nest_under_the_step():
    profiling.enable()
    (_, frames, _, _), config = _step_once()
    recs = _by_name(profiling.records())
    assert STEP_SPANS <= set(recs)
    (step,) = recs["step"]
    for name in STEP_SPANS - {"step"}:
        assert [r.parent for r in recs[name]] == [step.id], name
    counters = profiling.summary()["counters"]
    # The exact cuts: int32 starts and float32 residuals, one of each a frame.
    assert counters["step.upload_cuts.bytes"] == 8 * config.n_frames


def test_batched_step_spans():
    profiling.enable()
    _batched_once()
    recs = _by_name(profiling.records())
    (step,) = recs["step"]
    assert [r.parent for r in recs["step.cuts"]] == [step.id]
    assert [r.parent for r in recs["step.upload_cuts"]] == [step.id]
    # The streams' layout before the cuts' upload, the chain after it: one
    # ``step.launch`` a step, as in the single-stream step.
    assert [r.parent for r in recs["step.layout"]] == [step.id]
    assert [r.parent for r in recs["step.launch"]] == [step.id]
    assert profiling.summary()["counters"]["step.upload_cuts.bytes"] == 2 * 8 * 6


def test_auto_reconstruct_stages_and_bytes():
    profiling.enable()
    cap = _capture()
    _, recon = auto_reconstruct(cap, FS, device="cpu")
    _, recon2 = auto_reconstruct(cap, FS, device="cpu")
    recs = _by_name(profiling.records())
    autos = recs["offline.auto"]
    assert len(autos) == 2 and autos[1].request == autos[0].request + 1
    for name in ("offline.upload", "offline.stage1", "offline.stage2", "offline.readback",
                 "offline.restore"):
        assert [r.parent for r in recs[name]] == [a.id for a in autos], name
        assert [r.request for r in recs[name]] == [a.request for a in autos], name
    stage2 = {r.id for r in recs["offline.stage2"]}
    assert {r.parent for r in recs["step"]} == stage2
    counters = profiling.summary()["counters"]
    assert counters["offline.upload.bytes"] == 2 * cap.nbytes
    readback = sum(a.nbytes for a in (recon.image_raw, recon.frames, recon.sync, recon.score))
    assert counters["offline.readback.bytes"] == 2 * readback
    assert counters["offline.readback.pinned.bytes"] == 0  # the CPU: views, no pinned copy


def test_combined_reconstruct_stages_and_counters():
    """One ``offline.combined`` a call, its stages nested in it in order,
    the band scan's and the fusion's parts in theirs, and the counters of
    the geometry, the draws and the bytes."""
    pscan._measured_floor.cache_clear()  # the first call measures the floor
    profiling.enable()
    cap = _wide_capture()
    out = [combined_reconstruct(cap, WIDE_FS, None, chan_bw=WIDE_BW, alpha=0.7, device="cpu")
           for _ in range(2)]
    recs = _by_name(profiling.records())
    calls = recs["offline.combined"]
    assert len(calls) == 2 and calls[1].request == calls[0].request + 1
    assert all(r.parent == -1 for r in calls)
    call_ids = [c.id for c in calls]
    for name in ("offline.upload", "scan.band", "offline.combine", "offline.stage1",
                 "offline.stage2", "offline.readback", "offline.restore"):
        assert [r.parent for r in recs[name]] == call_ids, name
        assert [r.request for r in recs[name]] == [c.request for c in calls], name
    scans = [r.id for r in recs["scan.band"]]
    for name in ("scan.score", "scan.floor"):
        assert [r.parent for r in recs[name]] == scans, name
    combines = [r.id for r in recs["offline.combine"]]
    assert [r.parent for r in recs["combine.channels"]] == combines
    # The capture's FFT and the channels: once in the scan, once for the fusion.
    channelised = sorted(scans + [r.id for r in recs["combine.channels"]])
    for name in ("scan.spectrum", "scan.channels"):
        assert sorted(r.parent for r in recs[name]) == channelised, name
    assert [r.parent for r in recs["combine.fuse"]] == [c for c in combines for _ in (0, 1)]
    stage2 = {r.id for r in recs["offline.stage2"]}
    assert {r.parent for r in recs["step"]} == stage2
    order = ["offline.upload", "scan.band", "offline.combine", "offline.stage1",
             "offline.stage2", "offline.readback", "offline.restore"]
    firsts = [recs[name][0].t0 for name in order]
    assert firsts == sorted(firsts)
    n_fft, m_chan, fs_chan = pscan._channel_geometry(len(cap), WIDE_FS, WIDE_BW)
    centers = pscan.scan_centers(WIDE_FS, WIDE_BW / 2, WIDE_BW / 2)
    comb = out[0][2]
    counters = profiling.summary()["counters"]
    assert fs_chan == comb.fs_channel
    assert counters["scan.channels"] == 2 * len(centers)
    assert counters["scan.fft.points"] == 2 * n_fft
    # The floor's normals are drawn once for the geometry; the second call reuses the floor.
    assert counters["scan.floor.draws"] == 4 * 2 * m_chan
    assert counters["combine.carriers"] == 2 * len(comb.centers_hz)
    assert counters["offline.combine.envelope.bytes"] == 2 * comb.envelope.nbytes
    # Uploaded: the first n_fft samples, all that the channeliser reads.
    assert n_fft < len(cap)
    assert counters["offline.upload.bytes"] == 2 * cap[:n_fft].nbytes
    readback = sum(a.nbytes for a in (out[0][1].image_raw, out[0][1].frames, out[0][1].sync,
                                      out[0][1].score))
    assert counters["offline.readback.bytes"] == 2 * readback


@pytest.mark.parametrize("ranges", ["fast", "record_function"])
def test_profiler_session_turns_the_tracer_on(ranges, monkeypatch):
    if ranges == "record_function":  # a torch without the fast record function
        monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast", raising=False)
    assert not profiling.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        _step_once()
    assert not profiling.enabled()
    assert STEP_SPANS <= {r.name for r in profiling.records()}
    assert STEP_SPANS <= {e.name for e in prof.events()}
    assert profiling.summary()["counters"]["step.upload_cuts.bytes"] == 48


def test_trace_session_records_the_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        _step_once()
    assert STEP_SPANS <= {r.name for r in profiling.records()}
    assert (tmp_path / "trace_0.json").is_file()


def test_summary_window_quantiles_and_counters():
    profiling.enable()
    for i in range(5):
        with profiling.annotate("s"):
            time.sleep(0.002 * (i + 1))
        profiling.count("c", i)
    recs = profiling.records()
    times = sorted((r.t1 - r.t0) * 1e-9 for r in recs)
    s = profiling.summary()["spans"]["s"]
    assert s["count"] == 5 and s["p50_s"] == times[2]
    assert s["p95_s"] == pytest.approx(times[3] + 0.8 * (times[4] - times[3]))
    assert profiling.summary()["counters"] == {"c": 10}
    assert profiling.metrics().counters == {"c": 10.0}
    since, until = recs[1].t0, recs[3].t1
    assert [r.t0 for r in profiling.records(since, until)] == [r.t0 for r in recs[1:4]]
    assert profiling.summary(since, until)["spans"]["s"]["count"] == 3
    assert profiling.summary(since, until)["counters"] == {"c": 1 + 2}


def test_buffer_keeps_the_newest_records():
    profiling.enable()
    for _ in range(profiling.BUFFER + 10):
        with profiling.annotate("x"):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.BUFFER
    assert recs[-1].id - recs[0].id == profiling.BUFFER - 1


def test_threads_keep_their_own_stacks():
    profiling.enable()
    ready = threading.Barrier(2, timeout=10)

    def work(tag):
        with profiling.annotate("t", request=tag):
            ready.wait()
            with profiling.annotate("t.child"):
                pass

    threads = [threading.Thread(target=work, args=(k,)) for k in ("a", "b")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    recs = _by_name(profiling.records())
    parents = {r.id: r for r in recs["t"]}
    for child in recs["t.child"]:
        parent = parents[child.parent]
        assert child.thread == parent.thread and child.request == parent.request


# ---------------------------------------------------------------- ring
def test_take_time_of_a_held_producer_lands_in_the_wait():
    profiling.enable()
    ring = RingBuffer(1 << 10, depth=4)

    def producer():
        time.sleep(0.2)
        ring.put(np.ones(1 << 10, np.complex64))

    th = threading.Thread(target=producer)
    th.start()
    assert ring.take(timeout=10.0) is not None
    th.join(timeout=10)
    assert not th.is_alive()
    spans = profiling.summary()["spans"]
    assert spans["ring.take.wait"]["total_s"] >= 0.15
    assert spans["ring.take.copy"]["total_s"] < 0.05
    (take,) = _by_name(profiling.records())["ring.take"]
    assert take.request == ring.last_seq == 0


def test_take_time_of_a_full_ring_lands_in_the_copy():
    n = 1 << 22                       # 32 MB a block
    ring = RingBuffer(n, depth=2)
    block = np.ones(n, np.complex64)
    ring.put(block)
    ring.put(block)
    profiling.enable()
    out = np.empty(n, np.complex64)
    assert ring.take(out) is out
    spans = profiling.summary()["spans"]
    assert spans["ring.take.copy"]["total_s"] > spans["ring.take.wait"]["total_s"]
    recs = _by_name(profiling.records())
    (take,) = recs["ring.take"]
    assert {r.parent for r in recs["ring.take.wait"] + recs["ring.take.copy"]} == {take.id}


def test_put_spans_on_the_producer_thread():
    ring = RingBuffer(4, depth=2)
    profiling.enable()
    th = threading.Thread(target=ring.put, args=(np.ones(4, np.complex64),))
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    recs = _by_name(profiling.records())
    (put,) = recs["ring.put"]
    assert put.thread == th.ident
    assert [r.parent for r in recs["ring.put.wait"] + recs["ring.put.copy"]] == [put.id] * 2


# The JAX package's ring cases (``tests/test_runtime.py``) on the port's
# ring, with the tracer off and on.
@pytest.fixture(params=["off", "on"])
def traced(request):
    if request.param == "on":
        profiling.enable()
    return request.param


def test_port_ring_put_take_order(traced):
    ring = RingBuffer(4, depth=3)
    for i in range(3):
        ring.put(np.full(4, i, np.complex64))
    for i in range(3):
        assert ring.take()[0] == i
    assert ring.overflows == 0


def test_port_ring_overwrites_oldest_and_tracks_sequence(traced):
    ring = RingBuffer(2, depth=2)
    assert ring.last_seq == -1 and ring.produced == 0
    for i in range(5):
        ring.put(np.full(2, i, np.complex64))
    assert ring.overflows == 3 and ring.produced == 5
    assert ring.take()[0] == 3 and ring.last_seq == 3
    assert ring.take()[0] == 4 and ring.last_seq == 4


def test_port_ring_blocking_take_and_close(traced):
    ring = RingBuffer(2, depth=2)
    results = []
    th = threading.Thread(target=lambda: results.append(ring.take(timeout=5.0)))
    th.start()
    time.sleep(0.05)
    ring.put(np.ones(2, np.complex64))
    th.join(timeout=5.0)
    assert not th.is_alive() and results and results[0][0] == 1.0
    ring.close()
    assert ring.take(timeout=0.1) is None
    assert ring.take(timeout=0.0) is None


def test_port_ring_threaded_counts(traced):
    ring = RingBuffer(64, depth=8)
    n_blocks = 200

    def producer():
        b = np.zeros(64, np.complex64)
        for i in range(n_blocks):
            b[:] = i
            ring.put(b)
        ring.close()

    got = 0
    th = threading.Thread(target=producer)
    th.start()
    while ring.take(timeout=5.0) is not None:
        got += 1
    th.join(timeout=10)
    assert not th.is_alive()
    assert got + ring.overflows == n_blocks and ring.producer.blocks == n_blocks
    if traced == "on":
        spans = profiling.summary()["spans"]
        assert spans["ring.put"]["count"] == n_blocks and spans["ring.take"]["count"] == got + 1


def test_port_ring_released_after_a_closed_take(traced):
    """A take that finds the ring closed leaves the lock free."""
    ring = RingBuffer(2, depth=2)
    ring.close()
    assert ring.take(timeout=0.0) is None
    assert ring._lock.acquire(timeout=1.0)
    ring._lock.release()


# ------------------------------------------------------------- runtime
def test_runtime_records_one_block_span_a_block():
    rt = _runtime()
    blocks = _blocks(3)
    for b in blocks:
        rt.ring.put(b)
    profiling.enable()
    images = []
    rt.process_blocks(3, sink=lambda img, info: images.append((img, info)))
    recs = _by_name(profiling.records())
    block_spans = recs["runtime.block"]
    assert [r.request for r in block_spans] == [0, 1, 2]
    for name in ("ring.take", "runtime.upload", "runtime.step", "runtime.sink"):
        assert [r.parent for r in recs[name]] == [b.id for b in block_spans], name
        assert [r.request for r in recs[name]] == [0, 1, 2], name
    steps = {r.id for r in recs["runtime.step"]}
    assert [r.parent in steps for r in recs["step"]] == [True] * 3
    counters = profiling.summary()["counters"]
    # The chain's window of each block goes up as float32 words.
    assert counters["runtime.upload.bytes"] == 3 * rt._upload_samples * 8
    img, info = images[0]
    assert counters["runtime.sink.bytes"] == 3 * (img.nbytes + info["sync"].nbytes
                                                 + info["score"].nbytes)


def test_runtime_sink_bytes_of_every_frame():
    rt = _runtime()
    profiling.enable()
    frames = []
    for b in _blocks(1):
        rt.ring.put(b)
    rt.process_blocks(1, sink=lambda img, info: frames.append((img, info)),
                      emit_every_frame=True)
    info = frames[0][1]
    assert profiling.summary()["counters"]["runtime.sink.bytes"] == (
        sum(f.nbytes for f, _ in frames) + info["sync"].nbytes + info["score"].nbytes)


def test_mesh_runtime_records_one_block_span_a_block():
    rt = _runtime(mesh=True)
    blocks = _blocks(3)
    for b in blocks:
        rt.ring.put(b)
    profiling.enable()
    rt.process_blocks(2, sink=lambda img, info: None)
    recs = _by_name(profiling.records())
    block_spans = recs["runtime.block"]
    # The first block only primes the lookahead; each next one dispatches
    # the block before it, under that block's sequence.
    assert [r.request for r in block_spans] == [None, 0, 1]
    assert [r.request for r in recs["ring.take"]] == [0, 1, 2]
    assert [r.parent for r in recs["ring.take"]] == [b.id for b in block_spans]
    dispatches = recs["runtime.dispatch"]
    assert [r.parent for r in dispatches] == [b.id for b in block_spans[1:]]
    assert [r.request for r in dispatches] == [0, 1]
    for name, per in (("mesh.place", 1), ("mesh.halo", 1), ("mesh.shard", 4),
                      ("mesh.combine", 1)):
        assert [r.parent for r in recs[name]] == [d.id for d in dispatches for _ in range(per)]
    shards = {r.id: r for r in recs["mesh.shard"]}
    assert sorted(shards[r.parent].request for r in recs["step"]) == [0] * 4 + [1] * 4
    assert [r.parent for r in recs["runtime.sink"]] == [b.id for b in block_spans[1:]]
    counters = profiling.summary()["counters"]
    # Each span's first window of float32 words (the span where it is
    # shorter) goes to its shard.
    window = min(rt._step.shard_samples, rt.config.block_samples)
    assert counters["mesh.place.bytes"] == 2 * rt._step.n_shards * window * 8
    assert "runtime.upload.bytes" not in counters


def test_health_carries_the_summary_while_on():
    rt = _runtime()
    assert rt.health()["trace"] is None
    profiling.enable()
    _stream(rt, _blocks(1))
    trace = rt.health()["trace"]
    assert trace["spans"]["runtime.block"]["count"] == 1
    assert trace["counters"]["runtime.upload.bytes"] == rt._upload_samples * 8


# ------------------------------------------------------------- launches
class _NoLaunch:
    """A kernels' library whose every entry returns success and launches
    nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def no_launch(monkeypatch):
    """The three kernels' launch sites on CPU tensors, behind the launch
    boundary, with a library that launches nothing (and K1's check of a CUDA
    source passed)."""
    monkeypatch.setattr(_build, "load_library", lambda name: _NoLaunch())
    monkeypatch.setattr(resample_kernel, "_check_launch", lambda src, n, starts: starts.shape[0])


def _resident_launches():
    """The launches of one step of the resident chain's shapes: K1 on int16
    words (bfloat16 rounding, exact cuts), K2 with pairs, K3 folding."""
    config = _config(36)
    n = config.block_samples
    words = torch.zeros(2 * n, dtype=torch.int16)
    starts = torch.arange(36, dtype=torch.int32) * int(config.samples_per_frame)
    resample_kernel._launch(words, n, resample_kernel.word_code(torch.int16, "am", True),
                            starts, int(config.samples_per_frame), MODE.height, MODE.width,
                            SHAPE, torch.zeros(36), 2)
    screens = torch.zeros((36, *SHAPE))
    s_y, s_x, _, _ = sync_kernel._launch(screens, 0.01, 0.05, 0, True, True, split=1)
    align_kernel._launch(screens, s_y, s_x, torch.zeros(SHAPE), 0.1, "linear", 1)


def test_launch_counters_of_a_resident_step(no_launch):
    _resident_launches()
    assert profiling.summary()["counters"] == {}
    profiling.enable()
    _resident_launches()
    assert profiling.summary()["counters"] == {"launches.k1": 1, "launches.k2": 2,
                                               "launches.k3": 1}


def test_failed_launch_counts_nothing(no_launch, monkeypatch):
    class Failing:
        def __getattr__(self, name):
            return lambda *args: 700

    monkeypatch.setattr(_build, "load_library", lambda name: Failing())
    profiling.enable()
    with pytest.raises(RuntimeError, match="k2 launch failed"):
        sync_kernel._launch(torch.zeros((4, *SHAPE)), 0.01, 0.05, 0, True, True, split=1)
    assert profiling.summary()["counters"] == {}


def test_one_launch_is_one_record_for_every_reader():
    """Through the boundary, one launch is seen once by the tracer, by a
    running roofline count and by the launch reader; a failed one raises,
    naming its kernel, and records nothing; and the wrappers given CPU
    tensors run their plain versions and record nothing."""
    calls = []

    def launcher(*args):
        calls.append(args)
        return 0

    cpu = torch.device("cpu")
    profiling.enable()
    with _build.count_launches() as seen:
        report = roofline.roofline(_build.launch, "k3", launcher, cpu, ((100, 10),),
                                   ("linear", True), 7, 8, after=(9,))
        with pytest.raises(RuntimeError, match="words_max launch failed with cudaError_t 700"):
            _build.launch("words_max", lambda *args: 700, cpu, ((4, 1),), None)
    assert calls == [(7, 8, None, 9)]
    assert profiling.summary()["counters"] == {"launches.k3": 1}
    assert (report.kernel_launches, report.kernel_bytes, report.kernel_flops) == (1, 100, 10)
    assert seen == {"k3": 1, ("k3", "linear", True): 1}

    words = torch.zeros(2 * 4096, dtype=torch.int16)
    starts = torch.tensor([0], dtype=torch.int32)
    with _build.count_launches() as seen:
        screens = resample_kernel.frames_to_screens_from_words(words, starts, 4000, 50, 100, SHAPE,
                                                               invert=True)
        resample_kernel.fm_int16_words(words)
        s_y, s_x, _ = sync_kernel.blanking_sync(screens, subpixel=True)
        align_kernel.align_fold(screens, s_y, s_x, torch.zeros(SHAPE), 0.1)
    assert not seen and profiling.summary()["counters"] == {"launches.k3": 1}


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_resident_step_counts_its_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    config = _config(36)
    step = make_reconstruct_fn(config, dev)
    words = _words(config.block_samples).to(dev)
    ema = torch.zeros(SHAPE, device=dev)
    step(words, ema, 0.1, 0.0)
    torch.cuda.synchronize()
    profiling.enable()
    step(words, ema, 0.1, 1234.5)
    torch.cuda.synchronize()
    summary = profiling.summary()
    # The second step of its geometry: its plan reused, its cuts up through
    # the pinned slots.
    assert summary["counters"] == {"step.upload_cuts.bytes": 8 * 36,
                                   "step.upload_cuts.pinned.bytes": 8 * 36,
                                   "step.plan.reuses": 1, "launches.k1": 1,
                                   "launches.k2": 2, "launches.k3": 1}
    assert STEP_SPANS <= set(summary["spans"])
