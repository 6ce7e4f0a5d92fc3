"""The port's live web operator view: drive a real session over HTTP.

The cases of ``tests/test_webview.py`` on ``tempest_tpu_torch``'s
``StreamingRuntime`` and ``OperatorConsole`` with ``device="cpu"``: the same
routes, the same JSON of ``/status.json``, the same ``corr_click``.  The view
is the JAX package's module but for three docstring lines
(``tests/test_torch_copies.py``), so what is under test here is that it
composes with the port's runtime and console, and with its mesh runtime on
eight CPU shards (``tests/test_webview.py:165``).  No numeric tolerance: the checks are on
modes, names, PNG headers and log lines, except the clicked refresh, held to
0.05 Hz of the detected one as in the JAX test (the click snaps to the local
maximum of a curve sampled on the lag grid).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch

import tempest_tpu_torch as tt
from tempest_tpu_torch.runtime.sources import SyntheticSource
from tempest_tpu_torch.runtime.stream import StreamingRuntime
from tempest_tpu_torch.runtime.webview import WebOperatorView

MODE = tt.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 4e6


def _get(url: str, timeout: float = 10.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _post(url: str, body: str, timeout: float = 10.0) -> bytes:
    req = urllib.request.Request(url, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _poll(pred, deadline_s: float = 90.0, every_s: float = 0.1):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        v = pred()
        if v:
            return v
        time.sleep(every_s)
    raise TimeoutError("condition not reached")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def session():
    src = SyntheticSource(MODE, FS, int(FS * 0.1), snr_db=25.0, seed=3)
    rt = StreamingRuntime(src, MODE, alpha=0.5, device="cpu")
    web = WebOperatorView(rt, port=0)  # ephemeral port
    base = f"http://{web.host}:{web.port}"
    rt.start()
    t = threading.Thread(target=web.run, daemon=True, name="web-session")
    t.start()
    try:
        yield rt, web, base
    finally:
        try:
            _post(f"{base}/command", "quit")
        except OSError:
            pass
        t.join(timeout=30)
        rt.stop()


def test_web_session_full_surface(session):
    rt, web, base = session

    # Operator page serves.
    page = _get(f"{base}/").decode()
    assert "operator view" in page and "/frame.png" in page

    # The live frame appears once the first block is processed: a real PNG
    # of the render size, not the placeholder.
    def real_frame():
        png = _get(f"{base}/frame.png")
        return png if (png.startswith(b"\x89PNG") and len(png) > 2000) else None

    frame0 = _poll(real_frame)
    h, w = rt.config.render_size
    import struct
    assert struct.unpack(">II", frame0[16:24]) == (w, h)  # IHDR dims

    # Status reflects the running mode (VideoMode holds TOTAL raster
    # dimensions incl. blanking: 800x525 for "640x480 @ 60Hz").
    s = json.loads(_get(f"{base}/status.json"))
    assert s["mode"]["width"] == MODE.width
    assert s["mode"]["height"] == MODE.height
    assert s["running"] is True
    assert f"{MODE.width}x{MODE.height}" in s["line"]

    # POST `+ 1`: the reference's +1-line button — the mode must hot-swap.
    _post(f"{base}/command", "+ 1")
    _poll(lambda: rt.mode.height == MODE.height + 1)
    _poll(lambda: f"lines = {MODE.height + 1}"
          in _get(f"{base}/log").decode())

    # POST `correlate`: evidence panels appear and the mode snaps back.
    _post(f"{base}/command", "correlate")
    _poll(lambda: rt.last_evidence is not None)
    _poll(lambda: rt.mode.height == MODE.height)
    corr = _poll(lambda: (lambda p: p if len(p) > 2000 else None)(
        _get(f"{base}/corr.png")))
    assert corr.startswith(b"\x89PNG")

    # Pause/resume through the same surface.
    _post(f"{base}/command", "pause")
    _poll(lambda: json.loads(_get(f"{base}/status.json"))["running"] is False)
    _post(f"{base}/command", "start")
    _poll(lambda: json.loads(_get(f"{base}/status.json"))["running"] is True)


def test_web_corr_click_adopts_peak(session):
    """Clicking a peak on either correlation panel adopts it
    (GUI.jl:450-459 refresh panel, GUI.jl:512-523 line panel).  A browser
    click arrives as fractional image coordinates on POST /corr_click and
    routes through the same console dispatch as typed commands."""
    rt, web, base = session

    # Clicking before any evidence is a polite no-op, not an error.
    msg = _post(f"{base}/corr_click",
                json.dumps({"x": 0.5, "y": 0.8})).decode()
    assert "no evidence" in msg

    _post(f"{base}/command", "correlate")
    _poll(lambda: rt.last_evidence is not None)
    ev = rt.last_evidence

    # Rate panel (top half): a click at the detected peak's x position
    # snaps to the local maximum and queues `fv` at the detected refresh.
    msg = _post(f"{base}/corr_click",
                json.dumps({"x": ev.rate_mark(), "y": 0.2})).decode()
    assert "fv" in msg, msg
    f_queued = float(msg.split("fv ")[1].split(" Hz")[0])
    assert abs(f_queued - ev.refresh_hz) < 0.05, (f_queued, ev.refresh_hz)
    _poll(lambda: "fv = " in _get(f"{base}/log").decode())

    # Line panel (bottom half): a click at ranked peak #k's lag position
    # picks the NEAREST ranked peak and dispatches `pick k`.
    peaks = np.asarray(ev.line_peaks, np.float64)
    lags = np.asarray(ev.line_lags, np.float64)
    k = min(1, len(peaks) - 1)
    xf = float((peaks[k, 0] - lags[0]) / (lags[-1] - lags[0]))
    msg = _post(f"{base}/corr_click",
                json.dumps({"x": xf, "y": 0.8})).decode()
    assert f"peak #{k}" in msg, msg
    _poll(lambda: f"picked peak {k}" in _get(f"{base}/log").decode())

    # Malformed clicks are a 400, not a crash.
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(f"{base}/corr_click", "not json")
    assert exc.value.code == 400


def test_web_quit_ends_session(session):
    rt, web, base = session
    _poll(lambda: web.console.blocks_done >= 1)
    _post(f"{base}/command", "quit")
    _poll(lambda: not web.console.alive)


def test_web_view_on_mesh_runtime():
    """The web operator surface drives the MESH runtime unchanged: live
    frame, status with the mesh's health, a command dispatch."""
    from tempest_tpu_torch.parallel.mesh import make_mesh
    from tempest_tpu_torch.runtime.mesh_stream import MeshStreamingRuntime

    S = int(FS * 0.05)
    src = SyntheticSource(MODE, FS, 8 * S, snr_db=25.0, seed=3)
    rt = MeshStreamingRuntime(src, MODE, make_mesh(devices=["cpu"] * 8), alpha=0.5,
                              config_overrides={"render_size": (150, 200)})
    web = WebOperatorView(rt, port=0)
    base = f"http://{web.host}:{web.port}"
    rt.start()
    t = threading.Thread(target=web.run, daemon=True, name="web-mesh")
    t.start()
    try:
        _poll(lambda: (lambda p: p if len(p) > 2000 else None)(_get(f"{base}/frame.png")))
        s = json.loads(_get(f"{base}/status.json"))
        assert s["health"]["mesh"]["n_shards"] == 8
        assert s["health"]["mesh"]["dispatched_total"] >= 1
        _post(f"{base}/command", "+ 1")
        _poll(lambda: rt.mode.height == MODE.height + 1)
    finally:
        try:
            _post(f"{base}/command", "quit")
        except OSError:
            pass
        t.join(timeout=30)
        rt.stop()


def test_web_unknown_paths_404(session):
    _, _, base = session
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(f"{base}/nope")
    assert exc.value.code == 404
