"""Live web operator view: watch and drive a running stream in a browser.

The reference's defining surface is ONE live window — the reconstructed
image as a heatmap, two clickable correlation panels, and a control column,
all updating together (``GUI.jl:296-356``,
``ScreenRenderer.jl:93-148``).  This module is that surface for headless
GPU hosts, with zero dependencies beyond the standard library: a localhost
HTTP server on the streaming runtime serving

* ``/``             the operator page (live image + correlation panels +
                    status + command box + console log, JS-refreshed)
* ``/frame.png``    the latest EMA reconstruction (own PNG encoder,
                    ``render/screen.png_bytes``)
* ``/corr.png``     the two correlation-evidence panels from the last
                    ``correlate`` (``render/plots.render_line_plot``)
* ``/status.json``  mode / throughput / health snapshot
* ``/log``          recent console output
* ``POST /command`` one operator command line, dispatched at the next block
                    boundary through the same :class:`OperatorConsole`
                    surface the terminal uses (fv/lines/±N/alpha/correlate/
                    pick/scan/record/... — every reference widget).
* ``POST /corr_click`` a click on the correlation panels as fractional
                    image coordinates — the reference's click-a-peak
                    interaction (``GUI.jl:450-459`` refresh panel adopts
                    the clicked rate, ``GUI.jl:512-523`` line panel adopts
                    the nearest ranked peak via ``delay2yt``), routed
                    through the same console dispatch.

Design: the HTTP server runs on daemon threads and only *reads* published
state (latest frame, evidence, log) under a lock or enqueues command lines;
the stream itself is driven by the one consumer loop (``run()`` =
``OperatorConsole.run`` fed by the web command queue).  No GUI toolkit, no
websocket dependency — a ~500 ms JS poll is plenty for a 10 FPS-class live
view (the reference itself throttles to ≤10 FPS, ``GUI.jl:179``).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .console import OperatorConsole
from .stream import StreamingRuntime

__all__ = ["WebOperatorView"]


_PAGE = """<!doctype html><html><head><title>tempest_tpu operator</title>
<style>
body{font-family:monospace;background:#14151a;color:#d6d6d6;margin:16px}
h3{margin:4px 0} h4{margin:10px 0 4px 0;color:#9ab}
img{image-rendering:pixelated;border:1px solid #444;background:#000}
#frame{max-width:820px;width:100%}
#corr{max-width:820px;width:100%}
#status{color:#8c8;padding:4px 0;white-space:pre-wrap}
#log{white-space:pre-wrap;height:180px;overflow-y:auto;background:#000;
     padding:6px;border:1px solid #444;max-width:808px;font-size:12px}
input{width:70%;background:#000;color:#9f9;border:1px solid #444;
      padding:5px;font-family:monospace}
button{background:#233;color:#d6d6d6;border:1px solid #444;padding:5px 12px}
</style></head><body>
<h3>tempest_tpu &mdash; live operator view</h3>
<div id=status>connecting&hellip;</div>
<img id=frame src="/frame.png" alt="reconstruction">
<h4>correlation evidence (run <code>correlate</code>; click a peak to
adopt it &mdash; top: refresh, bottom: line period)</h4>
<img id=corr src="/corr.png" alt="no evidence yet" style="cursor:crosshair">
<h4>command (<code>help</code> lists all)</h4>
<form id=f><input id=cmd autocomplete=off autofocus
 placeholder="e.g.  correlate | + 1 | alpha 0.6 | fidelity on | quit">
<button>send</button></form>
<div id=log></div>
<script>
async function tick(){
 try{
  document.getElementById('frame').src='/frame.png?t='+Date.now();
  document.getElementById('corr').src='/corr.png?t='+Date.now();
  const s=await (await fetch('/status.json')).json();
  document.getElementById('status').textContent=s.line;
  const log=document.getElementById('log');
  log.textContent=await (await fetch('/log')).text();
  log.scrollTop=log.scrollHeight;
 }catch(e){}
}
setInterval(tick,500); tick();
document.getElementById('f').addEventListener('submit',async (e)=>{
 e.preventDefault();
 const c=document.getElementById('cmd');
 if(c.value.trim()) await fetch('/command',{method:'POST',body:c.value});
 c.value='';
});
document.getElementById('corr').addEventListener('click',async (e)=>{
 const r=e.currentTarget.getBoundingClientRect();
 await fetch('/corr_click',{method:'POST',body:JSON.stringify(
  {x:(e.clientX-r.left)/r.width,y:(e.clientY-r.top)/r.height})});
});
</script></body></html>"""

# Correlation-panel raster geometry, shared by corr_png (drawing) and
# corr_click (inverse mapping): two PANEL_H-row line plots with PAD-px
# insets (render_line_plot's margin) stacked around a SEP-row separator.
_PANEL_W, _PANEL_H, _SEP, _PAD = 800, 200, 6, 8

# 1x1 dark-grey PNG placeholder served before the first frame / evidence.
_PLACEHOLDER = None


def _placeholder_png() -> bytes:
    global _PLACEHOLDER
    if _PLACEHOLDER is None:
        from ..render.screen import png_bytes

        _PLACEHOLDER = png_bytes(np.full((2, 2), 0.08, np.float32))
    return _PLACEHOLDER


class _LogWriter:
    """File-like sink capturing console output lines for the /log endpoint
    (the console prints through it exactly as it would to stdout)."""

    def __init__(self, maxlen: int = 400) -> None:
        self.lines: deque[str] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._partial = ""

    def write(self, text: str) -> int:
        with self._lock:
            buf = self._partial + text
            *full, self._partial = buf.split("\n")
            self.lines.extend(full)
        return len(text)

    def flush(self) -> None:
        pass

    def tail(self) -> str:
        with self._lock:
            return "\n".join(self.lines)


class WebOperatorView:
    """Serve a :class:`StreamingRuntime` as a live localhost operator page.

    ``run()`` drives the stream on the calling thread (the consumer loop)
    while the HTTP server answers on daemon threads; browser-posted command
    lines dispatch between blocks through :class:`OperatorConsole` — the
    full reference-GUI control surface over plain HTTP.

    ``port=0`` binds an ephemeral port (tests); the bound port is exposed as
    ``self.port`` once constructed.  Binds loopback by default — the view is
    an operator surface, not a public service.
    """

    def __init__(
        self,
        runtime: StreamingRuntime,
        port: int = 8766,
        host: str = "127.0.0.1",
        crosshair: bool = False,
        extra_sink=None,
    ) -> None:
        self.rt = runtime
        self._q: queue.Queue[str] = queue.Queue()
        self._log = _LogWriter()
        self._lock = threading.Lock()
        self._frame: np.ndarray | None = None
        self._frame_png: bytes | None = None
        self._info: dict = {}
        self._ev_src = None          # evidence object the panel was built from
        self._corr_png: bytes | None = None
        self._extra_sink = extra_sink
        self.console = OperatorConsole(
            runtime, sink=self._sink, commands=self._commands(),
            out=self._log, crosshair=crosshair,
        )
        self._log.write(f"web operator view on http://{host}:{port}\n"
                        "type `help` in the command box for all commands\n")

        view = self

        class Handler(BaseHTTPRequestHandler):
            # Quiet server: per-request stderr logging would fight the
            # terminal renderer and test output.
            def log_message(self, fmt, *args):  # noqa: D401
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path == "/":
                    self._send(200, "text/html; charset=utf-8",
                               _PAGE.encode())
                elif path == "/frame.png":
                    self._send(200, "image/png", view.frame_png())
                elif path == "/corr.png":
                    self._send(200, "image/png", view.corr_png())
                elif path == "/status.json":
                    self._send(200, "application/json",
                               json.dumps(view.status()).encode())
                elif path == "/log":
                    self._send(200, "text/plain; charset=utf-8",
                               view._log.tail().encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                n = int(self.headers.get("Content-Length", "0") or 0)
                body = self.rfile.read(n)
                if path == "/command":
                    line = body.decode(errors="replace").strip()
                    if line:
                        view._q.put(line)
                    self._send(200, "text/plain", b"queued\n")
                elif path == "/corr_click":
                    try:
                        d = json.loads(body or b"{}")
                        msg = view.corr_click(float(d["x"]), float(d["y"]))
                    except (KeyError, TypeError, ValueError) as e:
                        self._send(400, "text/plain",
                                   f"bad click: {e}".encode())
                        return
                    view._log.write(msg + "\n")
                    self._send(200, "text/plain", msg.encode() + b"\n")
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="web-operator-http")
        self._server_thread.start()

    # -------------------------------------------------------------- plumbing
    def _commands(self):
        """Endless command stream for the scripted console: one queued line
        per block boundary, or a no-op when nothing is pending (the console
        keeps pacing on block processing; while paused, sleep instead of
        spinning)."""
        while True:
            try:
                yield self._q.get_nowait()
            except queue.Empty:
                if not self.console.running:
                    time.sleep(0.05)
                yield ""

    def _sink(self, img: np.ndarray, info: dict) -> None:
        with self._lock:
            self._frame = np.asarray(img)
            self._frame_png = None          # re-encode lazily on next GET
            self._info = dict(info)
        if self._extra_sink is not None:
            self._extra_sink(img, info)

    # ------------------------------------------------------------- endpoints
    def frame_png(self) -> bytes:
        with self._lock:
            if self._frame is None:
                return _placeholder_png()
            if self._frame_png is None:
                from ..render.screen import png_bytes

                self._frame_png = png_bytes(self._frame)
            return self._frame_png

    def corr_png(self) -> bytes:
        """The two correlation panels of the reference GUI (refresh-band
        zoom and line-period window, detected peaks marked), stacked into
        one image — rebuilt only when new evidence lands."""
        ev = self.rt.last_evidence
        if ev is None:
            return _placeholder_png()
        with self._lock:
            if ev is self._ev_src and self._corr_png is not None:
                return self._corr_png
        from ..render.plots import render_line_plot
        from ..render.screen import png_bytes

        top = render_line_plot(ev.gamma_rates, width=_PANEL_W,
                               height=_PANEL_H, marks=(ev.rate_mark(),))
        bottom = render_line_plot(ev.gamma_lines, width=_PANEL_W,
                                  height=_PANEL_H, marks=(ev.line_mark(),))
        sep = np.full((_SEP, _PANEL_W), 0.3, np.float32)
        png = png_bytes(np.concatenate([top, sep, bottom], axis=0))
        with self._lock:
            self._ev_src, self._corr_png = ev, png
        return png

    def corr_click(self, xf: float, yf: float) -> str:
        """Map a click on ``/corr.png`` (fractions of the image's displayed
        width/height) to an operator action and queue it for the next block
        boundary — the last reference-GUI interaction without an equivalent
        until now: ``GUI.jl:450-459`` (refresh panel → adopt the clicked
        rate) and ``GUI.jl:512-523`` (line panel → ``delay2yt`` the clicked
        peak).  Top half = refresh-band panel: the click snaps to the local
        maximum and queues ``fv``; bottom half = line-period panel: the
        click selects the NEAREST ranked peak and queues ``pick N`` (same
        recovery path as the console commands)."""
        ev = self.rt.last_evidence
        if ev is None:
            return "click ignored — no evidence, run `correlate` first"
        # Invert the panel raster geometry: the curve (and the marks)
        # occupy columns [PAD, W-PAD-1], so the data fraction is the
        # click's pixel column minus the inset — using the image fraction
        # raw would skew edge clicks by up to ~1% of the axis (enough to
        # pick a neighbouring ranked peak near the window edge).
        xf = float(np.clip(
            (float(xf) * _PANEL_W - _PAD) / (_PANEL_W - 2 * _PAD - 1),
            0.0, 1.0))
        # Panel split at the separator's midline (the top panel ends at
        # row PANEL_H of the 2·PANEL_H+SEP stack, not at half height).
        if yf * (2 * _PANEL_H + _SEP) < _PANEL_H + _SEP / 2:
            g = np.asarray(ev.gamma_rates)
            n = g.shape[0]
            i = int(round(xf * (n - 1)))
            w = max(n // 50, 2)               # snap window: ±2% of the axis
            lo, hi = max(i - w, 0), min(i + w + 1, n)
            j = lo + int(np.argmax(g[lo:hi]))
            f = float(np.asarray(ev.rates_hz)[j])
            self._q.put(f"fv {f:.6f}")
            return f"rate panel click -> fv {f:.4f} Hz (queued)"
        if ev.line_peaks is None or not len(ev.line_peaks):
            return "click ignored — evidence has no ranked line peaks"
        lags = np.asarray(ev.line_lags, np.float64)
        target = float(lags[0] + (lags[-1] - lags[0]) * xf)
        peaks = np.asarray(ev.line_peaks, np.float64)
        n_pk = int(np.argmin(np.abs(peaks[:, 0] - target)))
        self._q.put(f"pick {n_pk}")
        return (f"line panel click -> peak #{n_pk} "
                f"(lag {peaks[n_pk, 0]:.1f}, {peaks[n_pk, 1]:.0f} lines, "
                "queued)")

    def status(self) -> dict:
        rt = self.rt
        m = rt.mode
        # NaN (native-ring rate meters) is not valid JSON — null it out.
        h = {k: (None if isinstance(v, float) and not np.isfinite(v) else v)
             for k, v in rt.health().items()}
        with self._lock:
            info = dict(self._info)
        line = (
            f"mode {m.width}x{m.height} @ {m.refresh:.4f} Hz | "
            f"alpha {rt.alpha} | fidelity {rt.fidelity} | "
            f"{'running' if self.console.running else 'PAUSED'} | "
            f"blocks {self.console.blocks_done} frames {rt.frames_out} | "
            f"consumer {h['consumer_msps']} MS/s "
            f"(x{h['realtime_factor']} RT) | "
            f"ring overflows {h['ring_overflows']}"
        )
        if h.get("combine"):
            line += (f" | combine {len(h['combine']['centers_hz'])} "
                     f"carriers w={h['combine']['weights']}")
        return {
            "line": line,
            "mode": {"width": m.width, "height": m.height,
                     "refresh": m.refresh},
            "alpha": rt.alpha,
            "fidelity": rt.fidelity,
            "running": self.console.running,
            "blocks": self.console.blocks_done,
            "health": h,
            "sync": np.asarray(info["sync"]).tolist() if info.get("sync")
                    is not None else None,
        }

    # ------------------------------------------------------------ lifecycle
    def run(self, max_blocks: int | None = None):
        """Drive the stream until `quit` is posted (or ``max_blocks``);
        returns the final EMA image.  The caller owns runtime start/stop."""
        try:
            return self.console.run(max_blocks=max_blocks)
        finally:
            self.close()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
