"""Zero-dependency plot rendering: line plots to grayscale images + ASCII
sparklines.

The reference GUI shows two *live* autocorrelation panels and lets the
operator click a peak to override the refresh-rate / line-count estimates
(``/root/reference/src/GUI.jl:296-356,450-459,512-523``,
``src/ScreenRenderer.jl:131-139`` ``_plotInteractiveCorrelation``).  This
framework automates the estimates, but on noisy captures the operator still
needs to *see* the correlation evidence — these renderers draw it headlessly:
a PNG panel for ``analyze --plots`` and a terminal sparkline for the stream
HUD.  No imaging/plotting dependency: pure numpy rasterisation through the
same ``write_png`` used for screens.
"""

from __future__ import annotations

import numpy as np

__all__ = ["render_line_plot", "sparkline"]

_BLOCKS = "▁▂▃▄▅▆▇█"


def render_line_plot(
    y: np.ndarray,
    width: int = 800,
    height: int = 240,
    marks: tuple[float, ...] | list[float] = (),
    pad: int = 8,
) -> np.ndarray:
    """Rasterise a 1-D series as a grayscale line plot (float32 in [0, 1]).

    ``marks`` are fractional positions in [0, 1] along the x axis (e.g. the
    detected peak); each is drawn as a bright vertical cursor.  The curve is
    drawn dark-on-light with vertical joins so steep peaks stay connected.
    """
    y = np.asarray(y, np.float64).ravel()
    img = np.full((height, width), 0.92, np.float32)  # light background
    if y.size < 2:
        return img
    lo, hi = float(np.min(y)), float(np.max(y))
    span = hi - lo if hi > lo else 1.0
    # Resample the series to one value per x pixel (linear).
    xs = np.linspace(0.0, y.size - 1.0, width - 2 * pad)
    i0 = np.minimum(xs.astype(np.int64), y.size - 2)
    frac = xs - i0
    yy = y[i0] * (1.0 - frac) + y[i0 + 1] * frac
    rows = ((1.0 - (yy - lo) / span) * (height - 2 * pad - 1)).astype(np.int64) + pad
    cols = np.arange(width - 2 * pad) + pad
    # Border.
    img[pad - 1, pad - 1 : width - pad + 1] = 0.55
    img[height - pad, pad - 1 : width - pad + 1] = 0.55
    img[pad - 1 : height - pad + 1, pad - 1] = 0.55
    img[pad - 1 : height - pad + 1, width - pad] = 0.55
    # Mark cursors behind the curve.
    for m in marks:
        c = int(round(pad + float(np.clip(m, 0.0, 1.0)) * (width - 2 * pad - 1)))
        img[pad : height - pad, c] = 0.35
    # Polyline with vertical joins.
    img[rows, cols] = 0.0
    for k in range(1, len(cols)):
        r0, r1 = sorted((rows[k - 1], rows[k]))
        img[r0 : r1 + 1, cols[k]] = 0.0
    return img


def sparkline(y: np.ndarray, width: int = 60, mark: float | None = None) -> str:
    """One-line unicode block sparkline of a series, optionally replacing the
    cell nearest fractional position ``mark`` with a peak cursor ``|``."""
    y = np.asarray(y, np.float64).ravel()
    if y.size == 0:
        return ""
    width = min(width, max(y.size, 1))
    # Max-pool into width cells (peaks must survive downsampling).
    edges = np.linspace(0, y.size, width + 1).astype(np.int64)
    cells = np.array([y[a:b].max() if b > a else y[min(a, y.size - 1)]
                      for a, b in zip(edges[:-1], edges[1:])])
    lo, hi = cells.min(), cells.max()
    span = hi - lo if hi > lo else 1.0
    idx = ((cells - lo) / span * (len(_BLOCKS) - 1) + 0.5).astype(np.int64)
    chars = [_BLOCKS[i] for i in idx]
    if mark is not None:
        c = int(round(float(np.clip(mark, 0.0, 1.0)) * (width - 1)))
        chars[c] = "|"
    return "".join(chars)
