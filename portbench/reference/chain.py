"""Plain reference of the reconstruction chain: demod, frame cuts, the
signal-to-screen resample, the blanking sync, the alignment and the EMA fold.

A frozen copy of the plain math of ``tempest_tpu_torch`` at commit 535d04e,
in plain PyTorch, importing nothing of that package:

* ``ops/demod.py``: ``am_envelope_from_iq`` (``sqrt(I² + Q²)`` of interleaved
  words);
* ``ops/resample.py``: ``_screen_geometry``, ``round_to_bfloat16``;
* ``ops/resample_kernel.py``: ``_line_tables``, ``catmull_rom_weights``,
  ``frames_to_screens_plain`` (Pallas boundary semantics: line starts clamped
  at 0, positions lower-clipped at 0, reads clamped into the block);
* ``ops/framesync.py``: profiles, circular Gaussian smoothing, prefix sums,
  the contrast score, the argmax and the sub-pixel parabola; the fractional
  circular shift, rows first;
* ``ops/align_kernel.py``: the fold ``S = w_0·x_0 + ... ; α^F·ema + S``;
* ``pipeline/offline.py``: ``carry_phase_starts`` (float32 arithmetic),
  ``exact_cut_starts`` (float64), rounded static starts.

Every function takes ``q``, the precision every intermediate tensor is
stored in: ``exact`` (float32 as computed) for the reference, ``bfloat16``
for the control (each operation's result rounded to bfloat16 and back).
Work over frames goes in chunks so that a block of hundreds of frames fits.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["exact", "bfloat16", "PRECISIONS", "Geometry", "geometry", "envelope",
           "carry_phase_starts", "exact_cut_starts", "static_starts", "screens", "sync",
           "align", "fold", "chain"]

CHUNK = 8  # frames a chunk


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bfloat16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if x.is_floating_point() else x


PRECISIONS = {"float32": exact, "bfloat16": bfloat16}


# ------------------------------------------------------------ demod, cuts
def envelope(words: torch.Tensor, q=exact, bf16: bool = False) -> torch.Tensor:
    """AM envelope of interleaved I/Q words (int16 or float32), float32;
    rounded to bfloat16 and back with ``bf16`` (the ``mxu3`` chain)."""
    n = words.shape[0] // 2
    pairs = q(words[: 2 * n].to(torch.float32).view(n, 2))
    sq = q(pairs * pairs)
    env = q(torch.sqrt(q(sq[:, 0] + sq[:, 1])))
    return env.to(torch.bfloat16).to(torch.float32) if bf16 else env


def carry_phase_starts(phase: float, spf: float, n_frames: int) -> np.ndarray:
    """Rounded starts of a carry-phase block in float32, one rounding an
    operation: ``floor(phase + spf·k + 0.5)``."""
    x = np.float32(phase) + np.float32(spf) * np.arange(n_frames, dtype=np.float32)
    return np.floor(x + np.float32(0.5)).astype(np.int32)


_BELOW_ONE = np.nextafter(np.float32(1.0), np.float32(0.0))


def exact_cut_starts(phase: float, spf: float, n_frames: int):
    """(int32 ``floor(phase + spf·k)``, float32 residual in [0, 1)), float64."""
    x = float(phase) + float(spf) * np.arange(n_frames, dtype=np.float64)
    s = np.floor(x)
    return s.astype(np.int32), np.minimum((x - s).astype(np.float32), _BELOW_ONE)


def static_starts(spf: float, n_frames: int) -> np.ndarray:
    """Rounded starts of a block from phase 0: ``round(k·spf)``."""
    return np.round(np.arange(n_frames) * spf).astype(np.int32)


# ------------------------------------------------------------- resample
class Geometry:
    """Line tables of the resample of ``frame_len``-sample frames of a
    ``y_t`` x ``x_t`` raster onto ``out_shape``."""

    def __init__(self, frame_len: int, y_t: int, x_t: int, out_shape) -> None:
        h_out, w_out = int(out_shape[0]), int(out_shape[1])
        ratio = frame_len / (y_t * x_t)
        ry = np.clip((np.arange(h_out) + 0.5) * (y_t / h_out) - 0.5, 0.0, y_t - 1.0)
        r0 = np.minimum(np.floor(ry).astype(np.int64), max(y_t - 2, 0))
        wr = (ry - r0).astype(np.float32)
        lines = np.stack([r0, np.minimum(r0 + 1, y_t - 1)], axis=1)
        cx0 = 0.5 * (x_t / w_out) - 0.5
        delta = (x_t / w_out) * ratio if w_out > 1 else 0.0
        a = (lines * x_t + cx0 + 0.5) * ratio - 0.5
        start = np.floor(a).astype(np.int64)
        frac = (a - start).astype(np.float32)
        cols = (np.arange(w_out) * delta).astype(np.float64)
        self.delta = float(np.float32(cols[1])) if w_out > 1 else 0.0
        self.line_start = np.maximum(start, 0)
        self.line_frac = (frac + (start - self.line_start)).astype(np.float32)
        self.wr = np.ascontiguousarray(wr)
        self.out_shape = (h_out, w_out)
        self.samples_per_line = frame_len / y_t


def geometry(frame_len: int, y_t: int, x_t: int, out_shape) -> Geometry:
    return Geometry(frame_len, y_t, x_t, out_shape)


def _catmull_rom(t):
    t2 = t * t
    t3 = t2 * t
    return (0.5 * ((2.0 * t2 - t3) - t), 0.5 * ((3.0 * t3 - 5.0 * t2) + 2.0),
            0.5 * ((4.0 * t2 - 3.0 * t3) + t), 0.5 * (t3 - t2))


def _screens_chunk(env, starts, fracs, g: Geometry, taps: int, q):
    h, w = g.out_shape
    dev = env.device
    n = env.shape[0]
    cp = torch.arange(w, dtype=torch.float32, device=dev) * torch.tensor(
        g.delta, dtype=torch.float32, device=dev)
    frac = torch.from_numpy(g.line_frac).to(dev)[None]
    if fracs is not None:
        frac = frac + fracs[:, None, None]
    pos = torch.clamp(cp + frac[..., None], min=0.0)
    i0f = torch.floor(pos)
    t = q(pos - i0f)
    base = starts.to(torch.int64)[:, None, None] + torch.from_numpy(g.line_start).to(dev)[None]
    idx0 = base[..., None] + i0f.to(torch.int64)

    def tap(off):
        return env[torch.clamp(idx0 + off, 0, n - 1)]

    if taps == 2:
        lines = q(q(tap(0) * q(1.0 - t)) + q(tap(1) * t))
    else:
        w0, w1, w2, w3 = (q(x) for x in _catmull_rom(t))
        lines = q(q(q(q(tap(-1) * w0) + q(tap(0) * w1)) + q(tap(1) * w2)) + q(tap(2) * w3))
    wb = torch.from_numpy(g.wr).to(dev)[None, :, None]
    return q(q(q(1.0 - wb) * lines[:, :, 0]) + q(wb * lines[:, :, 1]))


def screens(env: torch.Tensor, starts: np.ndarray, fracs: np.ndarray | None, g: Geometry,
            taps: int = 2, q=exact) -> torch.Tensor:
    """[F, h, w] screens of the frames starting at ``starts`` (with the
    residuals ``fracs``) of the envelope ``env``."""
    dev = env.device
    st = torch.from_numpy(np.asarray(starts, np.int32)).to(dev)
    fr = None if fracs is None else torch.from_numpy(np.asarray(fracs, np.float32)).to(dev)
    out = [_screens_chunk(env, st[i:i + CHUNK], None if fr is None else fr[i:i + CHUNK], g,
                          taps, q) for i in range(0, st.shape[0], CHUNK)]
    return torch.cat(out)


# ------------------------------------------------------------------ sync
def _gaussian(n: int = 5) -> np.ndarray:
    k = np.arange(n) - (n - 1) // 2
    h = np.exp(-2.0 * k ** 2 / n ** 2)
    return (h / h.sum()).astype(np.float32)


def _smooth(p, q, kernel_len: int = 5):
    h = _gaussian(kernel_len)
    half = kernel_len // 2
    n = p.shape[-1]
    padded = torch.cat([p[..., n - half:], p, p[..., :half]], dim=-1)
    out = q(float(h[0]) * padded[..., 0:n])
    for k in range(1, kernel_len):
        out = q(out + q(float(h[k]) * padded[..., k:k + n]))
    return out


def _prefix(p, w_max, q):
    n = p.shape[-1]
    ext = torch.cat([p[..., n - w_max:], p, p[..., :w_max]], dim=-1)
    zero = torch.zeros(ext.shape[:-1] + (1,), dtype=ext.dtype, device=ext.device)
    return torch.cat([zero, q(torch.cumsum(ext, dim=-1))], dim=-1)


def _score(win, total, w, n, q):
    size = 2.0 * w + 1.0
    d = q(q(win / size) - q(q(total - win) / (n - size)))
    return q(d * d)


def _find(profile, n_min_frac: float, q):
    """Sub-pixel blanking centre of each [F, n] profile: (centre, score)."""
    n = profile.shape[-1]
    w_min, w_max = int(np.ceil(n_min_frac * n)), int(np.floor(n / 4))
    prefix = _prefix(profile, w_max, q)
    total = q(profile.sum(dim=-1))
    dev = profile.device
    ws = torch.arange(w_min, w_max + 1, device=dev)[:, None]
    c = torch.arange(n, device=dev)[None, :]
    win = q(prefix[..., w_max + ws + 1 + c] - prefix[..., w_max - ws + c])
    widths = torch.arange(w_min, w_max + 1, device=dev).to(profile.dtype)[:, None]
    beta = _score(win, total[..., None, None], widths, n, q).flatten(-2)
    flat = torch.argmax(beta, dim=-1)
    row, cc = flat // n, flat % n
    w = (w_min + row).to(profile.dtype)
    hi = row + w_min + w_max + 1
    lo = w_max - w_min - row

    def at(ci):
        ci = ci % n
        s = q(torch.gather(prefix, -1, (ci + hi)[..., None])
              - torch.gather(prefix, -1, (ci + lo)[..., None]))[..., 0]
        return _score(s, total, w, n, q)

    b0, b1, b2 = at(cc - 1), at(cc), at(cc + 1)
    denom = q(q(b0 - 2.0 * b1) + b2)
    frac = torch.where(torch.abs(denom) > 1e-12 * (torch.abs(b1) + 1e-30),
                       q(0.5 * q(b0 - b2) / denom), torch.zeros_like(denom))
    return cc.to(torch.float32) + torch.clamp(frac, -0.5, 0.5), b1


def sync(frames: torch.Tensor, q=exact, y_min_frac: float = 0.01, x_min_frac: float = 0.05):
    """Sub-pixel (s_y, s_x, score) of each frame of [F, h, w] screens."""
    outs = []
    for i in range(0, frames.shape[0], CHUNK):
        f = frames[i:i + CHUNK]
        row_p, col_p = _smooth(q(f.sum(dim=2)), q), _smooth(q(f.sum(dim=1)), q)
        s_y, sc_y = _find(row_p, y_min_frac, q)
        s_x, sc_x = _find(col_p, x_min_frac, q)
        outs.append((s_y, s_x, q(sc_y + sc_x)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


# ----------------------------------------------------------- align, fold
def _take(frames, k, axis):
    f, h, w = frames.shape
    n = h if axis == 1 else w
    idx = (torch.arange(n, device=frames.device)[None, :] + k[:, None]) % n
    if axis == 1:
        return torch.gather(frames, 1, idx[:, :, None].expand(f, h, w))
    return torch.gather(frames, 2, idx[:, None, :].expand(f, h, w))


def _roll_frac(frames, s, axis, q):
    k = torch.floor(s).to(torch.int64)
    f = q((s - k.to(s.dtype)).to(frames.dtype))
    out = q(q(1.0 - f)[:, None, None] * _take(frames, k, axis))
    return q(out + q(f[:, None, None] * _take(frames, k + 1, axis)))


def align(frames: torch.Tensor, s_y: torch.Tensor, s_x: torch.Tensor, q=exact) -> torch.Tensor:
    """Each frame shifted circularly by (-s_y, -s_x), linear taps, rows first."""
    out = []
    for i in range(0, frames.shape[0], CHUNK):
        sl = slice(i, i + CHUNK)
        out.append(_roll_frac(_roll_frac(frames[sl], s_y[sl], 1, q), s_x[sl], 2, q))
    return torch.cat(out)


def fold(ema: torch.Tensor, frames: torch.Tensor, alpha: float, q=exact) -> torch.Tensor:
    """``α^F·ema + Σ_n (1−α)·α^(F−1−n)·frame_n``, the sum in frame order."""
    n = frames.shape[0]
    a = torch.as_tensor(alpha, dtype=torch.float32, device=frames.device)
    k = torch.arange(n - 1, -1, -1, dtype=torch.float32, device=frames.device)
    w, big_a = q((1.0 - a) * a ** k), q(a ** n)
    s = q(w[0] * frames[0])
    for i in range(1, n):
        s = q(s + q(w[i] * frames[i]))
    return q(q(big_a * ema) + s)


def chain(env: torch.Tensor, starts, fracs, g: Geometry, ema: torch.Tensor, alpha: float,
          taps: int = 2, q=exact):
    """One block: (ema', aligned frames, sync [F, 2], score [F])."""
    raw = screens(env, starts, fracs, g, taps, q)
    s_y, s_x, score = sync(raw, q)
    frames = align(raw, s_y, s_x, q)
    return fold(ema, frames, alpha, q), frames, torch.stack([s_y, s_x], dim=1), score
