#!/usr/bin/env python3
"""The float32 FM load's arc tangent against ``atan2f`` on every sample, on
the card: ``resample_kernel.fm_float32_words`` (``csrc/resample.cu``
``fm_f32_word``: a lane a 16-byte word of two pairs, ``atan2_fast`` where
every lane of the warp has operands in ``atan2_in_domain``, ``atan2f``
where one has not) against the plain discriminator, ``torch.atan2`` after
the same roundings, which calls ``atan2f`` on the card, bit for bit (NaN
where it is NaN).

Three scales of 2^26 random samples each (2^26 + 1 interleaved float32 I/Q
pairs, consecutive samples sharing a pair): integer valued within the int16
range (the runtime's uploads of int16 captures), unit scale (``|v| <= 4``,
the synthetic generator's), random exponents over the whole float32 range
(random bits, the non-finite ones replaced by 1; subnormals among them);
then every quadruple of two pairs of ``EDGE_VALUES`` (both zeros,
subnormals, the infinities, NaN, ``FLT_MAX``, products that overflow,
products at the domain's bounds 2^±60 and just beyond).  For each it prints
the samples that differ (0 is the claim), the share of samples inside the
domain and of warps (64 samples) that take the branchless path, and the
check kernel's device time beside the plain version's.  Needs a CUDA card:

    python3 exp/k1_atan2_f32.py [--log2 26] [--out atan2_f32.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tempest_tpu_torch.ops import resample_kernel as rk  # noqa: E402

SCALES = ("int16", "unit", "exponents")
TINY = float(np.finfo(np.float32).tiny)
BIG = float(np.finfo(np.float32).max)
EDGE_VALUES = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1e-40, TINY, -TINY, 1.0, -1.0, 3.0, 2.0 ** -30,
     -1.5 * 2.0 ** -30, 2.0 ** -30 * (1 - 2.0 ** -24), 2.0 ** 30, -1.5 * 2.0 ** 30,
     2.0 ** 30 * (1 + 2.0 ** -23), 2.0 ** 31, 1e19, -2.0 ** 64, BIG, -BIG, np.inf, -np.inf,
     np.nan], np.float32)
# csrc/resample.cu kAtanLo, kAtanHi: the domain is |x| and |y| each 0 or in
# [2^-60, 2^60).
ATAN_LO, ATAN_HI = 2.0 ** -60, 2.0 ** 60


def float_words(scale: str, n_pairs: int, rng) -> np.ndarray:
    if scale == "int16":
        return rng.integers(-32768, 32768, 2 * n_pairs).astype(np.float32)
    if scale == "unit":
        return rng.uniform(-4.0, 4.0, 2 * n_pairs).astype(np.float32)
    v = rng.integers(0, 1 << 32, 2 * n_pairs, dtype=np.uint64).astype(np.uint32).view(np.float32)
    v[~np.isfinite(v)] = 1.0
    return v


def edge_words() -> np.ndarray:
    pairs = np.array([(i, q) for i in EDGE_VALUES for q in EDGE_VALUES], np.float32)
    return np.stack([np.repeat(pairs, len(pairs), axis=0), np.tile(pairs, (len(pairs), 1))],
                    axis=1).reshape(-1)


def differing(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Samples whose bits differ (NaN against NaN counts as equal)."""
    nan = torch.isnan(ref)
    return int((torch.isnan(got) != nan).sum()) + int(
        (got[~nan].view(torch.int32) != ref[~nan].view(torch.int32)).sum())


def domain_shares(words: torch.Tensor) -> tuple[float, float]:
    """The share of samples whose (y, x) lie in ``atan2_in_domain`` (|x| and
    |y| each 0 or in [2^-60, 2^60)), and of
    warps (32 words of two samples, from the first) all of whose samples
    do: those take ``atan2_fast``."""
    p = words.view(-1, 2)
    re0, im0, re1, im1 = p[:-1, 0], p[:-1, 1], p[1:, 0], p[1:, 1]
    y = im1 * re0 - re1 * im0
    x = re1 * re0 + im1 * im0
    ok = torch.ones_like(x, dtype=torch.bool)
    for v in (x.abs(), y.abs()):
        ok &= (v == 0) | ((v >= ATAN_LO) & (v < ATAN_HI))
    ok = torch.cat([torch.ones(1, dtype=torch.bool, device=ok.device), ok])
    pad = (-ok.numel()) % 64
    warps = torch.cat([ok, torch.ones(pad, dtype=torch.bool, device=ok.device)]).view(-1, 64)
    return float(ok.float().mean()), float(warps.all(dim=1).float().mean())


def device_ms(fn, launches: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2", type=int, default=26, help="random samples a scale: 2^LOG2")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_atan2_f32: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    rng = np.random.default_rng(2026)
    report = {"card": card, "log2": args.log2, "cases": {}}
    cases = [(s, None) for s in SCALES] + [("edges", edge_words())]
    for name, words in cases:
        if words is None:
            words = float_words(name, (1 << args.log2) + 1, rng)
        tw = torch.from_numpy(words).to(dev)
        del words
        got = rk.fm_float32_words(tw)
        ref = rk.words_envelope_plain(tw, "fm")
        torch.cuda.synchronize()
        bad = differing(got, ref)
        del got, ref
        samples, warps = domain_shares(tw)
        row = {"samples": tw.numel() // 2, "differ": bad, "in_domain": samples,
               "warps_branchless": warps,
               "kernel_ms": device_ms(lambda: rk.fm_float32_words(tw)),
               "plain_ms": device_ms(lambda: rk.words_envelope_plain(tw, "fm"), 3)}
        report["cases"][name] = row
        print(f"[atan2 f32] {name}: {row['samples']} samples, {bad} differ from atan2f "
              f"(torch.atan2); in the domain {samples:.6f} of samples, branchless "
              f"{warps:.6f} of warps; check kernel {row['kernel_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, on {card}")
        del tw
    ok = all(r["differ"] == 0 for r in report["cases"].values())
    report["ok"] = ok
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"atan2_f32_equal_everywhere": ok,
                      "samples": sum(r["samples"] for r in report["cases"].values())}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
