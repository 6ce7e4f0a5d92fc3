#!/usr/bin/env python3
"""Where K1's time goes, tile by tile: ``clock64()`` stamps around each phase
of a tile, in a copy of ``csrc/resample.cu`` that this script patches and
builds under ``tempest_tpu_torch/_build/exp/`` (the shipped kernel has no
stamps), and the SASS of the shipped instantiations.

Both kernels are patched: the 2-tap ``resample_tiles_kernel`` (which, in a
checkout before the 4-tap kernel of its own, also ran the 4-tap read) and
the 4-tap ``catmull_rom_tiles_kernel`` where the source has it.  Phases of
a tile, as two threads of every block see them (thread 0 and thread 128).
2 taps: ``next`` (plan the next tile, start its copies), ``wait`` (its own
run landed), ``barrier`` (the other threads' copies landed), ``demod`` (I/Q
words to envelope samples, and the barrier after it), ``compute`` (this
thread's work items), ``end`` (the barrier before the buffers refill).
4 taps: ``plan`` (the tile's plan and row table), ``wait`` (its bulk copy
landed), ``barrier``, ``next`` (thread 0 starts the next tile's bulk copy),
``demod``, ``compute``.  Printed as
mean cycles a tile and as a share of the block's cycles.

Inputs: random int16 I/Q words (timing does not depend on the values) at
two geometries onto 600x800 screens: 36 frames of 1920x1080 @ 60 Hz at 20
Msps (the slice's block) and 11 frames of 640x480 @ 60 Hz at 32 Msps (what
``auto_reconstruct`` launches on the smoke's 0.2 s capture there), the
envelope and int16 words, 2 and 4 taps.  Needs a CUDA card and nvcc:

    python3 exp/k1_clocks.py [--source path/to/resample.cu] [--sass k1_sass.txt]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tempest_tpu_torch import _build  # noqa: E402
from tempest_tpu_torch.ops import resample_kernel as rk  # noqa: E402
from tempest_tpu_torch.ops.demod import am_envelope_from_iq  # noqa: E402
from tempest_tpu_torch.pipeline import offline as poff  # noqa: E402
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES  # noqa: E402

PHASES = {2: ("next", "wait", "barrier", "demod", "compute", "end"),
          4: ("plan", "wait", "barrier", "next", "demod", "compute")}
# (mode, sample rate, frames) of each geometry.
GEOMETRIES = {"1080p60, 20 Msps, 36 frames": ("1920x1080 @ 60Hz", 20e6, 36),
              "640x480, 32 Msps, 11 frames": ("640x480 @ 60Hz", 32e6, 11)}
# (anchor, text inserted after it) in the kernel's source.
PATCHES = (
    ("  Tile cur = make_tile<",
     None),  # checked only: the kernel this script knows
    ("  cp_async_commit();\n\n  for (int it = 0;; ++it) {\n",
     "    long long s0 = clock64();\n"),
    ("    cp_async_commit();\n    cp_async_wait_all_but_newest();\n",
     "    long long s1 = clock64(), s2 = s1, s3 = s1;\n"),
    ("      __syncthreads();  // every thread's copies have landed\n",
     "      s2 = clock64();\n"),
    ("    // Work items (row, group of G columns), strided over the whole tile.\n",
     "    s3 = clock64();\n    if (cur.fast == false) s2 = s3;\n"),
    ("    if (!has_next) break;\n",
     None),
)


def patched_source(src: str) -> str:
    for anchor, text in PATCHES:
        if anchor not in src:
            raise SystemExit(f"k1_clocks: the kernel has no {anchor!r}: not the kernel this "
                             "script patches")
        if text:
            src = src.replace(anchor, anchor + text, 1)
    # The accumulators, the end of each tile and the write-out.
    src = src.replace(
        "  cp_async_commit();\n\n  for (int it = 0;; ++it) {\n",
        "  cp_async_commit();\n  long long acc[6] = {0, 0, 0, 0, 0, 0};\n  int n_tiles = 0;\n"
        "  const long long k_start = clock64();\n\n  for (int it = 0;; ++it) {\n", 1)
    src = src.replace(
        "    if (!has_next) break;\n",
        "    const long long s4 = clock64();\n"
        "    acc[0] += s1 - s0; acc[2] += s2 - s1; acc[3] += s3 - s2; acc[4] += s4 - s3;\n"
        "    ++n_tiles;\n"
        "    if (!has_next) break;\n", 1)
    src = src.replace(
        "    __syncthreads();  // all reads of this tile done before its buffers refill\n",
        "    __syncthreads();  // all reads of this tile done before its buffers refill\n"
        "    acc[5] += clock64() - s4;\n", 1)
    # "next" is inside [s0, s1) with the wait: split it where the copies of
    # the next tile have been started.
    src = src.replace(
        "    const Geometry g = tile_geometry<kCands>(launch, cur.c);\n",
        "    const Geometry g = tile_geometry<kCands>(launch, cur.c);\n"
        "    acc[1] -= clock64() - s0;\n", 1)
    src = src.replace(
        "    t = t_next;\n    cur = next;\n  }\n",
        "    t = t_next;\n    cur = next;\n  }\n"
        "  if (g_stamps != nullptr && (threadIdx.x == 0 || threadIdx.x == 128)) {\n"
        "    long long* o = g_stamps + (2 * blockIdx.x + (threadIdx.x == 128)) * 8;\n"
        "    acc[1] += acc[0];  // wait = (s1 - s0) - next\n"
        "    acc[0] -= acc[1];\n"
        "    for (int k = 0; k < 6; ++k) o[k] = acc[k];\n"
        "    o[6] = clock64() - k_start;\n    o[7] = n_tiles;\n  }\n", 1)
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ long long* g_stamps = nullptr;\n", 1)
    src += ("\nextern \"C\" int tt_k1_set_stamps(void* p) {\n"
            "  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));\n}\n")
    return src


# The 4-tap kernel's anchors, in order, and the stamp put before (b) or
# after (a) each.
PATCHES_4 = (
    ("  for (int it = 0; t < g.n_tiles; ++it, t += gridDim.x) {\n", "a",
     "    const long long s0 = clock64();\n"),
    ("    const int b = it & 1;\n    if (cur.fast) {\n", "b",
     "    const long long s1 = clock64();\n"),
    ("      parity ^= 1u << b;\n    }\n", "a", "    const long long s2 = clock64();\n"),
    ("    // previous tile: its buffer takes the next tile's run.\n"
     "    __syncthreads();\n", "a", "    const long long s3 = clock64();\n"),
    ("    float* const env = (WORD == kIqF32) ? env_pairs : reinterpret_cast<float*>(stage);\n"
     "    if (!cur.fast) {\n      load_run_clamped", "b", "    const long long s4 = clock64();\n"),
    ("    float* const tile_out = out + (static_cast<long long>(cur.f) * g.h + cur.r0) * g.w;\n"
     "    while (row < cur.rows) {\n      const RowInfo4", "b",
     "    const long long s5 = clock64();\n"),
)


def patch_taps4(src: str) -> str:
    """Stamps in the 4-tap kernel, or the source as it is when it has none."""
    start = src.find("catmull_rom_tiles_kernel(const void*")
    if start < 0:
        return src
    end = src.index("\n}\n", start) + 3
    body = src[start:end]
    for anchor, where, text in PATCHES_4:
        at = body.find(anchor)
        if at < 0:
            raise SystemExit(f"k1_clocks: the 4-tap kernel has no {anchor!r}")
        at = at + len(anchor) if where == "a" else at
        body = body[:at] + text + body[at:]
    body = body.replace(
        "  for (int it = 0; t < g.n_tiles;",
        "  long long acc[6] = {0, 0, 0, 0, 0, 0};\n  int n_tiles = 0;\n"
        "  const long long k_start = clock64();\n  for (int it = 0; t < g.n_tiles;", 1)
    tail = "        ++row;\n      }\n    }\n  }\n}\n"
    if not body.endswith(tail):
        raise SystemExit("k1_clocks: the 4-tap kernel does not end as this script expects")
    body = body[: -len(tail)] + (
        "        ++row;\n      }\n    }\n"
        "    const long long s6 = clock64();\n"
        "    acc[0] += s1 - s0; acc[1] += s2 - s1; acc[2] += s3 - s2; acc[3] += s4 - s3;\n"
        "    acc[4] += s5 - s4; acc[5] += s6 - s5;\n    ++n_tiles;\n  }\n"
        "  if (g_stamps != nullptr && (threadIdx.x == 0 || threadIdx.x == 128)) {\n"
        "    long long* o = g_stamps + (2 * blockIdx.x + (threadIdx.x == 128)) * 8;\n"
        "    for (int k = 0; k < 6; ++k) o[k] = acc[k];\n"
        "    o[6] = clock64() - k_start;\n    o[7] = n_tiles;\n  }\n}\n")
    return src[:start] + body + src[end:]


def build(src_path: Path) -> ctypes.CDLL:
    out_dir = ROOT / "tempest_tpu_torch" / "_build" / "exp"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "resample_clocks.cu"
    cu.write_text(patch_taps4(patched_source(src_path.read_text())))
    lib_path = out_dir / "libresample_clocks.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.has_taps4 = "catmull_rom_tiles_kernel(const void*" in src_path.read_text()
    argtypes, restype = _build.SIGNATURES["resample"]["tt_resample_frames"]
    lib.tt_resample_frames.argtypes = argtypes
    lib.tt_resample_frames.restype = restype
    lib.tt_k1_set_stamps.argtypes = [ctypes.c_void_p]
    lib.tt_k1_set_stamps.restype = ctypes.c_int
    return lib


def sass_summary(lib_path: str, out: Path | None) -> dict:
    """Static SASS counts of every K1 instantiation: instructions in all and
    by opcode (cuobjdump of the shipped library)."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr[-500:]}
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(proc.stdout)
    summary, name, ops = {}, None, Counter()
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                summary[name] = ops
            name, ops = m.group(1), Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            ops[m.group(2).split(".")[0]] += 1
    if name:
        summary[name] = ops
    return {k: {"total": sum(v.values()), **dict(v.most_common(24))} for k, v in summary.items()}


def run_stamped(lib, stamps, dev, env, words, word, taps, starts, raster, geom) -> dict:
    """One stamped launch (after two warm-up launches) of ``word`` with
    ``taps`` taps: its phases a tile, or only whether it equals plain when
    the kernel that ran has no stamps."""
    data, code = {"envelope": (env, 0), "int16": (words, 1)}[word]
    n_frames = starts.shape[0]
    h, w = raster[3]
    rows, run_cap = rk.tile_plan(*raster, 4, sum(rk.line_reach(taps, False)), taps)
    out = torch.empty((n_frames, h, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(3):
        stamps.zero_()
        rc = lib.tt_resample_frames(
            data.data_ptr(), env.shape[0], code, starts.data_ptr(), None, n_frames, taps,
            geom.line_start.data_ptr(), geom.line_frac.data_ptr(), geom.wr.data_ptr(),
            out.data_ptr(), h, w, geom.delta, geom.span + rk.line_reach(taps, False)[1],
            rows, run_cap, stream)
        if rc != 0:
            raise SystemExit(f"launch failed with cudaError_t {rc}")
        torch.cuda.synchronize()
    equal = bool(torch.equal(out, rk.frames_to_screens_plain(env, starts, geom, None, taps)))
    s = stamps.view(-1, 8).cpu().numpy()
    used = s[s[:, 7] > 0]
    if not len(used):
        return {"equal_to_plain": equal}
    phases = PHASES[4] if taps == 4 and lib.has_taps4 else PHASES[2]
    tiles = used[:, 7].astype(np.float64)
    return {"rows_a_tile": rows, "run_cap": run_cap, "blocks": int(len(used) // 2),
            "tiles_a_block": float(tiles.mean()), "cycles_a_block": float(used[:, 6].mean()),
            "cycles_a_tile": {p: float(np.mean(used[:, k] / tiles)) for k, p in enumerate(phases)},
            "share": {p: float(used[:, k].sum() / used[:, 6].sum()) for k, p in enumerate(phases)},
            "equal_to_plain": equal}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=ROOT / "tempest_tpu_torch/csrc/resample.cu")
    ap.add_argument("--sass", type=Path, default=None, help="write the whole SASS here")
    ap.add_argument("--out", type=Path, default=None, help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_clocks: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    shipped = _build.load_library("resample")
    results = {"card": card, "sass": sass_summary(shipped.path, args.sass)}
    for name, counts in results["sass"].items():
        print(f"[sass] {name}: {counts}")
    lib = build(args.source)
    stamps = torch.zeros(4096 * 16, dtype=torch.int64, device=dev)
    if lib.tt_k1_set_stamps(stamps.data_ptr()) != 0:
        raise SystemExit("could not set the stamps' buffer")
    results["runs"] = {}
    rng = np.random.default_rng(0)
    for where, (mode_name, fs, n_frames) in GEOMETRIES.items():
        mode = ALL_VIDEO_MODES[mode_name]
        spf = fs / mode.refresh
        frame_len = int(np.floor(spf))
        n = int(np.ceil(n_frames * spf)) + 1 + int(np.ceil(spf))
        words = torch.from_numpy(rng.integers(-20000, 20000, 2 * n).astype(np.int16)).to(dev)
        env = am_envelope_from_iq(words)
        starts = torch.from_numpy(poff.carry_phase_starts(0.0, spf, n_frames)).to(dev)
        raster = (frame_len, mode.height, mode.width, (600, 800))
        geom = rk.screen_geometry(*raster, dev)
        for word, taps in (("envelope", 2), ("envelope", 4), ("int16", 2), ("int16", 4)):
            label = f"{where}, {word}, {taps} taps"
            row = run_stamped(lib, stamps, dev, env, words, word, taps, starts, raster, geom)
            results["runs"][label] = row
            if "share" not in row:
                print(f"[clocks] {label}: no stamps (a kernel this script does not patch); "
                      f"equal to plain: {row['equal_to_plain']}")
                continue
            print(f"[clocks] {label}: {row['rows_a_tile']} rows a tile, {row['blocks']} blocks, "
                  f"{row['tiles_a_block']:.2f} tiles a block, {row['cycles_a_block']:.0f} cycles a "
                  f"block; cycles a tile " + ", ".join(
                      f"{p} {v:.0f}" for p, v in row["cycles_a_tile"].items())
                  + "; share " + ", ".join(f"{p} {v:.3f}" for p, v in row["share"].items())
                  + f"; equal to plain: {row['equal_to_plain']}; on {card}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
