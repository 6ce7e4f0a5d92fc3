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
``demod``, ``compute``.  Printed as mean cycles a tile and as a share of
the block's cycles.

Under the FM load (``demod_run``'s FM code, int16 and float32 words) the
demod is split once more: ``reads`` (the words and the pair before each
one, stamped once the loads have landed), ``barriers`` (the block barrier
of each round of int16 words; 0 where there is none) and ``arc tangents``
(the discriminator of each sample and its store), summed over a tile.

Inputs: random int16 I/Q words (timing does not depend on the values) at
two geometries onto 600x800 screens: 36 frames of 1920x1080 @ 60 Hz at 20
Msps (the slice's block) and 11 frames of 640x480 @ 60 Hz at 32 Msps (what
``auto_reconstruct`` launches on the smoke's 0.2 s capture there), the
envelope, int16 words under AM, and int16 and float32 words under FM, 2 and
4 taps.  The SASS part counts the opcodes of every shipped instantiation and
compiles ``atan2f`` alone (``atan2f_probe``) and the int16 FM load's
``atan2_int16`` (its text taken from the source, ``atan2_int16_probe``),
listing and counting what each compiles to: atan2f's IEEE division's fast
path and the branch to its slow path among them.
Needs a CUDA card and nvcc:

    python3 exp/k1_clocks.py [--source path/to/resample.cu] [--sass k1_sass.txt]
                             [--loads fm] [--out k1_clocks.json]
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
from tempest_tpu_torch.pipeline import offline as poff  # noqa: E402
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES  # noqa: E402

PHASES = {2: ("next", "wait", "barrier", "demod", "compute", "end"),
          4: ("plan", "wait", "barrier", "next", "demod", "compute")}
DEMOD_SPLIT = ("reads", "barriers", "arc tangents")
# Stamps a thread writes: 6 phases, its cycles, tiles, the demod split and a
# sink, the block's start and end on the card's global clock (ns), its SM.
STRIDE = 16
# (mode, sample rate, frames) of each geometry.
GEOMETRIES = {"1080p60, 20 Msps, 36 frames": ("1920x1080 @ 60Hz", 20e6, 36),
              "640x480, 32 Msps, 11 frames": ("640x480 @ 60Hz", 32e6, 11)}
# label -> (words, demod) of each load timed: "envelope" is the float32
# envelope entry, the others K1's words load.
LOADS = {"envelope": ("envelope", None), "int16 AM": ("int16", "am"),
         "int16 FM": ("int16", "fm"), "float32 FM": ("float32", "fm")}
# (anchor, text inserted after it) in the kernel's source.
def _present(text: str, *forms: str) -> str:
    """The first of ``forms`` that ``text`` holds (the kernels' code as one
    checkout or another writes it)."""
    for form in forms:
        if form in text:
            return form
    raise SystemExit(f"k1_clocks: the kernel has none of {forms!r}: not a kernel this script "
                     "patches")


# The 2-tap kernel's first tile and its step to the next: strided by tile
# index, or (since the balanced walk) by its walk.
FIRST_TILE = ("  Tile cur = make_tile<", "  Tile cur = walk_tile<")
ADVANCE = ("    t = t_next;\n    cur = next;\n  }\n",
           "    walk.pos = t_next;\n    cur = next;\n  }\n")
PATCHES = (
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
# Where a thread writes its stamps, and what it writes after its 6 phases.
WRITE_OUT = (
    "    long long* o = g_stamps + (2 * blockIdx.x + (threadIdx.x == 128)) * %d;\n" % STRIDE)
WRITE_SPLIT = ("    for (int k = 0; k < 4; ++k) o[8 + k] = dclk[k];\n"
               "    unsigned long long g_t1;\n"
               "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_t1));\n"
               "    o[12] = static_cast<long long>(g_t0);\n"
               "    o[13] = static_cast<long long>(g_t1);\n"
               "    unsigned sm;\n"
               "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
               "    o[14] = sm;\n")
# The block's start on the global clock, after its first cycle stamp.
G_START = ("  unsigned long long g_t0;\n"
           "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_t0));\n")

# The FM demod's split, one entry per design of demod_run's FM code: its
# (anchor, "a"fter or "b"efore, text) stamps.  ``dclk`` is the thread's
# accumulator (reads, barriers, arc tangents, and a sink that the loads are
# folded into, so that the stamp after them waits until they have landed).
# The float32 FM loop: a pair of samples a thread, no barrier.
F32_SPLIT = (
    ("    for (int j = threadIdx.x; j < len / 2; j += kThreads) {\n"
     "      const float2 a = pairs[2 * j], b = pairs[2 * j + 1];\n", "b", ""),
    ("      const long long idx = origin + 2LL * j;\n"
     "      reinterpret_cast<float2*>(env)[j] =\n", "b",
     "      dclk[3] ^= __float_as_int(a.x) ^ __float_as_int(b.y) ^ "
     "__float_as_int(before.x);\n      const long long f1 = clock64();\n"),
    ("          make_float2(fm_sample<WORD>(before, a, idx), "
     "fm_sample<WORD>(a, b, idx + 1));\n", "a",
     "      dclk[0] += f1 - f0; dclk[2] += clock64() - f1;\n"),
)
# The same loop with the stream's first sample and maximum passed on (the
# thirteenth slice's form).
F32_SPLIT_STREAMS = (
    ("      const long long idx = origin + 2LL * j;\n"
     "      reinterpret_cast<float2*>(env)[j] = make_float2(\n", "b",
     "      dclk[3] ^= __float_as_int(a.x) ^ __float_as_int(b.y) ^ "
     "__float_as_int(before.x);\n      const long long f1 = clock64();\n"),
    ("          fm_sample<WORD>(before, a, idx, first, m), "
     "fm_sample<WORD>(a, b, idx + 1, first, m));\n", "a",
     "      dclk[0] += f1 - f0; dclk[2] += clock64() - f1;\n"),
)
# The float32 FM loop as a thread a 16-byte word of two pairs in warp-wide
# rounds (since the float32 load's redesign): the same split, its first
# stamp at the top of a round.
F32_WORDS = (
    ("    for (int base = static_cast<int>(threadIdx.x) - lane; base < words; base += kThreads) {\n"
     "      const int j = base + lane;\n", "a", "      const long long f0 = clock64();\n"),
    ("      const float2 before = j == 0 ? carry : (in ? pairs[2 * j - 1] : "
     "make_float2(0.0f, 0.0f));\n", "a",
     "      dclk[3] ^= __float_as_int(p.x) ^ __float_as_int(p.w) ^ __float_as_int(before.x);\n"
     "      const long long f1 = clock64();\n"),
    ("        reinterpret_cast<float2*>(env)[j] = make_float2(v0, finish<WORD>(v.y, m));\n", "a",
     "        dclk[0] += f1 - f0; dclk[2] += clock64() - f1;\n"),
)
FM_SPLITS = {
    # Rounds of kThreads int16 words from the run's end, a block barrier a
    # round (the design before the segments below).
    "rounds": (
        ("      const int j = first + static_cast<int>(threadIdx.x);\n", "a",
         "      const long long d0 = clock64();\n"),
        ("      __syncthreads();\n      if (j < words) {\n", "b",
         "      dclk[3] ^= p.x ^ p.y ^ p.z ^ p.w ^ __float_as_int(before.x) ^"
         " __float_as_int(before.y);\n      const long long d1 = clock64();\n"),
        ("      __syncthreads();\n      if (j < words) {\n", "a",
         "        const long long d2 = clock64();\n"),
        ("                        fm_sample<WORD>(q1, q2, idx + 2), "
         "fm_sample<WORD>(q2, q3, idx + 3));\n", "a",
         "        dclk[0] += d1 - d0; dclk[1] += d2 - d1; dclk[2] += clock64() - d2;\n"),
    ) + F32_SPLIT,
    # A warp a segment of int16 words, 32 a round, no block barrier.
    "segments": (
        ("      const int j = k + lane;\n", "a", "      const long long d0 = clock64();\n"),
        ("      carry = rot;\n", "a",
         "      dclk[3] ^= p.x ^ p.y ^ p.z ^ p.w ^ rot ^ __float_as_int(before.x);\n"
         "      const long long d1 = clock64();\n"),
        ("                        finish<WORD>(fm_int16(q2, q3)));\n", "a",
         "        dclk[0] += d1 - d0; dclk[2] += clock64() - d1;\n"),
    ) + F32_SPLIT,
    # int16 words a warp a segment, float32 pairs a thread (the thirteenth
    # slice's form).
    "segments, streams": (
        ("      const int j = k + lane;\n", "a", "      const long long d0 = clock64();\n"),
        ("      carry = rot;\n", "a",
         "      dclk[3] ^= p.x ^ p.y ^ p.z ^ p.w ^ rot ^ __float_as_int(before.x);\n"
         "      const long long d1 = clock64();\n"),
        ("                        finish<WORD>(fm_int16(q2, q3), m));\n", "a",
         "        dclk[0] += d1 - d0; dclk[2] += clock64() - d1;\n"),
    ) + F32_SPLIT_STREAMS,
    # int16 words a warp a segment, float32 words a thread a 16-byte word.
    "segments, float32 words": (
        ("      const int j = k + lane;\n", "a", "      const long long d0 = clock64();\n"),
        ("      carry = rot;\n", "a",
         "      dclk[3] ^= p.x ^ p.y ^ p.z ^ p.w ^ rot ^ __float_as_int(before.x);\n"
         "      const long long d1 = clock64();\n"),
        ("                        finish<WORD>(fm_int16(q2, q3), m));\n", "a",
         "        dclk[0] += d1 - d0; dclk[2] += clock64() - d1;\n"),
    ) + F32_WORDS,
}
# Where the float32 FM loop's first stamp goes (inside its loop, at its top).
F32_LOOP = ("    for (int j = threadIdx.x; j < len / 2; j += kThreads) {\n"
            "      const float2 a = pairs[2 * j], b = pairs[2 * j + 1];\n")


def patch_demod(src: str) -> str:
    """``demod_run`` with the FM split's stamps, its accumulator passed in
    by both kernels."""
    start = src.find("__device__ __forceinline__ void demod_run(")
    end = src.find("\n}\n", start) + 3
    if start < 0 or end < 3:
        raise SystemExit("k1_clocks: the source has no demod_run")
    body = src[start:end]
    for name, stamps in FM_SPLITS.items():
        if all(anchor in body for anchor, _, _ in stamps):
            break
    else:
        raise SystemExit("k1_clocks: demod_run's FM code is none this script knows")
    for anchor, where, text in stamps:
        at = body.find(anchor)
        at = at + len(anchor) if where == "a" else at
        body = body[:at] + text + body[at:]
    if F32_LOOP in body:
        body = body.replace(F32_LOOP, F32_LOOP.replace(
            "{\n", "{\n      const long long f0 = clock64();\n", 1), 1)
    sig = body.index(") {")
    body = body[:sig] + ", long long* dclk" + body[sig:]
    src = src[:start] + body + src[end:]
    src = re.sub(r"demod_run<WORD>\(([^;]*)\);", r"demod_run<WORD>(\1, dclk);", src)
    return src.replace("  extern __shared__ __align__(16) unsigned char smem[];\n",
                       "  extern __shared__ __align__(16) unsigned char smem[];\n"
                       "  long long dclk[4] = {0, 0, 0, 0};\n")


def patched_source(src: str) -> str:
    _present(src, *FIRST_TILE)
    advance = _present(src, *ADVANCE)
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
        "  const long long k_start = clock64();\n" + G_START + "\n  for (int it = 0;; ++it) {\n", 1)
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
        advance,
        advance +
        "  if (g_stamps != nullptr && (threadIdx.x == 0 || threadIdx.x == 128)) {\n"
        + WRITE_OUT +
        "    acc[1] += acc[0];  // wait = (s1 - s0) - next\n"
        "    acc[0] -= acc[1];\n"
        "    for (int k = 0; k < 6; ++k) o[k] = acc[k];\n"
        "    o[6] = clock64() - k_start;\n    o[7] = n_tiles;\n" + WRITE_SPLIT + "  }\n", 1)
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ long long* g_stamps = nullptr;\n", 1)
    src += ("\nextern \"C\" int tt_k1_set_stamps(void* p) {\n"
            "  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));\n}\n")
    return src


# The 4-tap kernel's anchors, in order, and the stamp put before (b) or
# after (a) each.  The envelope line reads ``WORD == kIqF32`` before the
# word code took flags, ``kBase<WORD> == kIqF32`` since.
LOOP_4 = ("  for (int it = 0; t < g.n_tiles; ++it, t += gridDim.x) {\n",
          "  for (int it = 0; walk.pos < walk.end; ++it) {\n")
# The end of its loop, and (balanced walk) the step to the next tile there.
TAIL_4 = "        ++row;\n      }\n    }\n"
STEP_4 = ("", "    walk.pos = walk_next<WORD>(walk, cur);\n")
PATCHES_4 = (
    (LOOP_4, "a", "    const long long s0 = clock64();\n"),
    ("    const int b = it & 1;\n", "b", "    const long long s1 = clock64();\n"),
    ("      parity ^= 1u << b;\n    }\n", "a", "    const long long s2 = clock64();\n"),
    ("    // previous tile: its buffer takes the next tile's run.\n"
     "    __syncthreads();\n", "a", "    const long long s3 = clock64();\n"),
    # The load's start: before the inversion's maximum was read there (the
    # thirteenth slice), and since.
    (tuple(f"    float* const env = ({base} == kIqF32) ? env_pairs : "
           f"reinterpret_cast<float*>(stage);\n{m}    if (!cur.fast) {{\n      load_run_clamped"
           for base in ("kBase<WORD>", "WORD")
           for m in ("", "    const float m = stream_max<WORD, kStreams>(st, cur);\n")),
     "b", "    const long long s4 = clock64();\n"),
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
    loop = _present(body, *LOOP_4)
    for anchor, where, text in PATCHES_4:
        forms = anchor if isinstance(anchor, tuple) else tuple(
            anchor.replace("@", base) for base in ("kBase<WORD>", "WORD"))
        anchor = _present(body, *forms)
        at = body.find(anchor)
        at = at + len(anchor) if where == "a" else at
        body = body[:at] + text + body[at:]
    at = body.find(loop)
    body = (body[:at] + "  long long acc[6] = {0, 0, 0, 0, 0, 0};\n  int n_tiles = 0;\n"
            "  const long long k_start = clock64();\n" + G_START + body[at:])
    step = next((s for s in STEP_4 if body.endswith(TAIL_4 + s + "  }\n}\n")), None)
    if step is None:
        raise SystemExit("k1_clocks: the 4-tap kernel does not end as this script expects")
    body = body[: -len(TAIL_4 + step + "  }\n}\n")] + (
        TAIL_4 +
        "    const long long s6 = clock64();\n"
        "    acc[0] += s1 - s0; acc[1] += s2 - s1; acc[2] += s3 - s2; acc[3] += s4 - s3;\n"
        "    acc[4] += s5 - s4; acc[5] += s6 - s5;\n    ++n_tiles;\n" + step + "  }\n"
        "  if (g_stamps != nullptr && (threadIdx.x == 0 || threadIdx.x == 128)) {\n"
        + WRITE_OUT +
        "    for (int k = 0; k < 6; ++k) o[k] = acc[k];\n"
        "    o[6] = clock64() - k_start;\n    o[7] = n_tiles;\n" + WRITE_SPLIT + "  }\n}\n")
    return src[:start] + body + src[end:]


def build(src_path: Path) -> ctypes.CDLL:
    out_dir = ROOT / "tempest_tpu_torch" / "_build" / "exp"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "resample_clocks.cu"
    text = src_path.read_text()
    cu.write_text(patch_taps4(patched_source(patch_demod(text))))
    lib_path = out_dir / "libresample_clocks.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.has_taps4 = "catmull_rom_tiles_kernel(const void*" in text
    lib.balanced = "kBalanced" in text  # int16 FM words take the balanced walk
    lib.balanced_f32 = "constexpr bool kBalanced = kIsFm<WORD>;" in text  # and float32 ones
    lib.build_log = proc.stdout + proc.stderr
    argtypes, restype = _build.SIGNATURES["resample"]["tt_resample_frames"]
    lib.tt_resample_frames.argtypes = argtypes
    lib.tt_resample_frames.restype = restype
    lib.tt_k1_set_stamps.argtypes = [ctypes.c_void_p]
    lib.tt_k1_set_stamps.restype = ctypes.c_int
    return lib


def sass_listing(path: str) -> str:
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"cuobjdump failed on {path}: {proc.stderr[-500:]}")
    return proc.stdout


def opcode_counts(listing: str) -> dict[str, Counter]:
    """Opcodes of each function of a cuobjdump listing."""
    summary, name, ops = {}, None, Counter()
    for line in listing.splitlines():
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
    return summary


def sass_summary(lib_path: str, out: Path | None) -> dict:
    """Static SASS counts of every K1 instantiation: instructions in all and
    by opcode (cuobjdump of the shipped library)."""
    listing = sass_listing(lib_path)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(listing)
    return {k: {"total": sum(v.values()), **dict(v.most_common(24))}
            for k, v in opcode_counts(listing).items()}


# atan2f alone, as K1's float32 FM load called it before its redesign (and
# calls it outside its branchless domain), and the int16 load's atan2_int16
# (its text taken from the source): each probe's SASS less its loads, store
# and exit is what one arc tangent compiles to.  Since the float32 load's
# redesign also its two arc tangents of a word with the warp's vote
# (fm_f32_word, a sample's (y, x) given), and the domain test alone.
ATAN2_PROBES = r"""
extern "C" __global__ void atan2f_probe(const float* y, const float* x, float* o) {
  o[0] = atan2f(y[0], x[0]);
}
%s
extern "C" __global__ void atan2_int16_probe(const float* y, const float* x, float* o) {
  o[0] = atan2_int16(y[0], x[0]);
}
"""
F32_PROBES = r"""
extern "C" __global__ void fm_f32_word_probe(const float* y, const float* x, float* o) {
  const float2 v = fm_f32_word(make_float2(y[0], y[1]), make_float4(x[0], x[1], x[2], x[3]),
                               0xffffffffu);
  o[0] = v.x;
  o[1] = v.y;
}
extern "C" __global__ void atan2_in_domain_probe(const float* y, const float* x, float* o) {
  o[0] = atan2_in_domain(y[0], x[0], y[1], x[1]) ? 1.0f : 0.0f;
}
"""
# Opcodes of a probe that are not the arc tangent's: its argument loads, its
# loads, its store and exit.
PROBE_SCAFFOLD = ("LDC", "ULDC", "LDG", "STG", "EXIT", "NOP")


def probe_counts(body: list[str]) -> dict:
    """A probe function's SASS: the instructions before its first exit that
    are not the scaffold (the main path with the code of its special cases,
    which branches skip), by opcode, and those after it (slow paths that a
    call reaches)."""
    first_exit = next(k for k, ln in enumerate(body) if re.search(r"\bEXIT\b", ln))
    main_ops = Counter(re.match(r"/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                ln).group(2).split(".")[0] for ln in body[: first_exit + 1])
    arc = {op: n for op, n in main_ops.items() if op not in PROBE_SCAFFOLD}
    # After the exit: the slow paths, then the padding (a branch to itself, NOPs).
    after = [ln for ln in body[first_exit + 1:] if not re.search(r"\bNOP\b", ln)]
    last = re.match(r"/\*([0-9a-f]+)\*/\s+BRA 0x([0-9a-f]+)\b", after[-1]) if after else None
    if last and int(last.group(1), 16) == int(last.group(2), 16):
        after = after[:-1]
    return {"listing": body, "before_exit": sum(arc.values()), "opcodes": arc,
            "after_exit": len(after),
            "division": {op: main_ops.get(op, 0) for op in ("MUFU", "FCHK", "CALL", "BRA",
                                                            "BSSY", "BSYNC")}}


def atan2_sass(src_text: str) -> dict:
    """What ``atan2f`` and ``atan2_int16`` (and, where the source has them,
    ``fm_f32_word`` and ``atan2_in_domain``) compile to for sm_90a."""
    start = src_text.find("__device__ __forceinline__ float atan2_fast(")
    if start >= 0:
        # atan2_fast through fm_f32_word: the arc tangents and their helpers.
        last = src_text.index("__device__ __forceinline__ float2 fm_f32_word(", start)
        function = src_text[start: src_text.index("\n}\n", last) + 3] + F32_PROBES
    else:
        start = src_text.find("__device__ __forceinline__ float atan2_int16(")
        if start < 0:
            raise SystemExit("k1_clocks: the source has no atan2_int16")
        function = src_text[start: src_text.index("\n}\n", start) + 3]
    out_dir = ROOT / "tempest_tpu_torch" / "_build" / "exp"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "atan2_probes.cu"
    cu.write_text(ATAN2_PROBES % function)
    cubin = out_dir / "atan2_probes.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o", str(cubin), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on the arc tangent probes:\n{proc.stdout}{proc.stderr}")
    out, name = {}, None
    for ln in sass_listing(str(cubin)).splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?[A-Z]", ln):
            out[name].append(re.sub(r"\s*/\* 0x[0-9a-f]+ \*/", "", ln).strip())
    return {name: probe_counts(body) for name, body in out.items()}


def run_stamped(lib, stamps, dev, words, load, taps, starts, raster, geom) -> dict:
    """One stamped launch (after two warm-up launches) of ``load`` with
    ``taps`` taps: its phases a tile, or only whether it equals plain when
    the kernel that ran has no stamps."""
    kind, demod = LOADS[load]
    if kind == "envelope":
        env = rk.words_envelope_plain(words, "am")
        data, code = env, 0
    else:
        data = words if kind == "int16" else words.to(torch.float32)
        code = rk.word_code(data.dtype, demod)[0]
        env = rk.words_envelope_plain(data, demod)
    n_frames = starts.shape[0]
    h, w = raster[3]
    sample_bytes = rk.word_code(data.dtype)[1] if kind != "envelope" else 4
    # The balanced walk where the source has one: on int16 FM words, and
    # since the float32 FM load's redesign on every FM word.
    balanced = lib.balanced and (rk.balanced_walk(code) if lib.balanced_f32
                                 else kind == "int16" and demod == "fm")
    rows, run_cap = rk.tile_plan(*raster, sample_bytes, sum(rk.line_reach(taps, False)), taps,
                                 balanced=balanced)
    out = torch.empty((n_frames, h, w), dtype=torch.float32, device=dev)
    # One stream and no maxima (since the thirteenth slice the launcher takes
    # them after the tile plan; a checkout before it takes neither).
    streams = (() if len(lib.tt_resample_frames.argtypes) < 21
               else (None, env.shape[0], n_frames))
    cost = rk.launch_cost(env.shape[0], sample_bytes, n_frames, *raster, code, taps)
    for _ in range(3):
        stamps.zero_()
        _build.launch(
            "k1", lib.tt_resample_frames, dev, (cost,), None,
            data.data_ptr(), env.shape[0], code, starts.data_ptr(), None, n_frames, taps,
            geom.line_start.data_ptr(), geom.line_frac.data_ptr(), geom.wr.data_ptr(),
            out.data_ptr(), h, w, geom.delta, geom.span + rk.line_reach(taps, False)[1],
            rows, run_cap, *streams)
        torch.cuda.synchronize()
    equal = bool(torch.equal(out, rk.frames_to_screens_plain(env, starts, geom, None, taps)))
    s = stamps.view(-1, STRIDE).cpu().numpy()
    used = s[s[:, 7] > 0]
    if not len(used):
        return {"equal_to_plain": equal}
    phases = PHASES[4] if taps == 4 and lib.has_taps4 else PHASES[2]
    tiles = used[:, 7].astype(np.float64)
    row = {"rows_a_tile": rows, "run_cap": run_cap, "blocks": int(len(used) // 2),
           "tiles_a_block": float(tiles.mean()), "cycles_a_block": float(used[:, 6].mean()),
           "cycles_a_tile": {p: float(np.mean(used[:, k] / tiles)) for k, p in enumerate(phases)},
           "share": {p: float(used[:, k].sum() / used[:, 6].sum()) for k, p in enumerate(phases)},
           "equal_to_plain": equal}
    # The launch on the global clock: its span from the first block's start
    # to the last block's end, and how much of it the blocks lived.
    life = (used[:, 13] - used[:, 12]).astype(np.float64)
    span = float(used[:, 13].max() - used[:, 12].min())
    sm = used[:, 14]
    per_sm = np.bincount(sm[::2])   # one row of two a block
    sm_life = np.array([life[sm == k].mean() for k in np.unique(sm)])
    start = (used[:, 12] - used[:, 12].min()).astype(np.float64)
    row["timeline"] = {"span_us": span / 1e3, "block_us_mean": float(life.mean()) / 1e3,
                       "block_us_max": float(life.max()) / 1e3,
                       "block_us_p10_p50_p90": [float(np.percentile(life, q)) / 1e3
                                                for q in (10, 50, 90)],
                       "start_us_max": float(start.max()) / 1e3,
                       "tiles_a_block_max": int(tiles.max()),
                       "blocks_an_sm_min_max": [int(per_sm[per_sm > 0].min()), int(per_sm.max())],
                       "sm_mean_block_us_min_max": [float(sm_life.min()) / 1e3,
                                                    float(sm_life.max()) / 1e3],
                       "blocks_busy_share": float(life.mean() / span)}
    if demod == "fm":
        row["demod_cycles_a_tile"] = {p: float(np.mean(used[:, 8 + k] / tiles))
                                      for k, p in enumerate(DEMOD_SPLIT)}
        row["demod_share"] = {p: float(used[:, 8 + k].sum() / used[:, 6].sum())
                              for k, p in enumerate(DEMOD_SPLIT)}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=ROOT / "tempest_tpu_torch/csrc/resample.cu")
    ap.add_argument("--sass", type=Path, default=None, help="write the whole SASS here")
    ap.add_argument("--out", type=Path, default=None, help="write the results as JSON here")
    ap.add_argument("--loads", choices=("all", "fm"), default="all",
                    help="fm: the FM loads alone (int16 and float32 words)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_clocks: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    shipped = _build.load_library("resample")
    results = {"card": card, "sass": sass_summary(shipped.path, args.sass),
               "atan2": atan2_sass(args.source.read_text())}
    for name, counts in results["sass"].items():
        print(f"[sass] {name}: {counts}")
    for name, a in results["atan2"].items():
        print(f"[sass] {name} for sm_90a: {a['before_exit']} instructions before its exit "
              f"({a['opcodes']}; division and branches {a['division']}), {a['after_exit']} "
              f"after it; listing:")
        for ln in a["listing"]:
            print(f"[sass]   {ln}")
    lib = build(args.source)
    print("[build] " + " | ".join(ln.strip() for ln in lib.build_log.splitlines()
                                  if "registers" in ln or "spill" in ln)[:6000])
    stamps = torch.zeros(4096 * 2 * STRIDE, dtype=torch.int64, device=dev)
    if lib.tt_k1_set_stamps(stamps.data_ptr()) != 0:
        raise SystemExit("could not set the stamps' buffer")
    results["runs"] = {}
    rng = np.random.default_rng(0)
    loads = [k for k in LOADS if args.loads == "all" or LOADS[k][1] == "fm"]
    for where, (mode_name, fs, n_frames) in GEOMETRIES.items():
        mode = ALL_VIDEO_MODES[mode_name]
        spf = fs / mode.refresh
        frame_len = int(np.floor(spf))
        n = int(np.ceil(n_frames * spf)) + 1 + int(np.ceil(spf))
        words = torch.from_numpy(rng.integers(-20000, 20000, 2 * n).astype(np.int16)).to(dev)
        starts = torch.from_numpy(poff.carry_phase_starts(0.0, spf, n_frames)).to(dev)
        raster = (frame_len, mode.height, mode.width, (600, 800))
        geom = rk.screen_geometry(*raster, dev)
        for load in loads:
            for taps in (2, 4):
                label = f"{where}, {load}, {taps} taps"
                row = run_stamped(lib, stamps, dev, words, load, taps, starts, raster, geom)
                results["runs"][label] = row
                if "share" not in row:
                    print(f"[clocks] {label}: no stamps (a kernel this script does not patch); "
                          f"equal to plain: {row['equal_to_plain']}")
                    continue
                split = ""
                if "demod_share" in row:
                    split = "; demod split, cycles a tile " + ", ".join(
                        f"{p} {row['demod_cycles_a_tile'][p]:.0f}" for p in DEMOD_SPLIT
                    ) + ", share " + ", ".join(f"{p} {row['demod_share'][p]:.3f}"
                                               for p in DEMOD_SPLIT)
                tl = row["timeline"]
                split += (f"; timeline: span {tl['span_us']:.2f} us, a block "
                          f"{tl['block_us_mean']:.2f} us mean, {tl['block_us_max']:.2f} max "
                          f"({tl['tiles_a_block_max']} tiles "
                          f"at most), p10/p50/p90 " + "/".join(
                              f"{v:.2f}" for v in tl["block_us_p10_p50_p90"])
                          + f", last start {tl['start_us_max']:.2f} us, blocks an SM "
                          f"{tl['blocks_an_sm_min_max']}, an SM's mean block "
                          f"{tl['sm_mean_block_us_min_max'][0]:.2f}-"
                          f"{tl['sm_mean_block_us_min_max'][1]:.2f} us, busy share "
                          f"{tl['blocks_busy_share']:.3f}")
                print(f"[clocks] {label}: {row['rows_a_tile']} rows a tile, {row['blocks']} "
                      f"blocks, {row['tiles_a_block']:.2f} tiles a block, "
                      f"{row['cycles_a_block']:.0f} cycles a block; cycles a tile " + ", ".join(
                          f"{p} {v:.0f}" for p, v in row["cycles_a_tile"].items())
                      + "; share " + ", ".join(f"{p} {v:.3f}" for p, v in row["share"].items())
                      + split + f"; equal to plain: {row['equal_to_plain']}; on {card}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
