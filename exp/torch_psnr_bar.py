"""PSNR bars for ``chip_smoke.py``: the JAX package's chains on the CPU, on
the smoke's own capture and frame grid.

The smoke runs ``N_BLOCKS`` 36-frame blocks of a synthetic 1080p60 capture at
20 Msps through the port's streaming runtime and holds the aligned PSNR of
the final EMA against a bar: the PSNR the JAX package reaches on the same
int16-quantised capture, less 0.3 dB.  This script computes that reference
with ``resampler="gather"`` on the CPU (not a device number), on the same
absolute frame grid, in 4-frame carry-phase sub-blocks so that the JAX
program and its float32 frame positions stay small:

* ``--chain fidelity``: sub-sample-exact cuts, per-frame sync skipped (the
  runtime's ``fidelity=True``);
* ``--chain default``: rounded cuts, sub-pixel sync, linear alignment.

Run: ``python exp/torch_psnr_bar.py --chain fidelity``; prints one JSON line.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

import tempest_tpu as tt  # noqa: E402
from tempest_tpu.ops.resample import downgrade_image  # noqa: E402
from tempest_tpu.pipeline.offline import ReconstructionConfig, make_reconstruct_fn  # noqa: E402
from tempest_tpu.render.screen import aligned_psnr  # noqa: E402

MODE_NAME = "1920x1080 @ 60Hz"
SAMPLE_RATE = 20e6
N_FRAMES = 36
N_BLOCKS = 3
ALPHA = 0.1
SNR_DB = 18.0
SEED = 33
INT16_SCALE = 8192.0
SUB_FRAMES = 4


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chain", choices=("fidelity", "default"), default="fidelity")
    args = parser.parse_args()
    fidelity = args.chain == "fidelity"

    mode = tt.ALL_VIDEO_MODES[MODE_NAME]
    spf = SAMPLE_RATE / mode.refresh
    block = int(np.ceil(spf * N_FRAMES)) + 1 + int(np.ceil(spf))
    n = N_BLOCKS * block + int(np.ceil(spf)) + 1
    cap = tt.generate_iq(mode, SAMPLE_RATE, n, snr_db=SNR_DB, seed=SEED)
    words = np.clip(np.round(cap.iq.view(np.float32) * INT16_SCALE), -32768, 32767)
    words = words.astype(np.int16)

    cfg = ReconstructionConfig(
        sample_rate=SAMPLE_RATE, mode=mode, n_frames=SUB_FRAMES, carry_phase=True,
        input_format="iq_interleaved", resampler="gather",
        subsample_align=fidelity, do_align=not fidelity, align_subpixel=not fidelity)
    step = make_reconstruct_fn(cfg)
    sub = cfg.block_samples
    ema = jnp.zeros(cfg.render_size, jnp.float32)
    for b in range(N_BLOCKS):
        abs_pos = b * block
        phase = (-abs_pos) % spf
        for k in range(0, N_FRAMES, SUB_FRAMES):
            exact = abs_pos + phase + k * spf   # float64: the runtime's frame grid
            origin = int(np.floor(exact))
            chunk = words[2 * origin: 2 * (origin + sub)]
            if chunk.size < 2 * sub:
                chunk = np.concatenate([chunk, np.zeros(2 * sub - chunk.size, np.int16)])
            ema, _, _, _ = step(jnp.asarray(chunk), ema, jnp.float32(ALPHA), exact - origin)
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame), cfg.render_size))
    db, shift = aligned_psnr(truth, np.asarray(ema))
    print(json.dumps({"chain": args.chain, "psnr_db": float(db), "shift": [int(s) for s in shift],
                      "bar_db": float(db) - 0.3, "backend": jax.default_backend()}))


if __name__ == "__main__":
    main()
