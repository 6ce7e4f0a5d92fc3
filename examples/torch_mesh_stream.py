"""Live streaming over a device mesh with the PyTorch/CUDA port: the mesh
runtime splits every block of a synthetic 640x480@60 stream into time
spans, one a shard, over the CUDA cards that are visible, and prints the
mesh's health after a few dispatches.

Usage:
    python examples/torch_mesh_stream.py [--shards N] [--device cpu|cuda:0]

With no option the mesh has one shard a visible card (the script fails when
there is none).  ``--shards N --device D`` puts N shards on the one device D
instead: ``--device cpu`` runs it on the CPU, ``--device cuda:0`` runs the
mesh's code on one card.  For one process a card, call
``tempest_tpu_torch.parallel.distributed.initialize()`` under torchrun and
pass ``global_mesh()`` (see the README).
"""

import argparse
import sys

sys.path.insert(0, ".")  # run from the repo root

import tempest_tpu_torch as tp  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the mesh (default: one a visible card)")
    ap.add_argument("--device", default=None,
                    help="put every shard on this device ('cpu', 'cuda:0')")
    ap.add_argument("--dispatches", type=int, default=3)
    args = ap.parse_args(argv)

    if args.device is None:
        mesh = tp.make_mesh(args.shards)
    else:
        mesh = tp.make_mesh(devices=[args.device] * (args.shards or 2))
    n = mesh.shape["blocks"]
    mode = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
    fs = 8e6
    span = int(fs * 0.1)                       # 0.1 s a shard: 4 frames of 133,333 samples
    src = tp.SyntheticSource(mode, fs, block_size=n * span, snr_db=20.0, seed=7)
    rt = tp.MeshStreamingRuntime(src, mode, mesh, alpha=0.4)
    rt.start()
    try:
        image = rt.process_blocks(args.dispatches)
    finally:
        rt.stop()
    print(f"{mesh}: {image.dispatched} dispatches, {rt.frames_out} frames, "
          f"image {image.shape[1]}x{image.shape[0]}")
    print("mesh health:", rt.health()["mesh"])
    print("collectives' bytes:", dict(mesh.comm.nbytes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
