"""Inverse-rendering CLI of the PyTorch port: recover scene parameters from
a render.

Recovers scene parameters from a target image by descending through the
differentiable renderer: `--scene analytical` (the default) the material
albedo, roughness and light emission of the analytical demo scene,
`--scene sdf` the geometry (sphere radius, torus major radius) and the
light emission of the sphere-traced SDF scene. With `--device cuda` (the
default) each step is two launches of the forward megakernel K1 and one of
the backward megakernel K2, with the scene's backend; with `--device cpu`
it is the eager integrator. A CUDA device that is not there is an error,
never a move to the CPU.

`--mesh TILESxSPP` shards every render over the ranks of a process group
(`integrator/inverse.recover_demo(mesh=)`), run under `python -m
torch.distributed.run --standalone --nproc-per-node N`, N = TILES x SPP:
each rank renders its range of the pixels (on the card K1 forward and K2
backward over it), the gradients and the loss are summed over the ranks,
and rank 0 alone prints, writes the checkpoints and the report. A mesh
that is not the world size raises before the first step.

Usage:
  python -m pathtracer_tpu_torch.app.invert                     # the card
  python -m pathtracer_tpu_torch.app.invert --scene sdf         # geometry, on the card
  python -m pathtracer_tpu_torch.app.invert --device cpu --width 32 --height 16 --steps 3
  python -m pathtracer_tpu_torch.app.invert --ckpt-dir /tmp/inv  # checkpoint + resume
  python -m torch.distributed.run --standalone --nproc-per-node 2 -m pathtracer_tpu_torch.app.invert --mesh 2x1
"""

from __future__ import annotations

import argparse
import json

import torch

from ..integrator.inverse import DEMO_SELECTS, KERNELS, recover_demo
from ..ops import rng
from ..parallel import mesh as sharding


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--scene", choices=tuple(DEMO_SELECTS), default="analytical",
                    help="analytical: recover albedo, roughness and emission; sdf: recover the geometry (sphere "
                    "radius, torus major radius) and the emission through implicit-function gradients")
    ap.add_argument("--kernel", choices=KERNELS, default="megakernel",
                    help="megakernel: K1 + K2 on a CUDA device; eager: the eager integrator")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    ap.add_argument("--json-out", default=None, help="write the recovery report as JSON to this path")
    ap.add_argument("--mesh", default=None, metavar="TILESxSPP",
                    help="shard every render over a mesh of ranks, e.g. 2x1 (under torch.distributed.run)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the collectives' backend (default: NCCL when each rank owns a card, else gloo)")
    return ap.parse_args(argv)


def main(argv=None, log=print) -> int:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")
    device, mesh = args.device, None
    tiles, spp = sharding.parse_mesh(args.mesh) if args.mesh else (1, 1)
    if tiles * spp > 1:
        from ..parallel.launch import initialize

        device = initialize(backend=args.backend, device=args.device, log=log)
        mesh = sharding.make_mesh(tiles, spp)
    report = recover_demo(
        key=rng.prng_key(args.seed), scene=args.scene, width=args.width, height=args.height, steps=args.steps,
        spp=args.spp, lr=args.lr, kernel=args.kernel, mesh=mesh, ckpt_dir=args.ckpt_dir,
        recursion_depth=args.depth, device=device, verbose=True,
    )
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if mesh is not None and mesh.rank != 0:
        return 0
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({
                "rows": [r._asdict() for r in report.rows],
                "losses": [float(x) for x in report.losses],
            }, f, indent=2)
        log(f"wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
