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

Usage:
  python -m pathtracer_tpu_torch.app.invert                     # the card
  python -m pathtracer_tpu_torch.app.invert --scene sdf         # geometry, on the card
  python -m pathtracer_tpu_torch.app.invert --device cpu --width 32 --height 16 --steps 3
  python -m pathtracer_tpu_torch.app.invert --ckpt-dir /tmp/inv  # checkpoint + resume
"""

from __future__ import annotations

import argparse
import json

import torch

from ..integrator.inverse import DEMO_SELECTS, KERNELS, recover_demo
from ..ops import rng


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
    return ap.parse_args(argv)


def main(argv=None, log=print) -> int:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")
    report = recover_demo(
        key=rng.prng_key(args.seed), scene=args.scene, width=args.width, height=args.height, steps=args.steps,
        spp=args.spp, lr=args.lr, kernel=args.kernel, ckpt_dir=args.ckpt_dir,
        recursion_depth=args.depth, device=args.device, verbose=True,
    )
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
