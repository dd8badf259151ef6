"""Progressive renderer CLI of the PyTorch port.

Renders a demo scene frame by frame, folds each frame into the running
mean and writes a PNG: `--scene analytical` (two spheres over a checker
plane, the default), `--scene sdf` (the sphere-traced SDF scene), `--scene
mesh` (20 triangles: a ground quad, a metal cube, a clearcoat pyramid) or
`--scene bigmesh` (a 1,088-triangle sphere over the ground). With
`--device cuda` (the default) every frame is one launch of the CUDA
megakernel, with the scene's backend; with `--device cpu` it is the eager
integrator. A CUDA device that is not there is an error, never a move to
the CPU. `--occupancy` first prints the fraction of lanes alive entering
each bounce: on the card from one launch of the occupancy kernel K3, with
the wasted-lane fraction and the warps' numbers; on the CPU from the eager
probe.

Usage:
  python -m pathtracer_tpu_torch.app.render --device cuda --scene sdf \
      --width 1920 --height 1080 --frames 16 -o out.png
"""

from __future__ import annotations

import argparse
import time

import torch

from ..integrator.tracer import accumulate, measure_occupancy
from ..models import families
from ..models.scene import Scene
from ..ops import rng
from ..ops.megakernel import measure_occupancy_megakernel, render_frame_megakernel
from ..utils.buffer import ColorBuffer, new_buffer
from ..utils.config import RenderConfig
from ..utils.image import save_render


def parse_args(argv=None) -> tuple[RenderConfig, str]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default="analytical", help=" | ".join(families.FAMILIES))
    ap.add_argument("--quirks", choices=["verbatim", "fixed"], default="verbatim")
    ap.add_argument("--precision", choices=["f32", "f64"], default="f32")
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    ap.add_argument("-o", "--output", default="render.png")
    ap.add_argument("--occupancy", action="store_true",
                    help="print the alive-lane fraction entering each bounce before rendering")
    args = ap.parse_args(argv)
    if not (args.scene in families.FAMILIES or args.scene.startswith("file:")):
        ap.error(f"unknown scene {args.scene!r} (choose {'|'.join(families.FAMILIES)})")
    cfg = RenderConfig(
        width=args.width, height=args.height, spp=args.spp, frames=args.frames,
        depth=args.depth, seed=args.seed, precision=args.precision,
        quirks=args.quirks, device=args.device, scene=args.scene, occupancy=args.occupancy,
    )
    return cfg, args.output


def make_scene(cfg: RenderConfig, device) -> Scene:
    """The demo scene that cfg.scene names, on `device`."""
    if cfg.scene.startswith("file:"):
        raise NotImplementedError("--scene file:PATH: scene files are not ported yet (ROADMAP item 15)")
    return families.make_family_scene(cfg.scene, dtype=cfg.dtype, recursion_depth=cfg.depth, device=device)


def log_occupancy(cfg: RenderConfig, scene: Scene, key, log=print) -> None:
    """The fraction of lanes alive entering each bounce of a frame from
    `key`: on the card one launch of K3, on the CPU the eager probe."""
    bounces = lambda xs, fmt=".3f": "  " + "  ".join(f"b{i}: {float(x):{fmt}}" for i, x in enumerate(xs))
    if scene.device.type == "cpu":
        log("bounce occupancy (alive-lane fraction entering each bounce):")
        log(bounces(measure_occupancy(scene, key, cfg.width, cfg.height, cfg.spp, cfg.quirk_flags)))
        return
    stats = measure_occupancy_megakernel(scene, key, cfg.width, cfg.height, cfg.spp, cfg.quirk_flags)
    log(f"kernel occupancy (alive-lane fraction entering each bounce, {stats['num_tiles']} blocks x "
        f"{stats['tile']} lanes):")
    log(bounces(stats["alive_fraction"]))
    log(f"  wasted-lane fraction (compaction ceiling): {stats['wasted_fraction']:.3f}")
    log("  warps with a live lane:" + bounces(stats["warp_alive_fraction"]))
    log("  live lanes per live warp:" + bounces(stats["warp_lanes"], ".2f"))
    log(f"  idle lanes of live warps: {stats['warp_wasted_fraction']:.3f}")


def render(cfg: RenderConfig, output: str, log=print) -> ColorBuffer:
    """Render cfg.frames progressive frames, write the PNG, return the
    accumulated buffer."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {cfg.device}: CUDA is not available")
    scene = make_scene(cfg, device)
    buf = new_buffer(cfg.width, cfg.height, cfg.dtype, device)
    key = rng.prng_key(cfg.seed)
    if cfg.occupancy:
        log_occupancy(cfg, scene, key, log)
    for f in range(cfg.frames):
        key, sub = rng.split(key)
        t0 = time.perf_counter()
        frame = render_frame_megakernel(scene, sub, cfg.width, cfg.height, cfg.spp, cfg.quirk_flags)
        buf = ColorBuffer(*accumulate(buf.pixels, frame, buf.frames))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log(f"frame {f + 1}/{cfg.frames}  {(time.perf_counter() - t0) * 1e3:8.1f} ms")
    save_render(output, buf.pixels)
    log(f"wrote {output}")
    return buf


def main(argv=None) -> int:
    cfg, output = parse_args(argv)
    render(cfg, output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
