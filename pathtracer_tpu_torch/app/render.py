"""Progressive renderer CLI of the PyTorch port.

Renders the analytical demo scene frame by frame, folds each frame into
the running mean and writes a PNG. With `--device cuda` every frame is one
launch of the CUDA megakernel; with `--device cpu` it is the eager
integrator. A CUDA device that is not there is an error, never a move to
the CPU.

Usage:
  python -m pathtracer_tpu_torch.app.render --device cuda \
      --width 1920 --height 1080 --frames 16 -o out.png
"""

from __future__ import annotations

import argparse
import time

import torch

from ..integrator.tracer import accumulate
from ..models.analytical import make_scene
from ..ops import rng
from ..ops.megakernel import render_frame_megakernel
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
    ap.add_argument("--quirks", choices=["verbatim", "fixed"], default="verbatim")
    ap.add_argument("--precision", choices=["f32", "f64"], default="f32")
    ap.add_argument("--device", default="cpu", help="cpu | cuda | cuda:N")
    ap.add_argument("-o", "--output", default="render.png")
    args = ap.parse_args(argv)
    cfg = RenderConfig(
        width=args.width, height=args.height, spp=args.spp, frames=args.frames,
        depth=args.depth, seed=args.seed, precision=args.precision,
        quirks=args.quirks, device=args.device,
    )
    return cfg, args.output


def render(cfg: RenderConfig, output: str, log=print) -> ColorBuffer:
    """Render cfg.frames progressive frames, write the PNG, return the
    accumulated buffer."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {cfg.device}: CUDA is not available")
    scene = make_scene(dtype=cfg.dtype, recursion_depth=cfg.depth, device=device)
    buf = new_buffer(cfg.width, cfg.height, cfg.dtype, device)
    key = rng.prng_key(cfg.seed)
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
