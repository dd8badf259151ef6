"""Progressive renderer CLI of the PyTorch port.

Renders a scene frame by frame, folds each frame into the running mean and
writes a PNG: `--scene analytical` (two spheres over a checker plane, the
default), `--scene sdf` (the sphere-traced SDF scene), `--scene mesh` (20
triangles: a ground quad, a metal cube, a clearcoat pyramid), `--scene
bigmesh` (a 1,088-triangle sphere over the ground), or `--scene file:PATH`
(a JSON scene file of either package's `utils/sceneio.save_scene`: its
family's scene with the file's leaves). With `--device cuda` (the default)
every frame is one launch of the CUDA megakernel K1, with the scene's
backend; with `--device cpu` it is the eager integrator. A CUDA device
that is not there is an error, never a move to the CPU. `--occupancy`
first prints the fraction of lanes alive entering each bounce: on the card
from one launch of the occupancy kernel K3, with the wasted-lane fraction
and the warps' numbers; on the CPU from the eager probe.

The host surface, as the JAX package's CLI has it: `--ckpt-dir` writes the
state (buffer, key, frame) every `--ckpt-every` frames and resumes from
the newest `ckpt_*.npz` there, the port's or one the JAX render CLI wrote;
`--metrics PATH` writes each frame's metrics as a JSON line; `--profile
DIR` writes a torch.profiler Chrome trace of the frames; `--preview`
repaints the buffer in the terminal each frame; `--serve PORT` (0: a free
port) serves the progressive render over HTTP, and the page's drag, wheel
and keys orbit, zoom, widen or reset the camera, which restarts the
accumulation.

`--mesh TILESxSPP` shards each frame over the ranks of a process group
(`parallel/mesh`), run under `python -m torch.distributed.run --standalone
--nproc-per-node N` with N = TILES x SPP: every rank renders its range of
the frame's pixels (one K1 launch on the card, both axes flattened into
the pixel axis), the ranges are summed into the whole frame, the single
launch's bit for bit, and rank 0 alone writes the PNG, the checkpoints,
the metrics, the profile and the preview and serves the viewer (whose
camera moves it hands to every rank). A mesh that is not the world size
raises before the first frame; `--mesh 1x1` is the unsharded path.

Usage:
  python -m pathtracer_tpu_torch.app.render --device cuda --scene sdf \
      --width 1920 --height 1080 --frames 16 -o out.png
  python -m pathtracer_tpu_torch.app.render --scene file:scene.json --ckpt-dir runs/a --serve 0
  python -m torch.distributed.run --standalone --nproc-per-node 2 -m pathtracer_tpu_torch.app.render \
      --mesh 2x1 --width 1920 --height 1080 --frames 16 -o out.png
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..integrator.tracer import accumulate, measure_occupancy
from ..models import families
from ..models.camera import Pinhole, orbit, zoom
from ..models.scene import Scene
from ..ops import rng
from ..ops.megakernel import measure_occupancy_megakernel, render_frame_megakernel
from ..parallel import mesh as sharding
from ..utils.buffer import ColorBuffer, new_buffer
from ..utils.checkpoint import latest_checkpoint, load_render_state, save_checkpoint
from ..utils.config import RenderConfig
from ..utils.image import ansi_preview, save_render
from ..utils.metrics import FrameMetrics, MetricsLog, Timer, trace_to
from ..utils.sceneio import load_scene
from ..utils.viewer import LiveViewer


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
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint/resume directory")
    ap.add_argument("--ckpt-every", type=int, default=8)
    ap.add_argument("--metrics", default=None, help="write per-frame metrics as JSON lines")
    ap.add_argument("--profile", default=None, help="torch.profiler Chrome trace directory")
    ap.add_argument("--preview", action="store_true", help="repaint the buffer in the terminal (ANSI) each frame")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve the progressive render over HTTP with camera controls (0: a free port)")
    ap.add_argument("--mesh", default=None, metavar="TILESxSPP",
                    help="shard each frame over a mesh of ranks, e.g. 2x1 (under torch.distributed.run)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the collectives' backend (default: NCCL when each rank owns a card, else gloo)")
    args = ap.parse_args(argv)
    if not (args.scene in families.FAMILIES or args.scene.startswith("file:")):
        ap.error(f"unknown scene {args.scene!r} (choose {'|'.join(families.FAMILIES)}|file:PATH)")
    if args.ckpt_every < 1:
        ap.error("--ckpt-every must be at least 1")
    mesh_tiles, mesh_spp = sharding.parse_mesh(args.mesh) if args.mesh else (1, 1)
    cfg = RenderConfig(
        width=args.width, height=args.height, spp=args.spp, frames=args.frames,
        depth=args.depth, seed=args.seed, precision=args.precision,
        quirks=args.quirks, device=args.device, scene=args.scene, occupancy=args.occupancy,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, metrics=args.metrics, profile=args.profile,
        preview=args.preview, serve=args.serve, mesh_tiles=mesh_tiles, mesh_spp=mesh_spp, backend=args.backend,
    )
    return cfg, args.output


def make_scene(cfg: RenderConfig, device) -> Scene:
    """The scene that cfg.scene names, on `device`: a family's demo, or the
    scene a file:PATH describes (its family's, with the file's leaves)."""
    if cfg.scene.startswith("file:"):
        return load_scene(cfg.scene[5:], dtype=cfg.dtype, recursion_depth=cfg.depth, device=device)
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
    compacted = stats["compacted_wasted_fraction"]
    log(f"  idle lanes of live warps: {stats['warp_wasted_fraction']:.3f} (per-thread loop)"
        + ("" if compacted is None else f", {compacted:.3f} (this backend's compacted loop)"))


def apply_controls(cam: Pinhole, controls: list, home: Pinhole) -> Pinhole:
    """The camera after the viewer's messages, oldest first: a drag of
    (dx, dy) pixels orbits by (-0.005 dx, 0.005 dy) radians, a wheel step
    zooms by its factor, a key widens or narrows the fov by its degrees, and
    reset returns to `home`."""
    for c in controls:
        if "orbit" in c:
            dx, dy = c["orbit"]
            cam = orbit(cam, -0.005 * float(dx), 0.005 * float(dy))
        if "zoom" in c:
            cam = zoom(cam, float(c["zoom"]))
        if "fov" in c:
            cam = cam.set_fov(cam.fov + float(c["fov"]))
        if c.get("reset"):
            cam = home
    return cam


def render(cfg: RenderConfig, output: str, log=print) -> ColorBuffer:
    """Render frames up to cfg.frames (from a checkpoint's frame when
    cfg.ckpt_dir holds one), write the PNG, return the accumulated buffer.
    With a mesh (cfg.sharded) this process is one rank of the process group
    that torch.distributed.run (or the PT_* variables) describe: every rank
    renders its range of each frame and returns the whole buffer, and rank
    0 alone writes, logs and serves."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {cfg.device}: CUDA is not available")
    mesh = None
    if cfg.sharded:
        from ..parallel.launch import initialize

        device = initialize(backend=cfg.backend, device=cfg.device, log=log)
        mesh = sharding.make_mesh(cfg.mesh_tiles, cfg.mesh_spp)
        if mesh.rank != 0:
            log = lambda s: None  # noqa: E731
    lead = mesh is None or mesh.rank == 0
    scene = make_scene(cfg, device)
    home = scene.camera.unpack()
    buf = new_buffer(cfg.width, cfg.height, cfg.dtype, device)
    key = rng.prng_key(cfg.seed)
    start = 0
    if cfg.ckpt_dir:
        if lead:
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
        path = latest_checkpoint(cfg.ckpt_dir)
        if path:
            buf, key, start = load_render_state(path, (buf, key, 0))
            log(f"resumed from {path} at frame {start}")
    if cfg.occupancy and lead:
        log_occupancy(cfg, scene, key, log)
    viewer = None
    if cfg.serve is not None and lead:
        viewer = LiveViewer(port=cfg.serve)
        log(f"live view: http://localhost:{viewer.port}/")
    metrics = MetricsLog()
    try:
        with trace_to(cfg.profile if lead else None, device):
            for f in range(start, cfg.frames):
                key, sub = rng.split(key)
                t = Timer()
                if mesh is None:
                    frame = render_frame_megakernel(scene, sub, cfg.width, cfg.height, cfg.spp, cfg.quirk_flags)
                else:
                    frame = sharding.render_frame_sharded_megakernel(scene, sub, mesh, cfg.width, cfg.height, cfg.spp,
                                                                     cfg.quirk_flags)
                buf = ColorBuffer(*accumulate(buf.pixels, frame, buf.frames))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                ms = t.stop()
                metrics.record(FrameMetrics(cfg.width, cfg.height, cfg.spp, cfg.depth, ms))
                if cfg.serve is not None:
                    controls = None
                    if viewer is not None:
                        viewer.update(buf.pixels)
                        controls = viewer.pop_controls()
                    if mesh is not None:  # every rank renders the view rank 0's viewer asked for
                        controls = sharding.broadcast_object(controls, mesh)
                    if controls:  # a new view: the accumulation starts again
                        scene = scene.replace(camera=apply_controls(scene.camera.unpack(), controls, home))
                        buf = new_buffer(cfg.width, cfg.height, cfg.dtype, device)
                if cfg.preview and lead:  # home the cursor and repaint in place
                    sys.stdout.write("\x1b[H\x1b[2J" if f == start else "\x1b[H")
                    sys.stdout.write(ansi_preview(buf.pixels) + "\n")
                log(f"frame {f + 1}/{cfg.frames}  {ms:8.1f} ms")
                if lead and cfg.ckpt_dir and (f + 1) % cfg.ckpt_every == 0:
                    save_checkpoint(os.path.join(cfg.ckpt_dir, f"ckpt_{f + 1:06d}.npz"), (buf, key, f + 1))
    finally:
        if viewer is not None:
            viewer.close()
    if not lead:
        return buf
    encoder = save_render(output, buf.pixels)
    log(f"wrote {output} (encoder: {encoder})")
    s = metrics.summary()
    if s:
        log(f"avg {s['avg_frame_ms']:.1f} ms/frame, {s['rays_per_s'] / 1e6:.2f} Mrays/s (primary)")
    if cfg.metrics:
        metrics.dump_jsonl(cfg.metrics)
    return buf


def main(argv=None) -> int:
    cfg, output = parse_args(argv)
    render(cfg, output)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
