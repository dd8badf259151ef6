#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (Hopper, sm_90a).

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each of
which raises on failure (non-zero exit):

1. card: name and power limit (nvidia-smi), torch and nvcc versions;
2. build: the CUDA kernels of pathtracer_tpu_torch/csrc, timed;
3. kernel vs its plain PyTorch version on the card, depth 4: 320x240 at
   spp 1 and 2 VERBATIM and spp 1 FIXED, and the main path's 1920x1080;
4. kernel vs the committed JAX render tests/golden_torch/analytical_64x48_d4_k3.npy;
5. main path: the port's CLI renders 8 progressive 1920x1080 depth-4
   frames to a PNG; every frame must be one kernel launch. Then per-frame
   times (CUDA events, after a warm-up) of the kernel's wrapper
   render_frame_megakernel (scene pack, key upload, launch), of the
   launch alone, and of the plain version.

Image tolerance (phases 3 and 4): quantile(|diff|, 0.999) < 1e-4 and
mean(|diff|) < 1e-5, all values finite. The two sides draw the same
threefry numbers, so they differ only by float rounding (FMA contraction,
libm ulps), which can flip a rare knife-edge branch in a few pixels.

The last stdout line is {"ok": true, "device": {...}}; the line before it
lists the kernels as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "analytical_64x48_d4_k3.npy")
Q_TOL, MEAN_TOL = 1e-4, 1e-5
MAIN_W, MAIN_H, MAIN_DEPTH, MAIN_FRAMES = 1920, 1080, 4, 8


def image_diff(a, b) -> dict:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.abs(a - b)
    return dict(
        q999=float(np.quantile(d, 0.999)), mean=float(d.mean()), max=float(d.max()),
        finite=bool(np.isfinite(a).all() and np.isfinite(b).all()),
    )


def check_diff(label: str, d: dict) -> None:
    print(f"  {label}: q0.999={d['q999']:.3e} mean={d['mean']:.3e} max={d['max']:.3e} finite={d['finite']}")
    if not (d["finite"] and d["q999"] < Q_TOL and d["mean"] < MEAN_TOL):
        raise AssertionError(f"{label}: outside tolerance (q0.999 < {Q_TOL}, mean < {MEAN_TOL})")


def time_frames(torch, fn, n: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pathtracer_tpu_torch.app import render as cli
    from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
    from pathtracer_tpu_torch.models.analytical import make_scene
    from pathtracer_tpu_torch.ops import _build, rng
    from pathtracer_tpu_torch.ops import megakernel as mk

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== 1. card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(f"  {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {nvcc.stdout.strip().splitlines()[-1]}")

    print("== 2. build")
    t0 = time.perf_counter()
    _build.load()
    print(f"  built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    scene = make_scene(device=dev)
    max_err = 0.0

    print("== 3. kernel vs plain version on the card (depth 4)")
    for w, h, spp, quirks, seed in ((320, 240, 1, VERBATIM, 11), (320, 240, 2, VERBATIM, 12),
                                    (320, 240, 1, FIXED, 13), (MAIN_W, MAIN_H, 1, VERBATIM, 14)):
        label = f"{w}x{h} spp{spp} {'VERBATIM' if quirks == VERBATIM else 'FIXED'}"
        key = rng.prng_key(seed)
        img = mk.render_frame_megakernel(scene, key, w, h, spp, quirks)
        ref = mk.render_frame_reference(scene, key, w, h, spp, quirks)
        torch.cuda.synchronize()
        d = image_diff(img.cpu(), ref.cpu())
        max_err = max(max_err, d["max"])
        check_diff(label, d)

    print("== 4. kernel vs the JAX render fixture (64x48, depth 4, PRNGKey(3))")
    img = mk.render_frame_megakernel(scene, rng.prng_key(3), 64, 48)
    check_diff("vs JAX", image_diff(img.cpu(), np.load(FIXTURE)))

    print(f"== 5. main path: CLI, {MAIN_W}x{MAIN_H}, depth {MAIN_DEPTH}, {MAIN_FRAMES} frames")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render.png")
        mk.render_frame_megakernel.launches = 0
        cfg, _ = cli.parse_args([
            "--device", "cuda", "--width", str(MAIN_W), "--height", str(MAIN_H),
            "--depth", str(MAIN_DEPTH), "--spp", "1", "--frames", str(MAIN_FRAMES), "-o", png,
        ])
        buf = cli.render(cfg, png, log=lambda s: print("  " + s))
        launches = mk.render_frame_megakernel.launches
        pixels = buf.pixels.cpu().numpy()
        if not os.path.getsize(png) > 0:
            raise AssertionError("no PNG written")
    print(f"  launches={launches}  mean rgb={pixels[..., :3].mean():.4f}")
    if launches != MAIN_FRAMES:
        raise AssertionError(f"expected {MAIN_FRAMES} kernel launches, got {launches}")
    if pixels.shape != (MAIN_H, MAIN_W, 4) or not np.isfinite(pixels).all():
        raise AssertionError("main-path image is not finite or has the wrong shape")
    if not pixels[..., :3].max() > 0.05:
        raise AssertionError("main-path image is black")

    main_scene = make_scene(recursion_depth=MAIN_DEPTH, device=dev)
    key = rng.prng_key(5)
    ms = time_frames(torch, lambda: mk.render_frame_megakernel(main_scene, key, MAIN_W, MAIN_H), 20)
    prepared = mk.prepare_launch(main_scene, key, MAIN_W, MAIN_H, 1, VERBATIM)
    launch_ms = time_frames(torch, lambda: mk.launch(prepared), 20)
    plain_ms = time_frames(torch, lambda: mk.render_frame_reference(main_scene, key, MAIN_W, MAIN_H), 2)
    segs = MAIN_W * MAIN_H * MAIN_DEPTH
    print(f"  wrapper {ms:.3f} ms/frame (kernel launch alone {launch_ms:.3f} ms), "
          f"plain {plain_ms:.3f} ms/frame ({card})")
    print(f"  ray segments/s: kernel {segs / ms * 1e3:.4e}, plain {segs / plain_ms * 1e3:.4e} ({card})")

    kernels = [dict(
        name="megakernel_fwd", route="cuda", source="pathtracer_tpu_torch/csrc/megakernel_fwd.cu",
        replaces="pathtracer_tpu/ops/megakernel.py:1605", launches=launches,
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
    )]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
