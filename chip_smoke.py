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
6. the backward kernel K2 vs its plain version (autograd of the eager
   frame rendered from the same packed scene) on the card: d(sum(ct *
   frame))/d(sv) for a numpy-seeded cotangent at 320x240, depth 4, spp 1
   and 2 VERBATIM and spp 1 FIXED, and at 1920x1080 when the plain
   version's peak memory, measured at 320x240 and scaled, fits;
7. K2 vs the committed JAX gradient
   tests/golden_torch/grad_analytical_64x48_d4_k3.npz, through the
   autograd Function and pack_scene to the scene leaves;
8. the trainer: the port's invert CLI at 256x192, depth 4, 10 steps, where
   every step must be 2 launches of K1 and 1 of K2 (the target 4 of K1)
   and the loss must fall; then the kernel path's first 3 losses against
   the eager path's on the card at 64x48;
9. times (CUDA events, after a warm-up) at 1920x1080, depth 4, spp 1: one
   training step through the kernels, K2's launch alone, and the plain
   version's step and gradient.

Image tolerance (phases 3 and 4): quantile(|diff|, 0.999) < 1e-4 and
mean(|diff|) < 1e-5, all values finite. The two sides draw the same
threefry numbers, so they differ only by float rounding (FMA contraction,
libm ulps), which can flip a rare knife-edge branch in a few pixels.

Gradient tolerance (phase 6), at every size: with the cotangent zeroed at
the knife-edge pixels (where the two forward frames differ by more than
1e-3: a branch taken the other way, so K2 differentiates K1's path and the
plain version another), max|g_k - g_p| <= 1e-2 max|g_p|, and entries
above 1e-2 max|g_p| agree to rtol 2e-2. Both are float32 sums over up to
2M pixels in another order. The numbers over all pixels are printed
beside. Phase 7: the tolerances of tests/test_torch_grad.py (rtol 5e-3 /
atol 1e-8 for material and light leaves, rtol 1e-2 / atol 1e-7 for
geometry and camera).

The last stdout line is {"ok": true, "device": {...}}; the line before it
is the card's name and power limit, and the one before that lists the
kernels as JSON.
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
GRAD_FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "grad_analytical_64x48_d4_k3.npz")
Q_TOL, MEAN_TOL = 1e-4, 1e-5
GRAD_MAX_TOL, GRAD_RTOL, EDGE_TOL = 1e-2, 2e-2, 1e-3
MAIN_W, MAIN_H, MAIN_DEPTH, MAIN_FRAMES = 1920, 1080, 4, 8
TRAIN_W, TRAIN_H, TRAIN_STEPS = 256, 192, 10
FIXTURE_LEAVES = (
    [f"lights.emission.{c}" for c in "xyz"] + [f"params.materials.rgb.{c}" for c in "xyz"]
    + ["params.materials.roughness", "params.sphere_center.x", "camera.origin.z"]
)
# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W): float32 and
# float64 outside the tensor cores, and device memory.
PEAK_F32, PEAK_F64, PEAK_BYTES = 67e12, 34e12, 3.35e12
# Operations per ray segment (one bounce entered by a live path), estimated
# by reading the per-thread code for the demo scene (one light, three
# primitives) on the shading path, not counted by a profiler. K1: ~1430
# float32 operations (closest hit ~60, emitter pass ~40, NEE ~510 of which
# disney_eval ~330, disney_sample ~275, the rest ~60) plus threefry2x32's
# ~86 integer operations for each of 6 uniforms (~516, counted at the
# float32 rate), and ~100 float64 ones (five sphere tests of ~20: two in
# the closest hit, the light in the emitter pass, two in the shadow ray).
# K2: what the gradient needs, the forward above plus its adjoint (~2560
# float32: disney_eval's ~1000, disney_sample's ~500, the light sample and
# shadow ray ~260, geometry and the rest ~800; ~45 float64 in the hit
# sphere's adjoint), not the replays this design adds. Each camera ray
# takes ~30 float64 operations more per pixel.
K1_OPS = dict(f32=1430, f64=100)
K2_OPS = dict(f32=1430 + 2560, f64=100 + 45)
CAMERA_F64_OPS = 30


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


def grad_diff(g, r) -> dict:
    g = np.asarray(g, np.float64).ravel()
    r = np.asarray(r, np.float64).ravel()
    scale = np.abs(r).max()
    big = np.abs(r) > 1e-2 * scale
    return dict(
        max_abs=float(np.abs(g - r).max()), max_rel=float(np.abs(g - r).max() / scale),
        big_rel=float((np.abs(g - r)[big] / np.abs(r[big])).max()),
        finite=bool(np.isfinite(g).all() and np.isfinite(r).all()),
    )


def leaf_close(got, want, name) -> bool:
    """tests/test_torch_grad.py's fixture tolerances."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if name.startswith(("params.sphere", "camera")):
        atol, rtol = 1e-7, 1e-2
    else:
        atol, rtol = 1e-8, 5e-3
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def bound(segments: int, pixels: int, nbytes: int, ops: dict) -> tuple[float, str]:
    """The least time the card could take, ms: the larger of the operations
    over their type's peak and the bytes over the memory rate."""
    t_ops = (segments * ops["f32"] / PEAK_F32
             + (segments * ops["f64"] + pixels * CAMERA_F64_OPS) / PEAK_F64)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def count_segments(torch, scene, key, width: int, height: int) -> int:
    """Ray segments of one spp-1 frame (bounces entered by a live path),
    from the plain version on the same threefry numbers."""
    from pathtracer_tpu_torch.integrator import tracer as T
    from pathtracer_tpu_torch.models.camera import gen_ray, pixel_coords
    from pathtracer_tpu_torch.ops.vecmath import V2

    with torch.no_grad():
        cam_u, bounce_u = T.draw_uniforms(key, width * height, scene.recursion_depth, torch.float32, scene.device)
        coords = pixel_coords(width, height, torch.float64, scene.device)
        ro, rd = gen_ray(scene.camera.unpack(), coords, V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height))
        state = T.init_state(ro, rd, T.VERBATIM)
        step = T.make_bounce_step(scene, T.VERBATIM, detach=True)
        alive = []
        for u in bounce_u:
            alive.append(state.alive.sum())
            state = step(state, u)
        return int(torch.stack(alive).sum())


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
    from pathtracer_tpu_torch.app import invert as invert_cli
    from pathtracer_tpu_torch.app import render as cli
    from pathtracer_tpu_torch.integrator import inverse
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
    _build.load("megakernel_fwd")
    _build.load("megakernel_bwd")
    print(f"  built (one nvcc per kernel, side by side) and loaded in {time.perf_counter() - t0:.1f} s")
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
        mk.render_frame_megakernel.launches = mk.render_frame_megakernel.bwd_launches = 0
        cfg, _ = cli.parse_args([
            "--device", "cuda", "--width", str(MAIN_W), "--height", str(MAIN_H),
            "--depth", str(MAIN_DEPTH), "--spp", "1", "--frames", str(MAIN_FRAMES), "-o", png,
        ])
        buf = cli.render(cfg, png, log=lambda s: print("  " + s))
        launches = mk.render_frame_megakernel.launches
        if mk.render_frame_megakernel.bwd_launches:
            raise AssertionError("the forward render launched the backward kernel")
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

    main_segments = count_segments(torch, main_scene, key, MAIN_W, MAIN_H)
    n_sv = prepared.sv.shape[1]
    fwd_bound, fwd_bound_by = bound(main_segments, MAIN_W * MAIN_H, n_sv * 4 + 16 + MAIN_W * MAIN_H * 16, K1_OPS)
    print(f"  ray segments {main_segments} ({main_segments / (MAIN_W * MAIN_H):.3f} per pixel); "
          f"bound {fwd_bound:.4f} ms ({fwd_bound_by})")

    print("== 6. backward kernel K2 vs its plain version on the card (depth 4)")
    free_bytes, total_bytes = torch.cuda.mem_get_info(dev)
    bwd_err, peak_320 = 0.0, None
    cases = [(320, 240, 1, VERBATIM, 21), (320, 240, 2, VERBATIM, 22), (320, 240, 1, FIXED, 23),
             (MAIN_W, MAIN_H, 1, VERBATIM, 24)]
    for w, h, spp, quirks, seed in cases:
        label = f"{w}x{h} spp{spp} {'VERBATIM' if quirks == VERBATIM else 'FIXED'}"
        if w == MAIN_W:
            need = peak_320 * (MAIN_W * MAIN_H) / (320 * 240)
            if need > 0.6 * total_bytes:
                print(f"  {label}: skipped, the plain version would need ~{need / 2**30:.1f} GiB")
                continue
        key = rng.prng_key(seed)
        k = mk.prepare_launch(scene, key, w, h, spp, quirks)
        ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32)).to(dev)
        g = mk.launch_backward(k, ct)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        r = mk.render_grad_reference(k.sv, scene, key, ct, w, h, spp, quirks)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        if (w, spp, quirks) == (320, 1, VERBATIM):
            peak_320 = peak
        repeat = mk.launch_backward(k, ct)
        d = grad_diff(g.cpu(), r.cpu())
        del r
        # knife-edge pixels: the two forward frames took another branch there
        edge = (mk.launch(k) - mk.render_frame_reference(scene, key, w, h, spp, quirks)).abs()[..., :3]
        edge = edge.amax(dim=-1) > EDGE_TOL
        ct_m = ct * (~edge)[..., None]
        de = grad_diff(mk.launch_backward(k, ct_m).cpu(),
                       mk.render_grad_reference(k.sv, scene, key, ct_m, w, h, spp, quirks).cpu())
        bwd_err = max(bwd_err, de["max_abs"])
        print(f"  {label}: without the {int(edge.sum())} knife-edge pixels max|d|/max|g|={de['max_rel']:.3e}, "
              f"entries > 1e-2 max rel {de['big_rel']:.3e}, max|d| {de['max_abs']:.3e} (all pixels: "
              f"{d['max_rel']:.3e}, {d['big_rel']:.3e}, {d['max_abs']:.3e}); plain peak {peak / 2**20:.0f} MiB; "
              f"repeat bit-equal {bool(torch.equal(repeat, g))}")
        if not (d["finite"] and de["finite"] and de["max_rel"] <= GRAD_MAX_TOL and de["big_rel"] <= GRAD_RTOL):
            raise AssertionError(f"{label}: K2 outside tolerance")
        if not torch.equal(repeat, g):
            raise AssertionError(f"{label}: K2 is not reproducible")
        del g, repeat, ct, ct_m, k
        torch.cuda.empty_cache()
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    print("== 7. K2 vs the JAX gradient fixture (64x48, depth 4, PRNGKey(3), loss mean(rgb^2))")
    grad_scene = make_scene(device=dev)
    leaves = dict(inverse.named_leaves(grad_scene))
    for name in FIXTURE_LEAVES:
        leaves[name].requires_grad_(True)
    mk.render_frame_megakernel.launches = mk.render_frame_megakernel.bwd_launches = 0
    img = mk.render_frame_megakernel(grad_scene, rng.prng_key(3), 64, 48)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in FIXTURE_LEAVES])
    counts = (mk.render_frame_megakernel.launches, mk.render_frame_megakernel.bwd_launches)
    if counts != (1, 1):
        raise AssertionError(f"expected 1 K1 and 1 K2 launch, got {counts}")
    with np.load(GRAD_FIXTURE) as want:
        for name, got in zip(FIXTURE_LEAVES, grads):
            got = got.cpu().numpy()
            ok = leaf_close(got, want[name], name)
            print(f"  {name}: K2 {np.array2string(got.ravel(), precision=6)} "
                  f"JAX {np.array2string(want[name].ravel(), precision=6)} {'ok' if ok else 'OUTSIDE'}")
            if not ok:
                raise AssertionError(f"{name}: K2 gradient outside the fixture's tolerance")

    print(f"== 8. trainer: invert CLI, {TRAIN_W}x{TRAIN_H}, depth {MAIN_DEPTH}, {TRAIN_STEPS} steps")
    calls = []  # (K1, K2) launch counts when each render of the trainer starts
    real_render = inverse.render_frame_megakernel

    def counting_render(*args, **kw):
        calls.append((mk.render_frame_megakernel.launches, mk.render_frame_megakernel.bwd_launches,
                      torch.is_grad_enabled()))
        return real_render(*args, **kw)

    inverse.render_frame_megakernel = counting_render
    try:
        with tempfile.TemporaryDirectory() as tmp:
            report_path = os.path.join(tmp, "report.json")
            mk.render_frame_megakernel.launches = mk.render_frame_megakernel.bwd_launches = 0
            invert_cli.main([
                "--device", "cuda", "--width", str(TRAIN_W), "--height", str(TRAIN_H),
                "--depth", str(MAIN_DEPTH), "--steps", str(TRAIN_STEPS), "--json-out", report_path,
            ], log=lambda s: print("  " + s))
            train_launches = (mk.render_frame_megakernel.launches, mk.render_frame_megakernel.bwd_launches)
            with open(report_path) as f:
                losses = json.load(f)["losses"]
    finally:
        inverse.render_frame_megakernel = real_render
    print(f"  launches K1={train_launches[0]} K2={train_launches[1]}; losses {losses[0]:.6e} -> {losses[-1]:.6e}")
    step_starts = [c[:2] for c in calls if c[2]]  # the render with grad opens each step
    want_starts = [(4 + 2 * i, i) for i in range(TRAIN_STEPS)]
    if train_launches != (4 + 2 * TRAIN_STEPS, TRAIN_STEPS) or step_starts != want_starts:
        raise AssertionError(f"a step is not 2 K1 + 1 K2 launches: {calls} -> {train_launches}")
    if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"trainer losses not finite or not falling: {losses}")
    runs = {kern: inverse.recover_demo(key=rng.prng_key(0), width=64, height=48, steps=3, kernel=kern,
                                       device=dev, verbose=False).losses.numpy() for kern in inverse.KERNELS}
    rel = np.abs(runs["megakernel"] / runs["eager"] - 1.0).max()
    print(f"  64x48 losses: kernels {runs['megakernel']}, eager {runs['eager']}, max rel {rel:.3e}")
    if not rel <= 1e-2:
        raise AssertionError("kernel path's losses differ from the eager path's")

    print(f"== 9. times: one training step at {MAIN_W}x{MAIN_H}, depth {MAIN_DEPTH}, spp 1")
    true_scene, start_scene = inverse.demo_scenes(MAIN_DEPTH, dev)
    step_key = rng.prng_key(7)

    def trainer(kern):
        render = inverse.make_renderer(kern, MAIN_W, MAIN_H, 1, VERBATIM)
        with torch.no_grad():
            target = render(true_scene, rng.prng_key(8))
        train, rebuild, _ = inverse.select_leaves(start_scene, inverse.DEMO_SELECT)
        opt = inverse.make_adam(train, 3e-2)
        return lambda: inverse.paired_step(train, rebuild, inverse.clamp_material_params, opt, render, target,
                                           step_key)

    step_ms = time_frames(torch, trainer("megakernel"), 10, warmup=2)
    bwd_launch = mk.prepare_launch(main_scene, key, MAIN_W, MAIN_H, 1, VERBATIM)
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((MAIN_H, MAIN_W, 4)).astype(np.float32)).to(dev)
    bwd_ms = time_frames(torch, lambda: mk.launch_backward(bwd_launch, ct), 10)
    need = peak_320 * (MAIN_W * MAIN_H) / (320 * 240)
    if need > 0.6 * total_bytes:
        raise AssertionError(f"the plain version needs ~{need / 2**30:.1f} GiB at {MAIN_W}x{MAIN_H}")
    plain_bwd_ms = time_frames(torch, lambda: mk.render_grad_reference(
        bwd_launch.sv, main_scene, key, ct, MAIN_W, MAIN_H), 2)
    plain_step_ms = time_frames(torch, trainer("eager"), 2)
    bwd_bound, bwd_bound_by = bound(main_segments, MAIN_W * MAIN_H, n_sv * 8 + 16 + MAIN_W * MAIN_H * 16, K2_OPS)
    print(f"  training step: kernels {step_ms:.3f} ms, plain {plain_step_ms:.3f} ms ({card})")
    print(f"  K2 launch alone {bwd_ms:.3f} ms, plain gradient (eager forward + autograd) {plain_bwd_ms:.3f} ms, "
          f"bound {bwd_bound:.4f} ms ({bwd_bound_by}) ({card})")

    kernels = [dict(
        name="megakernel_fwd", route="cuda", source="pathtracer_tpu_torch/csrc/megakernel_fwd.cu",
        replaces="pathtracer_tpu/ops/megakernel.py:1605", launches=launches,
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=fwd_bound, bound_by=fwd_bound_by,
        library_ms=None,
    ), dict(
        name="megakernel_bwd", route="cuda", source="pathtracer_tpu_torch/csrc/megakernel_bwd.cu",
        replaces="pathtracer_tpu/ops/megakernel.py:1771", launches=train_launches[1],
        max_abs_err=bwd_err, ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bwd_bound, bound_by=bwd_bound_by,
        library_ms=None,
    )]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
