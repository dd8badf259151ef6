"""The SDF scene on the megakernels: its packed layout (K5's input), the
layout's inverse for the plain versions, and the march-step counter K6.

Port of `pathtracer_tpu/ops/megakernel_sdf.py`. The SDF backend K5 (the
over-relaxed sphere trace, the analytic normal, the material argmin, the
checker and the sky) is `csrc/sdf.cuh`, and its adjoint
`csrc/sdf_adj.cuh`; both are templates over the scene's primitive counts,
and `csrc/megakernel_sdf.cu` instantiates K1's and K3's template
(`megakernel_fwd.cuh`), K6 and K2's (`megakernel_bwd.cuh`) with them, a
library built for each count triple (`sdf_counts`; `ops/_build`), as the
JAX kernel is traced for them; `ops/megakernel` launches them for an SDF
scene. Their plain versions are the eager integrator on `models/sdf` and
its autograd.

`measure_march_steps` is K6 (`csrc/megakernel_sdf.cu`): for the center ray
of every pixel, the trips of the primary march and of the NEE shadow march
as `measure_march_steps` of the JAX package rebuilds it (hit point plus
the face-forward normal times EPS, the center-of-light sample, the march
capped at the light's distance, a cap of 0 on misses and on lanes that do
not face the light). Where a TPU tile marches until its slowest lane is
done, a warp of 32 threads does on this card, so the counts are reduced per
warp as well as per pixel. `march_steps_reference` is its plain version.
`hit_cosines` reads |<rd, n>| at the plain path's hits, where K2's
gradient of a grazing hit hangs on the last bits of the incoming ray.
"""

from __future__ import annotations

import torch

from ..integrator.tracer import EPS, VERBATIM, draw_uniforms, init_state, make_bounce_step, sample_light
from ..models import sdf
from ..models.camera import gen_ray, pixel_coords
from ..models.scene import Scene
from .pack import (
    col3, cols, pack_camera, pack_lights, pack_materials, records, unpack_camera, unpack_lights, unpack_materials,
)
from .rng import split
from .vecmath import V2, V3, dot, where3

WARP = 32


def sdf_counts(scene: Scene) -> tuple[int, int, int]:
    """(spheres, boxes, tori) of an SDF scene, the counts its kernels are
    built for; its material table must hold one record per primitive and
    the plane's."""
    p = scene.params
    counts = (int(p.sphere_radius.shape[0]), int(p.box_round.shape[0]), int(p.torus_major.shape[0]))
    n_mat = int(p.materials.roughness.shape[0])
    if n_mat != sum(counts) + 1:
        raise ValueError(f"an SDF scene with {counts} primitives needs {sum(counts) + 1} materials, got {n_mat}")
    return counts


def pack_sdf_scene(scene: Scene, width: int, height: int, with_medium: bool = False) -> torch.Tensor:
    """The SDF scene as one [1, P] float32 vector on its device, the JAX
    package's layout: camera 12, spheres S x [center(3), radius], boxes
    B x [center(3), half(3), round], tori T x [center(3), major, minor],
    plane point(3) normal(3), smooth_k, checker_scale, checker albedo(2),
    sky horizon(3) zenith(3) scale, lights L x 15, materials M x 20
    (26 with_medium). P = 140 for the demo scene."""
    p = scene.params.unpack()
    head = torch.stack(
        cols(
            p.plane_point, p.plane_normal, p.smooth_k, p.checker_scale,
            p.checker_albedo[0], p.checker_albedo[1], p.sky_horizon, p.sky_zenith, p.sky_scale,
        )
    )
    flat = torch.cat(
        [
            pack_camera(scene, width, height),
            records(cols(p.sphere_center, p.sphere_radius)),
            records(cols(p.box_center, p.box_half, p.box_round)),
            records(cols(p.torus_center, p.torus_major, p.torus_minor)),
            head,
            pack_lights(scene),
            pack_materials(p.materials, with_medium),
        ]
    )
    return flat[None, :]


def unpack_sdf_scene(sv: torch.Tensor, scene: Scene) -> tuple[Scene, tuple]:
    """The inverse of pack_sdf_scene, with or without the medium: `scene` with
    every packed float leaf replaced by its entry of sv (so autograd
    through a render of it is d/d sv, the plain version of K2), and the
    camera basis (lower_left, horizontal, vertical, origin) that sv holds
    in place of the camera."""
    v = sv.reshape(-1)
    n_s, n_b, n_t = sdf_counts(scene)
    at = 12
    sph = v[at:at + 4 * n_s].reshape(n_s, 4)
    at += 4 * n_s
    box = v[at:at + 7 * n_b].reshape(n_b, 7)
    at += 7 * n_b
    tor = v[at:at + 5 * n_t].reshape(n_t, 5)
    at += 5 * n_t
    at3 = lambda i: V3(v[at + i], v[at + i + 1], v[at + i + 2])
    p = scene.params.unpack()
    params = p._replace(
        sphere_center=col3(sph, 0), sphere_radius=sph[:, 3],
        box_center=col3(box, 0), box_half=col3(box, 3), box_round=box[:, 6],
        torus_center=col3(tor, 0), torus_major=tor[:, 3], torus_minor=tor[:, 4],
        plane_point=at3(0), plane_normal=at3(3), smooth_k=v[at + 6], checker_scale=v[at + 7],
        checker_albedo=v[at + 8:at + 10], sky_horizon=at3(10), sky_zenith=at3(13), sky_scale=v[at + 16],
    )
    lights_at = at + 17
    params = params._replace(materials=unpack_materials(v, lights_at + 15 * scene.num_lights, p.materials))
    return scene.replace(params=params, lights=unpack_lights(v, lights_at, scene)), unpack_camera(v)


def march_steps_reference(scene: Scene, width: int, height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K6: per-pixel trips of the primary and the NEE
    shadow march, [H, W] int32 each, on the scene's device."""
    p, device = scene.params.unpack(), scene.device
    with torch.no_grad():
        n = width * height
        half = torch.full((n,), 0.5, dtype=torch.float64, device=device)
        ro, rd = gen_ray(
            scene.camera.unpack(), pixel_coords(width, height, torch.float64, device), V2(half, half),
            float(width), float(height),
        )
        t, steps = sdf.march(p, ro, rd)
        hit = sdf.converged(p, ro, rd, t)
        x = ro + rd * torch.where(hit, t, 0.0)
        normal = sdf.sdf_normal(p, x)
        scatter = x + where3(dot(normal, rd) > 0.0, -normal, normal) * EPS
        idx = torch.full((n,), int(0.5 * scene.num_lights), dtype=torch.int64, device=device)
        u = torch.full((n,), 0.5, dtype=scene.dtype, device=device)
        ls = sample_light(scene.lights.unpack(), idx, scatter, u, u)
        cap = torch.where((dot(ls.direction, ls.normal) < 0.0) & hit, ls.dist - EPS, 0.0)
        _, shadow = sdf.march(p, scatter, ls.direction, t_cap=cap)
    return steps.reshape(height, width), shadow.reshape(height, width)


def hit_cosines(scene: Scene, key, width: int, height: int, spp: int = 1, quirks=VERBATIM,
                pixels: torch.Tensor | None = None) -> torch.Tensor:
    """|<rd, n>| where each bounce of the plain version's path meets an SDF
    hit, [spp, depth, n] for the `pixels` of the frame given (all by
    default), +inf where the path is dead or misses. Where it is small the
    Newton step's dt/dtheta = -(df/dtheta)/<rd, n> is ill-conditioned, and
    a pixel's gradient hangs on the last bits of the incoming ray."""
    p, dev = scene.params.unpack(), scene.device
    coords = pixel_coords(width, height, torch.float64, dev)
    if pixels is not None:
        coords = V2(coords.x[pixels], coords.y[pixels])
    out = []
    with torch.no_grad():
        step = make_bounce_step(scene, quirks, detach=True)
        for k in [key] if spp == 1 else list(split(key, spp)):
            cam_u, bounce_u = draw_uniforms(k, width * height, scene.recursion_depth, torch.float32, dev)
            if pixels is not None:
                cam_u, bounce_u = cam_u[pixels], bounce_u[:, pixels]
            ro, rd = gen_ray(scene.camera.unpack(), coords, V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height))
            state = init_state(ro, rd, quirks)
            for u in bounce_u:
                t, _ = sdf.march(p, state.ro, state.rd)
                hit = sdf.converged(p, state.ro, state.rd, t)
                cos = dot(state.rd, sdf.sdf_normal(p, state.ro + state.rd * torch.where(hit, t, 0.0))).abs()
                out.append(torch.where(state.alive & hit, cos, torch.inf))
                state = step(state, u)
    return torch.stack(out).reshape(spp, scene.recursion_depth, -1)


def warp_max(counts: torch.Tensor) -> torch.Tensor:
    """The most trips in each warp: 32 consecutive pixels of the launch
    (the last warp may be short)."""
    flat = counts.reshape(-1)
    pad = -flat.numel() % WARP
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, WARP).amax(dim=1)


def launch_march_steps(scene: Scene, width: int, height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K6 on PyTorch's current stream: ([H, W], [H, W])
    int32 trips. Counted in `measure_march_steps.launches`."""
    from . import _build

    counts = sdf_counts(scene)
    if scene.num_lights < 1:
        raise ValueError("the march-step counter samples a light; the scene has none")
    sv = pack_sdf_scene(scene, width, height).contiguous()
    steps = torch.empty((height, width), dtype=torch.int32, device=sv.device)
    shadow = torch.empty_like(steps)
    lib = _build.load("megakernel_sdf", counts=counts)
    err = lib.pt_march_steps(
        sv.data_ptr(), sv.shape[1], steps.data_ptr(), shadow.data_ptr(), width, height,
        scene.num_lights, int(scene.params.materials.roughness.shape[0]), *counts,
        torch.cuda.current_stream(sv.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"march-step kernel launch failed: {lib.pt_error_string(err).decode()}")
    measure_march_steps.launches += 1
    return steps, shadow


def measure_march_steps(scene: Scene, width: int, height: int) -> dict:
    """March trips of the center ray of every pixel, primary and NEE
    shadow: on a CUDA scene one launch of K6, on a CPU scene the plain
    version. Returns the [H, W] counts, their mean and max over pixels,
    and per warp (the unit that runs in lock step here) the maxima, with
    their mean and max: the trips the card issues."""
    sdf_counts(scene)
    if scene.device.type == "cuda":
        steps, shadow = launch_march_steps(scene, width, height)
    elif scene.device.type == "cpu":
        steps, shadow = march_steps_reference(scene, width, height)
    else:
        raise ValueError(f"unsupported device {scene.device}")
    out = {}
    for name, c in (("", steps), ("shadow_", shadow)):
        w = warp_max(c)
        out.update({
            f"{name}steps": c,
            f"{name}mean_steps": float(c.double().mean()),
            f"{name}max_steps": int(c.max()),
            f"{name}warp_steps": w,
            f"{name}warp_mean_steps": float(w.double().mean()),
            f"{name}warp_max_steps": int(w.max()),
        })
    return out


measure_march_steps.launches = 0
