# Frozen copy of pathtracer_tpu_torch/models/analytical.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""The analytical demo scene: two spheres, a checker plane, a sky gradient.

Port of `pathtracer_tpu/models/analytical.py` with the verbatim demo
values; every geometric and material value is a scene buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import MISS, ray_plane, ray_sphere
from .vecmath import V3, mix, safe_normalize, splat3, v3, where3
from .camera import default_pinhole
from .light import spherical_light
from .material import (
    Material,
    default_material,
    gather_material,
    make_material,
    select_material,
    stack_materials,
)
from .scene import Scene, SurfaceHit


class AnalyticalParams(NamedTuple):
    sphere_center: V3  # [2]: (-1.1,0,0), (1.1,0,0)
    sphere_radius: torch.Tensor  # [2]
    materials: Material  # [3]: sphere0, sphere1, plane base
    checker_scale: torch.Tensor
    checker_offset: torch.Tensor
    checker_albedo: torch.Tensor  # [2]
    plane_point: V3
    plane_normal: V3
    sky_horizon: V3
    sky_zenith: V3
    sky_scale: torch.Tensor


def default_params(dtype=torch.float32, device=None) -> AnalyticalParams:
    """Verbatim demo values."""
    kw = dict(dtype=dtype, device=device)
    mat_left = make_material(rgb=(1.0, 1.0, 1.0), roughness=0.05, metallic=1.0, **kw)
    mat_right = make_material(
        rgb=(1.0, 0.186, 0.0), clearcoat=1.0, clearcoat_gloss=1.0, roughness=0.1, **kw
    )
    mat_plane = make_material(roughness=1.0, **kw)  # rgb comes from the checker
    t = lambda a: torch.tensor(a, **kw)
    return AnalyticalParams(
        sphere_center=V3(t([-1.1, 1.1]), t([0.0, 0.0]), t([0.0, 0.0])),
        sphere_radius=t([1.0, 1.0]),
        materials=stack_materials([mat_left, mat_right, mat_plane]),
        checker_scale=t(0.5),
        checker_offset=t(100.0),
        checker_albedo=t([0.25, 0.1]),
        plane_point=v3(0.0, -1.0, 0.0, **kw),
        plane_normal=v3(0.0, 1.0, 0.0, **kw),
        sky_horizon=v3(1.0, 1.0, 1.0, **kw),
        sky_zenith=v3(0.5, 0.7, 1.0, **kw),
        sky_scale=t(0.5),
    )


def background(p: AnalyticalParams, rd: V3) -> V3:
    """Sky gradient: gamma-2.2-decoded lerp scaled by sky_scale."""
    t = 0.5 * (rd.y + 1.0)
    c = mix(p.sky_horizon, p.sky_zenith, t)
    return c.to_linear() * splat3(p.sky_scale)


def _checker(p: AnalyticalParams, x, y):
    """Checker albedo with Rust's float `%` (truncated, sign of the
    dividend): torch.fmod, never `%` or remainder."""
    x1 = torch.fmod(torch.floor(x), 2.0)
    y1 = torch.fmod(torch.floor(y), 2.0)
    return torch.where(
        torch.fmod(x1 + y1, 2.0) < 1.0, p.checker_albedo[0], p.checker_albedo[1]
    )


def _primitive_ts(p: AnalyticalParams, ro: V3, rd: V3):
    c0 = V3(p.sphere_center.x[0], p.sphere_center.y[0], p.sphere_center.z[0])
    c1 = V3(p.sphere_center.x[1], p.sphere_center.y[1], p.sphere_center.z[1])
    t0 = ray_sphere(ro, rd, c0, p.sphere_radius[0])
    t1 = ray_sphere(ro, rd, c1, p.sphere_radius[1])
    tp = ray_plane(ro, rd, p.plane_normal, p.plane_point)
    return (c0, c1), (t0, t1, tp)


def closest_hit(p: AnalyticalParams, ro: V3, rd: V3) -> SurfaceHit:
    """Closest of [sphere0, sphere1, plane]; ties go to the earlier
    primitive, like the reference's strict `<` chain."""
    (c0, c1), ts = _primitive_ts(p, ro, rd)
    ts = torch.stack(ts, dim=0)
    t = torch.amin(ts, dim=0)
    idx = torch.argmin(ts, dim=0)  # first min wins
    hit = torch.isfinite(t)

    hp = ro + rd * torch.where(hit, t, 0.0)
    center = where3(idx == 0, c0, c1)
    n_sphere = safe_normalize(hp - center)
    n = rd.x.shape
    n_plane = V3(
        p.plane_normal.x.expand(n), p.plane_normal.y.expand(n), p.plane_normal.z.expand(n)
    )
    normal = where3(idx == 2, n_plane, n_sphere)

    # Plane albedo from the checker, computed from the ray direction.
    mat = gather_material(p.materials, idx)
    safe_dy = torch.where(rd.y != 0.0, rd.y, 1.0)
    cx = rd.x / safe_dy * p.checker_scale + p.checker_offset
    cy = rd.z / safe_dy * p.checker_scale + p.checker_offset
    c = _checker(p, cx, cy)
    mat = select_material(idx == 2, mat._replace(rgb=splat3(c)), mat)
    mat = select_material(hit, mat, default_material(n, rd.x.dtype, rd.x.device))
    return SurfaceHit(t=torch.where(hit, t, MISS), normal=normal, material=mat)


def any_hit(p: AnalyticalParams, ro: V3, rd: V3, max_dist) -> torch.Tensor:
    """Shadow-ray occlusion; the reference's quirk IGNORES max_dist."""
    del max_dist
    _, (t0, t1, tp) = _primitive_ts(p, ro, rd)
    return torch.isfinite(t0) | torch.isfinite(t1) | torch.isfinite(tp)


def any_hit_respecting_max_dist(p: AnalyticalParams, ro: V3, rd: V3, max_dist):
    """Occlusion only closer than max_dist (the fixed semantics)."""
    _, (t0, t1, tp) = _primitive_ts(p, ro, rd)
    t = torch.minimum(torch.minimum(t0, t1), tp)
    return t < max_dist


def make_scene(
    dtype=torch.float32,
    recursion_depth: int = 4,
    respect_max_dist: bool = False,
    params: AnalyticalParams | None = None,
    lights=None,
    device=None,
) -> Scene:
    """The demo scene: one spherical light at (3,2,2), r = 1, emission
    (3,3,3), the default pinhole, recursion depth 4."""
    return Scene(
        params=params if params is not None else default_params(dtype, device),
        camera=default_pinhole(dtype, device),
        lights=lights if lights is not None else spherical_light(
            (3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0), dtype=dtype, device=device
        ),
        background_fn=background,
        closest_hit_fn=closest_hit,
        any_hit_fn=any_hit_respecting_max_dist if respect_max_dist else any_hit,
        recursion_depth=recursion_depth,
    )
