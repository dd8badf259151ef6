# Frozen copy of pathtracer_tpu_torch/models/sdf.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""The sphere-traced SDF scene: a mirror sphere, an orange rounded box and a
teal torus over a checker plane, lit and framed like the analytical demo.

Port of `pathtracer_tpu/models/sdf.py`. `closest_hit` marches
t += sdf(ro + t rd) with over-relaxation (OMEGA) and a fail backtrack,
then reattaches the marched t* with one Newton step,

    t(theta) = t* - (sdf(ro + t* rd, theta) - its detached value) / <rd, n>,

whose value is t* and whose autograd is the implicit-function derivative
-(d sdf / d theta) / <rd, n>: nothing differentiates through the march.

The normal is the gradient of the distance field written out per primitive
and folded through `smooth_min` (`sdf_normal`), with jax.grad's values at
ties: `maximum`/`minimum` share 0.5/0.5, `abs` has slope +1 at 0 and
`safe_sqrt` gradient 0 at 0. It stays differentiable in the scene parameters, as the
JAX normal (a grad inside the grad) is. `csrc/sdf.cuh` computes the same
formulas in the same order, so the CUDA backend and this plain version
share one definition. Every scene value is a buffer of the Scene module.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .vecmath import V3, clip, dot, maximum, minimum, safe_normalize, safe_sqrt, splat3, v3
from .tree import tree_map
from .analytical import background  # the same sky: gamma-decoded lerp times sky_scale
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

MAX_STEPS = 96
T_MAX = 50.0
HIT_EPS = 1e-3
# Over-relaxation (Keinert et al. 2014): step OMEGA * d while consecutive
# unbounding spheres overlap; on an overstep, back-track and march plainly.
OMEGA = 1.6
# Steps between the eager march's checks that every lane is done.
MARCH_BLOCK = 12


class SdfParams(NamedTuple):
    """The SDF scene's values; field order and names are the JAX package's."""

    sphere_center: V3  # [S]
    sphere_radius: torch.Tensor  # [S]
    box_center: V3  # [B]
    box_half: V3  # [B]
    box_round: torch.Tensor  # [B] rounding radius
    torus_center: V3  # [T]
    torus_major: torch.Tensor  # [T]
    torus_minor: torch.Tensor  # [T]
    plane_point: V3
    plane_normal: V3
    smooth_k: torch.Tensor  # smooth-union blend width (0: hard min)
    materials: Material  # [S + B + T + 1], the plane last
    checker_scale: torch.Tensor
    checker_albedo: torch.Tensor  # [2]
    sky_horizon: V3
    sky_zenith: V3
    sky_scale: torch.Tensor


def default_params(dtype=torch.float32, device=None) -> SdfParams:
    """The demo scene's values, verbatim from the JAX package."""
    kw = dict(dtype=dtype, device=device)
    t = lambda a: torch.tensor(a, **kw)
    one = lambda a, b, c: V3(t([a]), t([b]), t([c]))
    return SdfParams(
        sphere_center=one(-1.3, 0.0, 0.0),
        sphere_radius=t([1.0]),
        box_center=one(1.3, -0.25, 0.0),
        box_half=one(0.7, 0.7, 0.7),
        box_round=t([0.05]),
        torus_center=one(0.0, -0.7, 1.2),
        torus_major=t([0.45]),
        torus_minor=t([0.15]),
        plane_point=v3(0.0, -1.0, 0.0, **kw),
        plane_normal=v3(0.0, 1.0, 0.0, **kw),
        smooth_k=t(0.0),
        materials=stack_materials([
            make_material(rgb=(1.0, 1.0, 1.0), roughness=0.05, metallic=1.0, **kw),
            make_material(rgb=(1.0, 0.186, 0.0), clearcoat=1.0, clearcoat_gloss=1.0, roughness=0.1, **kw),
            make_material(rgb=(0.1, 0.55, 0.6), roughness=0.25, **kw),
            make_material(roughness=1.0, **kw),  # the plane; rgb comes from the checker
        ]),
        checker_scale=t(1.0),
        checker_albedo=t([0.25, 0.1]),
        sky_horizon=v3(1.0, 1.0, 1.0, **kw),
        sky_zenith=v3(0.5, 0.7, 1.0, **kw),
        sky_scale=t(0.5),
    )


# ---------------------------------------------------------------------------
# Distance field
# ---------------------------------------------------------------------------


def sd_sphere(p: V3, center: V3, radius) -> torch.Tensor:
    return (p - center).length() - radius


def sd_round_box(p: V3, center: V3, half: V3, r) -> torch.Tensor:
    q = (p - center).abs() - half
    outside = V3(maximum(q.x, 0.0), maximum(q.y, 0.0), maximum(q.z, 0.0))
    inside = minimum(torch.maximum(q.x, torch.maximum(q.y, q.z)), 0.0)
    return safe_sqrt(dot(outside, outside)) + inside - r


def sd_torus(p: V3, center: V3, major, minor) -> torch.Tensor:
    q = p - center
    ring = safe_sqrt(q.x * q.x + q.z * q.z) - major
    return safe_sqrt(ring * ring + q.y * q.y) - minor


def sd_plane(p: V3, point: V3, normal: V3) -> torch.Tensor:
    return dot(p - point, normal)


def smooth_min(a, b, k):
    """Polynomial smooth union (quadratic); k = 0 is the hard min."""
    h = clip(0.5 + 0.5 * (b - a) / torch.where(k > 0.0, k, 1.0), 0.0, 1.0)
    smin = b * (1.0 - h) + a * h - k * h * (1.0 - h)
    return torch.where(k > 0.0, smin, torch.minimum(a, b))


def _at(w: V3, i: int) -> V3:
    return V3(w.x[i], w.y[i], w.z[i])


def _primitives(p: SdfParams):
    """(kind, record) in material-table order: spheres, boxes, tori, plane."""
    for i in range(p.sphere_radius.shape[0]):
        yield "sphere", (_at(p.sphere_center, i), p.sphere_radius[i])
    for i in range(p.box_round.shape[0]):
        yield "box", (_at(p.box_center, i), _at(p.box_half, i), p.box_round[i])
    for i in range(p.torus_major.shape[0]):
        yield "torus", (_at(p.torus_center, i), p.torus_major[i], p.torus_minor[i])
    yield "plane", (p.plane_point, p.plane_normal)


_DISTANCE = {"sphere": sd_sphere, "box": sd_round_box, "torus": sd_torus, "plane": sd_plane}


def _primitive_distances(p: SdfParams, x: V3) -> list[torch.Tensor]:
    return [_DISTANCE[kind](x, *rec) for kind, rec in _primitives(p)]


def scene_sdf(p: SdfParams, x: V3, hard: bool = False) -> torch.Tensor:
    """The scene's distance: smooth union over the primitives, in order.
    hard=True takes the hard minimum, what smooth_min computes at k = 0
    (the march's shortcut, with no gradient)."""
    ds = _primitive_distances(p, x)
    d = ds[0]
    for di in ds[1:]:
        d = torch.minimum(d, di) if hard else smooth_min(d, di, p.smooth_k)
    return d


def nearest_primitive(p: SdfParams, x: V3) -> torch.Tensor:
    """Material id at x: argmin over the primitive distances, the first
    minimum winning."""
    return torch.argmin(torch.stack(torch.broadcast_tensors(*_primitive_distances(p, x))), dim=0)


# ---------------------------------------------------------------------------
# Analytic normal: grad_x of the distance field
# ---------------------------------------------------------------------------


def _share(wins, tie, like) -> torch.Tensor:
    """jax.grad's share of one operand of maximum/minimum: 1 where it
    wins, 0.5 at a tie, 0 where it loses."""
    return torch.where(wins, 1.0, torch.where(tie, 0.5, 0.0)).to(like.dtype)


def _safe_inv(s) -> torch.Tensor:
    """1 / s where s > 0, else 0, with a NaN-free backward."""
    pos = s > 0.0
    return torch.where(pos, 1.0 / torch.where(pos, s, 1.0), 0.0)


def _sphere_grad(x: V3, center: V3, radius):
    q = x - center
    length = q.length()
    return length - radius, q / length


def _round_box_grad(x: V3, center: V3, half: V3, r):
    rel = x - center
    q = rel.abs() - half
    outside = V3(maximum(q.x, 0.0), maximum(q.y, 0.0), maximum(q.z, 0.0))
    out_len = safe_sqrt(dot(outside, outside))
    inv_len = _safe_inv(out_len)
    m_yz = torch.maximum(q.y, q.z)
    m = torch.maximum(q.x, m_yz)
    d = out_len + minimum(m, 0.0) - r
    # Shares of the inner minimum(m, 0) and of the maxima over q.
    w_in = _share(m < 0.0, m == 0.0, m)
    wx = _share(q.x > m_yz, q.x == m_yz, m)
    w_yz = _share(q.y > q.z, q.y == q.z, m)
    w = (wx, (1.0 - wx) * w_yz, (1.0 - wx) * (1.0 - w_yz))

    def comp(rel_c, q_c, out_c, w_c):
        d_q = out_c * inv_len * _share(q_c > 0.0, q_c == 0.0, m) + w_in * w_c
        return torch.where(rel_c >= 0.0, d_q, -d_q)  # jnp.abs's slope, +1 at 0

    return d, V3(*(comp(*a) for a in zip(rel, q, outside, w)))


def _torus_grad(x: V3, center: V3, major, minor):
    q = x - center
    s_a = safe_sqrt(q.x * q.x + q.z * q.z)
    ring = s_a - major
    s_b = safe_sqrt(ring * ring + q.y * q.y)
    inv_a, inv_b = _safe_inv(s_a), _safe_inv(s_b)
    ring_b = ring * inv_b
    return s_b - minor, V3(q.x * inv_a * ring_b, q.y * inv_b, q.z * inv_a * ring_b)


def _plane_grad(x: V3, point: V3, normal: V3):
    d = sd_plane(x, point, normal)
    return d, V3(*(c.expand_as(d) for c in normal))


_GRADIENT = {"sphere": _sphere_grad, "box": _round_box_grad, "torus": _torus_grad, "plane": _plane_grad}


def union_share(a, b, k) -> torch.Tensor:
    """d smooth_min(a, b, k) / da (d/db is one minus it): h where k > 0,
    the hard minimum's share otherwise."""
    h = clip(0.5 + 0.5 * (b - a) / torch.where(k > 0.0, k, 1.0), 0.0, 1.0)
    return torch.where(k > 0.0, h, _share(a < b, a == b, a))


def sdf_gradient(p: SdfParams, x: V3) -> V3:
    """grad_x scene_sdf: each primitive's distance and gradient, folded
    through smooth_min in the scene's order with the union's shares
    (forward mode; jax.grad's reverse mode gives the same values, and at
    k = 0 the same bits)."""
    prims = [_GRADIENT[kind](x, *rec) for kind, rec in _primitives(p)]
    d, g = prims[0]
    for di, gi in prims[1:]:
        w = union_share(d, di, p.smooth_k)
        g = g * w + gi * (1.0 - w)
        d = smooth_min(d, di, p.smooth_k)
    return g


def sdf_normal(p: SdfParams, x: V3) -> V3:
    """The analytic surface normal, normalize(grad_x scene_sdf)."""
    return safe_normalize(sdf_gradient(p, x))


# ---------------------------------------------------------------------------
# Sphere tracing
# ---------------------------------------------------------------------------


def _detached(p: SdfParams) -> SdfParams:
    return tree_map(lambda leaf: leaf.detach(), p)


def march(p: SdfParams, ro: V3, rd: V3, t_cap=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The over-relaxed march, without gradients: (t*, steps). A lane is
    done once |sdf| < HIT_EPS on a step that did not fail, or t > T_MAX;
    `steps` is the step (1-based) at which that happens, MAX_STEPS for a
    lane that never stops. With `t_cap` (per lane), a lane also stops at
    t > t_cap once no backtrack is pending (the shadow march, csrc/sdf.cuh,
    ops/megakernel_sdf.measure_march_steps). The loop ends early once
    every lane is done, checked every MARCH_BLOCK steps; later steps would
    change nothing."""
    with torch.no_grad():
        hard = not bool(p.smooth_k > 0.0)
        shape = torch.broadcast_shapes(ro.x.shape, rd.x.shape)
        t = torch.zeros(shape, dtype=rd.x.dtype, device=rd.x.device)
        prev_r, step_len = torch.zeros_like(t), torch.zeros_like(t)
        omega = torch.full_like(t, OMEGA)
        done = torch.zeros(shape, dtype=torch.bool, device=t.device)
        steps = torch.full(shape, MAX_STEPS, dtype=torch.int32, device=t.device)
        cap = None if t_cap is None else torch.minimum(t_cap, torch.full_like(t, T_MAX))
        for k in range(MAX_STEPS):
            d = scene_sdf(p, ro + rd * t, hard)
            r = torch.abs(d)
            fail = (omega > 1.0) & (r + prev_r < step_len)
            new_step = torch.where(fail, -(omega - 1.0) * step_len, d * omega)
            stop = (~fail & (r < HIT_EPS)) | (t > T_MAX)
            if cap is not None:
                stop = stop | ((t > cap) & ~fail)
            done_n = done | stop
            steps = torch.where(done_n & ~done, k + 1, steps)
            t = torch.where(done_n, t, t + new_step)
            prev_r = torch.where(done, prev_r, r)
            step_len = torch.where(done, step_len, new_step)
            omega = torch.where(done | ~fail, omega, 1.0)
            done = done_n
            if (k + 1) % MARCH_BLOCK == 0 and bool(done.all()):
                break
    return t, steps


def converged(p: SdfParams, ro: V3, rd: V3, t) -> torch.Tensor:
    """The hit test at the marched t*: |sdf| < 2 HIT_EPS and t* <= T_MAX."""
    with torch.no_grad():
        return (torch.abs(scene_sdf(p, ro + rd * t)) < 2.0 * HIT_EPS) & (t <= T_MAX)


def sphere_trace(p: SdfParams, ro: V3, rd: V3) -> tuple[torch.Tensor, torch.Tensor]:
    """(t, hit): t is +inf on a miss, and differentiable in the scene
    parameters and the ray through the Newton reattachment (module
    docstring); the march runs detached.

    The Newton step evaluates the field at t* on a hit and at t = 0 on a
    miss, where the JAX package evaluates it at t* on every lane: a march
    that starts inside the union can run away (t* ~ -3e34), the field
    overflows there, and its backward, though its cotangent is 0, is NaN
    (0 * inf in smooth_min's unused branch). Hits are unchanged."""
    ps = _detached(p)
    ros, rds = V3(*(c.detach() for c in ro)), V3(*(c.detach() for c in rd))
    t_star, _ = march(ps, ros, rds)
    hit = converged(ps, ros, rds, t_star)
    t_at = torch.where(hit, t_star, 0.0)
    with torch.no_grad():
        denom = dot(rds, sdf_normal(ps, ros + rds * t_at))
    f_val = scene_sdf(p, ro + rd * t_at)
    ok = torch.abs(denom) > 1e-4
    t_newton = t_star - torch.where(ok, f_val - f_val.detach(), 0.0) / torch.where(ok, denom, 1.0)
    return torch.where(hit, t_newton, math.inf), hit


# ---------------------------------------------------------------------------
# Scene functions
# ---------------------------------------------------------------------------


def _checker(p: SdfParams, x, z):
    """Checker albedo from the hit point, with the JAX package's abs before
    the last fmod (truncated, as Rust's float `%`)."""
    x1 = torch.fmod(torch.floor(x * p.checker_scale), 2.0)
    z1 = torch.fmod(torch.floor(z * p.checker_scale), 2.0)
    return torch.where(torch.fmod(torch.abs(x1 + z1), 2.0) < 1.0, p.checker_albedo[0], p.checker_albedo[1])


def closest_hit(p: SdfParams, ro: V3, rd: V3) -> SurfaceHit:
    """Sphere-traced closest hit. On a miss: t = +inf, the normal at ro
    (never used, but finite) and the default material."""
    t, hit = sphere_trace(p, ro, rd)
    x = ro + rd * torch.where(hit, t, 0.0)
    normal = sdf_normal(p, x)
    with torch.no_grad():
        idx = nearest_primitive(p, x)
    mat = gather_material(p.materials, idx)
    plane = idx == p.materials.roughness.shape[0] - 1
    mat = select_material(plane, mat._replace(rgb=splat3(_checker(p, x.x, x.z))), mat)
    mat = select_material(hit, mat, default_material(idx.shape, rd.x.dtype, rd.x.device))
    return SurfaceHit(t=torch.where(hit, t, math.inf), normal=normal, material=mat)


def any_hit(p: SdfParams, ro: V3, rd: V3, max_dist) -> torch.Tensor:
    """Shadow occlusion closer than max_dist (the analytical scene's
    ignore-max_dist quirk does not apply): the full march, as the JAX
    package's any_hit runs it. The CUDA backend caps the march at max_dist,
    which decides the same."""
    ps = _detached(p)
    t_star, _ = march(ps, ro, rd)
    return converged(ps, ro, rd, t_star) & (t_star < max_dist)


def make_scene(
    dtype=torch.float32,
    recursion_depth: int = 4,
    params: SdfParams | None = None,
    lights=None,
    device=None,
) -> Scene:
    """The SDF demo scene with the analytical demo's light (spherical at
    (3,2,2), r = 1, emission (3,3,3)) and camera."""
    return Scene(
        params=params if params is not None else default_params(dtype, device),
        camera=default_pinhole(dtype, device),
        lights=lights if lights is not None else spherical_light(
            (3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0), dtype=dtype, device=device
        ),
        background_fn=background,
        closest_hit_fn=closest_hit,
        any_hit_fn=any_hit,
        recursion_depth=recursion_depth,
    )
