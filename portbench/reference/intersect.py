# Frozen copy of pathtracer_tpu_torch/ops/intersect.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""Batched ray-primitive intersection tests.

Port of `pathtracer_tpu/ops/intersect.py`. A miss is +inf, so the closest
hit is a minimum and `isfinite(t)` is the hit signal downstream.
"""

from __future__ import annotations

import math

import torch

from .vecmath import V3, dot, safe_sqrt, wide

MISS = math.inf


def ray_sphere(ro: V3, rd: V3, center: V3, radius) -> torch.Tensor:
    """Sphere test: t0 = tca - thc unless negative, else t1; inf on miss.

    After `l = center - ro` the test runs in float64 and rounds t once to
    the ray's dtype, as the CUDA kernels do. Near a silhouette r^2 - d2
    cancels to a few float32 ulps of |l|^2 while d t / d(ray, sphere) grows
    as 1/sqrt(r^2 - d2): in float32 the gradient there keeps few digits and
    two float32 orderings (FMA contraction, another sum order) disagree. In
    float64 both sides round the same t from the same float32 inputs."""
    dtype = rd.x.dtype
    f64 = wide(dtype)
    l, rd = (center - ro).to(f64), rd.to(f64)
    tca = dot(l, rd)
    d2 = dot(l, l) - tca * tca
    radius = torch.as_tensor(radius).to(f64)
    radius2 = radius * radius
    thc = safe_sqrt(radius2 - d2)
    t0 = tca - thc
    t1 = tca + thc
    t = torch.where(t0 < 0.0, t1, t0)
    miss = (d2 > radius2) | (t < 0.0)
    return torch.where(miss, MISS, t).to(dtype)


def ray_rect(ro: V3, rd: V3, corner: V3, u: V3, v: V3) -> torch.Tensor:
    """Ray vs the rectangle spanned by edges (u, v) from `corner`."""
    n = u.cross(v)
    denom = dot(n, rd)
    facing = torch.abs(denom) > 1e-8
    t = dot(corner - ro, n) / torch.where(facing, denom, 1.0)
    hp = ro + rd * t
    rel = hp - corner
    uu = dot(u, u)
    vv = dot(v, v)
    a = dot(rel, u) / torch.where(uu > 0.0, uu, 1.0)
    b = dot(rel, v) / torch.where(vv > 0.0, vv, 1.0)
    ok = facing & (t >= 0.0) & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    return torch.where(ok, t, MISS)


def ray_plane(ro: V3, rd: V3, normal: V3, point: V3, eps: float = 0.0001) -> torch.Tensor:
    """Ray-plane test: t >= 0 or inf."""
    denom = dot(normal, rd)
    facing = torch.abs(denom) > eps
    t = dot(point - ro, normal) / torch.where(facing, denom, 1.0)
    miss = (torch.abs(denom) <= eps) | (t < 0.0)
    return torch.where(miss, MISS, t)


def ray_triangle(ro: V3, rd: V3, v0: V3, v1: V3, v2: V3, eps: float = 1e-7) -> torch.Tensor:
    """Two-sided Möller-Trumbore: t > eps or inf. inv_det is 0 where
    |det| <= eps; a hit needs u, v >= 0 and u + v <= 1. The winding does not
    matter (the caller turns the normal against the ray)."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = rd.cross(e2)
    det = dot(e1, p)
    ok_det = torch.abs(det) > eps
    inv_det = torch.where(ok_det, 1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    s = ro - v0
    u = dot(s, p) * inv_det
    q = s.cross(e1)
    v = dot(rd, q) * inv_det
    t = dot(e2, q) * inv_det
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return torch.where(ok, t, MISS)
