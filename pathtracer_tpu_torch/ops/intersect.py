"""Batched ray-primitive intersection tests.

Port of `pathtracer_tpu/ops/intersect.py`. A miss is +inf, so the closest
hit is a minimum and `isfinite(t)` is the hit signal downstream.
"""

from __future__ import annotations

import math

import torch

from .vecmath import V3, dot, safe_sqrt

MISS = math.inf


def ray_sphere(ro: V3, rd: V3, center: V3, radius) -> torch.Tensor:
    """Sphere test: t0 = tca - thc unless negative, else t1; inf on miss."""
    l = center - ro
    tca = dot(l, rd)
    d2 = dot(l, l) - tca * tca
    radius2 = radius * radius
    thc = safe_sqrt(radius2 - d2)
    t0 = tca - thc
    t1 = tca + thc
    t = torch.where(t0 < 0.0, t1, t0)
    miss = (d2 > radius2) | (t < 0.0)
    return torch.where(miss, MISS, t)


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
