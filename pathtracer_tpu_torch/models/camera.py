"""Pinhole camera and batched ray generation.

Port of `pathtracer_tpu/models/camera.py`, keeping the reference's
horizontal-FOV convention and its unnormalized `u = up x w` basis vector.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.vecmath import V2, V3, cross, normalize, v3


class Pinhole(NamedTuple):
    origin: V3
    center: V3
    fov: torch.Tensor  # degrees, horizontal


def default_pinhole(dtype=torch.float32, device=None) -> Pinhole:
    """Pinhole::new: origin (0,0,3), center (0,0,0), fov 80."""
    return Pinhole(
        origin=v3(0.0, 0.0, 3.0, dtype=dtype, device=device),
        center=v3(0.0, 0.0, 0.0, dtype=dtype, device=device),
        fov=torch.tensor(80.0, dtype=dtype, device=device),
    )


def camera_basis(cam: Pinhole, width: float, height: float):
    """(lower_left, horizontal, vertical) as Pinhole::gen_ray precomputes
    them."""
    ratio = width / height
    half_width = torch.tan(torch.deg2rad(cam.fov) * 0.5)
    half_height = half_width / ratio
    zero, one = torch.zeros_like(cam.fov), torch.ones_like(cam.fov)  # no host copies
    up = V3(zero, one, zero)
    w = normalize(cam.origin - cam.center)
    u = cross(up, w)
    v = cross(w, u)
    lower_left = cam.origin - u * half_width - v * half_height - w
    return lower_left, u * (half_width * 2.0), v * (half_height * 2.0)


def gen_ray(cam: Pinhole, p: V2, offset: V2, width, height) -> tuple[V3, V3]:
    """Batched Pinhole::gen_ray: p in [0,1)^2 (x right, y up), offset the
    sub-pixel jitter. Returns (origin, direction) over the batch."""
    pixel_size = V2(1.0 / width, 1.0 / height)
    lower_left, horizontal, vertical = camera_basis(cam, width, height)
    rd = (
        (lower_left - cam.origin)
        + horizontal * (pixel_size.x * offset.x + p.x)
        + vertical * (pixel_size.y * offset.y + p.y)
    )
    direction = normalize(rd)
    ones = torch.ones_like(direction.x)
    origin = V3(cam.origin.x * ones, cam.origin.y * ones, cam.origin.z * ones)
    return origin, direction


def pixel_coords(width: int, height: int, dtype=torch.float32, device=None) -> V2:
    """Flat [H*W] normalized coords, row-major top to bottom:
    (x / width, (height - 1 - y) / height)."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij",
    )
    cx = (xs / width).reshape(-1)
    cy = ((height - 1.0 - ys) / height).reshape(-1)
    return V2(cx, cy)
