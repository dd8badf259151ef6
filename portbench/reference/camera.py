# Frozen copy of pathtracer_tpu_torch/models/camera.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""Pinhole camera and batched ray generation.

Port of `pathtracer_tpu/models/camera.py`, keeping the reference's
horizontal-FOV convention and its unnormalized `u = up x w` basis vector.
`Pinhole.set`, `set_fov`, `orbit` and `zoom` move a camera for the live
viewer: tensor ops on the camera's 0-d tensors on its device, with no
copy to or from the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import V2, V3, cross, normalize, v3, wide


class Pinhole(NamedTuple):
    origin: V3
    center: V3
    fov: torch.Tensor  # degrees, horizontal

    def set(self, origin: V3, center: V3) -> "Pinhole":
        return self._replace(origin=origin, center=center)

    def set_fov(self, fov) -> "Pinhole":
        """fov: a number, or a tensor on the camera's device."""
        if isinstance(fov, torch.Tensor):
            return self._replace(fov=fov.to(self.fov))
        return self._replace(fov=torch.full_like(self.fov, fov))


def orbit(cam: Pinhole, dyaw, dpitch) -> Pinhole:
    """Rotate the eye about the look-at center by dyaw and dpitch radians,
    the pitch clamped to +-1.45 off the poles and the distance to the center
    kept."""
    v = cam.origin - cam.center
    r = torch.sqrt(v.dot(v))
    yaw = torch.atan2(v.x, v.z) + dyaw
    pitch = torch.asin(torch.clamp(v.y / torch.clamp_min(r, 1e-8), -1.0, 1.0))
    pitch = torch.clamp(pitch + dpitch, -1.45, 1.45)
    cp = torch.cos(pitch)
    origin = V3(
        cam.center.x + r * cp * torch.sin(yaw),
        cam.center.y + r * torch.sin(pitch),
        cam.center.z + r * cp * torch.cos(yaw),
    )
    return cam.set(origin, cam.center)


def zoom(cam: Pinhole, factor) -> Pinhole:
    """Scale the eye's distance to the center by factor (> 1 away, < 1 in),
    no nearer than 1e-3."""
    v = cam.origin - cam.center
    r = torch.sqrt(v.dot(v))
    s = torch.clamp_min(r * factor, 1e-3) / torch.clamp_min(r, 1e-8)
    return cam.set(cam.center + v * s, cam.center)


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


def gen_ray(cam: Pinhole, p: V2, offset: V2, width, height, basis=None) -> tuple[V3, V3]:
    """Batched Pinhole::gen_ray: p in [0,1)^2 (x right, y up), offset the
    sub-pixel jitter. Returns (origin, direction) over the batch. `basis`
    (lower_left, horizontal, vertical, origin) replaces the camera's.

    The direction is formed and normalized in float64 from the basis, p and
    offset, then rounded once to the basis dtype, as the CUDA kernels do:
    a silhouette hit's gradient is sensitive to the last bit of the ray
    (see ops/intersect.ray_sphere), so both sides must round the same
    direction. Pass p in float64 (pixel_coords(..., torch.float64)) to get
    the kernels' rays."""
    pixel_size = V2(1.0 / width, 1.0 / height)
    if basis is None:
        basis = (*camera_basis(cam, width, height), cam.origin)
    origin = basis[3]
    f64 = wide(origin.x.dtype)
    lower_left, horizontal, vertical, origin64 = (b.to(f64) for b in basis)
    rd = (
        (lower_left - origin64)
        + horizontal * (pixel_size.x * offset.x.to(f64) + p.x.to(f64))
        + vertical * (pixel_size.y * offset.y.to(f64) + p.y.to(f64))
    )
    direction = normalize(rd).to(origin.x.dtype)
    ones = torch.ones_like(direction.x)
    return V3(origin.x * ones, origin.y * ones, origin.z * ones), direction


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
