"""Ray record with the precomputed slab-test fields.

Port of `pathtracer_tpu/models/ray.py`. The integrator carries bare
(origin, direction) pairs; this record is the public constructor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.vecmath import V3


class Ray(NamedTuple):
    origin: V3
    direction: V3
    inv_direction: V3
    sign_x: torch.Tensor  # int32: 1 where inv_direction.x < 0
    sign_y: torch.Tensor
    sign_z: torch.Tensor

    def at(self, dist) -> V3:
        return self.origin + self.direction * dist


def make_ray(origin: V3, direction: V3) -> Ray:
    """Ray::new: axis-parallel directions give +-inf reciprocals."""
    inv = V3(1.0 / direction.x, 1.0 / direction.y, 1.0 / direction.z)
    return Ray(
        origin=origin,
        direction=direction,
        inv_direction=inv,
        sign_x=(inv.x < 0.0).to(torch.int32),
        sign_y=(inv.y < 0.0).to(torch.int32),
        sign_z=(inv.z < 0.0).to(torch.int32),
    )
