# Frozen copy of pathtracer_tpu_torch/models/light.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""Analytical lights as stacked [L] tensors.

Port of `pathtracer_tpu/models/light.py`: spherical, rectangular and
distant lights in one table, so the integrator's uniform light pick is a
gather.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import PI, V3, v3
from .tree import tree_map


class LightType:
    RECTANGULAR = 0
    SPHERICAL = 1
    DISTANT = 2


class Lights(NamedTuple):
    """Stacked light records ([L]-shaped fields)."""

    light_type: torch.Tensor  # int32 [L]
    position: V3
    emission: V3
    u: V3  # rect edges; zero for other types
    v: V3
    radius: torch.Tensor
    area: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.radius.shape[0])


def _as_v3(a, dtype, device) -> V3:
    return a if isinstance(a, V3) else v3(*a, dtype=dtype, device=device)


def _lift(w: V3) -> V3:
    return V3(w.x.reshape(1), w.y.reshape(1), w.z.reshape(1))


def _one(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=device).reshape(1)


def _zeros3(dtype, device) -> V3:
    z = torch.zeros(1, dtype=dtype, device=device)
    return V3(z, z, z)


def spherical_light(position, radius, emission, dtype=torch.float32, device=None) -> Lights:
    """AnalyticalLight::spherical: area = 4 pi r^2."""
    r = torch.as_tensor(radius, dtype=dtype, device=device)
    return Lights(
        light_type=torch.tensor([LightType.SPHERICAL], dtype=torch.int32, device=device),
        position=_lift(_as_v3(position, dtype, device)),
        emission=_lift(_as_v3(emission, dtype, device)),
        u=_zeros3(dtype, device),
        v=_zeros3(dtype, device),
        radius=r.reshape(1),
        area=(4.0 * PI * r * r).reshape(1),
    )


def rect_light(position, u, v_edge, emission, dtype=torch.float32, device=None) -> Lights:
    """Rectangle spanned by edges u, v from the corner `position`;
    area = |u x v|."""
    uu = _as_v3(u, dtype, device)
    vv = _as_v3(v_edge, dtype, device)
    return Lights(
        light_type=torch.tensor([LightType.RECTANGULAR], dtype=torch.int32, device=device),
        position=_lift(_as_v3(position, dtype, device)),
        emission=_lift(_as_v3(emission, dtype, device)),
        u=_lift(uu),
        v=_lift(vv),
        radius=_one(0.0, dtype, device),
        area=uu.cross(vv).length().reshape(1),
    )


def distant_light(direction, emission, dtype=torch.float32, device=None) -> Lights:
    """Directional light; `direction` (stored in `position`) points from
    the shading point toward the light. area = 0 keeps it out of MIS and
    out of the emitter pass."""
    return Lights(
        light_type=torch.tensor([LightType.DISTANT], dtype=torch.int32, device=device),
        position=_lift(_as_v3(direction, dtype, device)),
        emission=_lift(_as_v3(emission, dtype, device)),
        u=_zeros3(dtype, device),
        v=_zeros3(dtype, device),
        radius=_one(0.0, dtype, device),
        area=_one(0.0, dtype, device),
    )


def concat_lights(*groups: Lights) -> Lights:
    """Combine light groups into one table."""
    return tree_map(lambda *leaves: torch.cat(leaves, dim=0), *groups)


def gather_light(lights: Lights, idx: torch.Tensor) -> Lights:
    """Per-ray light records."""
    return tree_map(lambda leaf: leaf[idx], lights)
