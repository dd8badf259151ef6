# Frozen copy of pathtracer_tpu_torch/models/material.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""Disney/principled material records.

Port of `pathtracer_tpu/models/material.py`. A `Material` is a NamedTuple
of tensors: one record (0-d fields), a table ([M] fields) or a per-ray
batch ([N] fields) share the type. `alpha_mode` and `medium_type` are
int32; every other field has the scene's float dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import V3, clip, maximum, mix, mix_f, v3
from .tree import tree_map


class MediumType:
    NONE = 0
    ABSORB = 1
    SCATTER = 2
    EMISSIVE = 3


class AlphaMode:
    OPAQUE = 0
    BLEND = 1
    MASK = 2


class Medium(NamedTuple):
    """Volumetric medium parameters."""

    medium_type: torch.Tensor  # int32
    density: torch.Tensor
    color: V3
    anisotropy: torch.Tensor


class Material(NamedTuple):
    """Full principled parameter set; field names as in the JAX package."""

    rgb: V3
    anisotropic: torch.Tensor
    emission: V3

    metallic: torch.Tensor
    roughness: torch.Tensor
    subsurface: torch.Tensor
    specular_tint: torch.Tensor

    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    clearcoat_roughness: torch.Tensor  # derived by finalize_material

    spec_trans: torch.Tensor
    ior: torch.Tensor

    opacity: torch.Tensor
    alpha_mode: torch.Tensor  # int32
    alpha_cutoff: torch.Tensor

    ax: torch.Tensor  # derived by finalize_material
    ay: torch.Tensor

    medium: Medium


def default_medium(shape=(), dtype=torch.float32, device=None) -> Medium:
    f = lambda c: torch.full(shape, c, dtype=dtype, device=device)
    z = f(0.0)
    return Medium(
        medium_type=torch.full(shape, MediumType.NONE, dtype=torch.int32, device=device),
        density=f(0.0),
        color=V3(z, z, z),
        anisotropy=f(0.0),
    )


def default_material(shape=(), dtype=torch.float32, device=None) -> Material:
    """Material::new defaults, including the out-of-range albedo 1.5."""
    f = lambda c: torch.full(shape, c, dtype=dtype, device=device)
    albedo = f(1.5)
    zero = f(0.0)
    return Material(
        rgb=V3(albedo, albedo, albedo),
        anisotropic=f(0.0),
        emission=V3(zero, zero, zero),
        metallic=f(0.0),
        roughness=f(0.5),
        subsurface=f(0.0),
        specular_tint=f(0.0),
        sheen=f(0.0),
        sheen_tint=f(0.0),
        clearcoat=f(0.0),
        clearcoat_gloss=f(0.0),
        clearcoat_roughness=f(0.0),
        spec_trans=f(0.0),
        ior=f(1.45),
        opacity=f(1.0),
        alpha_mode=torch.full(shape, AlphaMode.OPAQUE, dtype=torch.int32, device=device),
        alpha_cutoff=f(0.0),
        ax=f(0.0),
        ay=f(0.0),
        medium=default_medium(shape, dtype, device),
    )


def finalize_material(m: Material) -> Material:
    """Material::finalize: clamp roughness, map clearcoat gloss to
    roughness, clamp the medium anisotropy, derive the GGX alphas."""
    roughness = maximum(m.roughness, 0.01)
    clearcoat_roughness = mix_f(0.1, 0.001, m.clearcoat_gloss)
    medium = m.medium._replace(anisotropy=clip(m.medium.anisotropy, -0.9, 0.9))
    aspect = torch.sqrt(1.0 - m.anisotropic * 0.9)
    ax = maximum(roughness / aspect, 0.001)
    ay = maximum(roughness * aspect, 0.001)
    return m._replace(
        roughness=roughness,
        clearcoat_roughness=clearcoat_roughness,
        medium=medium,
        ax=ax,
        ay=ay,
    )


def mix_materials(a: Material, b: Material, t: torch.Tensor) -> Material:
    """Material::mix: the lerp of the listed fields; every other field
    (clearcoat_roughness, opacity, the alpha fields, ax, ay, the medium)
    keeps Material::new's default, as the reference leaves it."""
    m = default_material(t.shape, t.dtype, t.device)
    lerp = lambda name: mix_f(getattr(a, name), getattr(b, name), t)
    return m._replace(
        rgb=mix(a.rgb, b.rgb, t),
        emission=mix(a.emission, b.emission, t),
        **{name: lerp(name) for name in (
            "anisotropic", "metallic", "roughness", "subsurface", "specular_tint", "sheen", "sheen_tint",
            "clearcoat", "clearcoat_gloss", "spec_trans", "ior")},
    )


def gather_material(table: Material, idx: torch.Tensor) -> Material:
    """Per-ray materials from an [M] table."""
    return tree_map(lambda leaf: leaf[idx], table)


def select_material(cond: torch.Tensor, a: Material, b: Material) -> Material:
    """Componentwise where() over all material leaves."""
    return tree_map(lambda la, lb: torch.where(cond, la, lb), a, b)


def make_material(dtype=torch.float32, device=None, **overrides) -> Material:
    """Scalar record with Material::new defaults; rgb/emission take
    3-tuples."""
    m = default_material((), dtype, device)
    fixed = {}
    for k, val in overrides.items():
        if k in ("rgb", "emission") and not isinstance(val, V3):
            val = v3(*val, dtype=dtype, device=device)
        elif k == "alpha_mode":
            val = torch.as_tensor(val, dtype=torch.int32, device=device)
        elif not isinstance(val, (V3, Medium)):
            val = torch.as_tensor(val, dtype=dtype, device=device)
        fixed[k] = val
    return m._replace(**fixed)


def stack_materials(mats: list[Material]) -> Material:
    """Stack scalar records into an [M] table."""
    return tree_map(lambda *leaves: torch.stack(leaves), *mats)
