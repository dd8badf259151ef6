"""The small triangle-mesh scene: a ground quad, a metal cube and a
clearcoat pyramid (20 two-sided triangles, 17 vertices), lit and framed
like the analytical demo.

Port of `pathtracer_tpu/models/mesh.py`. The vertex positions are
buffers, so gradients reach them through Möller-Trumbore; the triangle
indices and their material ids (`tri_idx`, `tri_mat`) are integer buffers
that nothing differentiates, the static structure the JAX package keeps
as aux data. The closest hit is the first minimum over the triangles in
order (the JAX where-chain's strict `<`), with the winner's geometric
normal turned against the ray; at a tie (an edge two triangles share) t
and its gradient are the first triangle's, as in the JAX chain.
`csrc/mesh.cuh` (K7 inside K1) computes the same per thread, and
`csrc/mesh_adj.cuh` (its adjoint inside K2) the gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.intersect import MISS, ray_triangle
from ..ops.vecmath import V3, dot, safe_normalize, v3
from .analytical import background  # the same sky: gamma-decoded lerp times sky_scale
from .camera import default_pinhole
from .light import spherical_light
from .material import Material, default_material, gather_material, make_material, select_material, stack_materials
from .scene import Scene, SurfaceHit


# MeshParams' static fields: no leaves of the JAX package's pytree, so no
# entries of a scene file
STATIC = ("tri_idx", "tri_mat")


class MeshParams(NamedTuple):
    """The mesh scene's values; field order and names are the JAX
    package's."""

    vertices: V3  # [V]
    materials: Material  # [M]
    sky_horizon: V3
    sky_zenith: V3
    sky_scale: torch.Tensor
    tri_idx: torch.Tensor  # [T, 3] int64 vertex indices, static
    tri_mat: torch.Tensor  # [T] int64 material ids, static


def _cube(center, half):
    cx, cy, cz = center
    vs = [
        (cx - half, cy - half, cz - half), (cx + half, cy - half, cz - half),
        (cx + half, cy + half, cz - half), (cx - half, cy + half, cz - half),
        (cx - half, cy - half, cz + half), (cx + half, cy - half, cz + half),
        (cx + half, cy + half, cz + half), (cx - half, cy + half, cz + half),
    ]
    quads = [(0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7), (1, 5, 6, 2), (3, 2, 6, 7), (4, 5, 1, 0)]
    tris = []
    for a, b, c, d in quads:
        tris += [(a, b, c), (a, c, d)]
    return vs, tris


def default_params(dtype=torch.float32, device=None) -> MeshParams:
    """The demo mesh, verbatim from the JAX package."""
    verts: list = []
    tris: list = []
    mats: list = []

    def add(vs, ts, mat_id):
        base = len(verts)
        verts.extend(vs)
        tris.extend(tuple(base + i for i in t) for t in ts)
        mats.extend([mat_id] * len(ts))

    s = 6.0
    add([(-s, -1.0, -s), (s, -1.0, -s), (s, -1.0, s), (-s, -1.0, s)], [(0, 1, 2), (0, 2, 3)], 0)
    add(*_cube((-1.2, -0.35, 0.0), 0.65), mat_id=1)
    b, apex = 1.0, (1.3, 0.9, 0.0)
    add(
        [(1.3 - b, -1.0, -b), (1.3 + b, -1.0, -b), (1.3 + b, -1.0, b), (1.3 - b, -1.0, b), apex],
        [(0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4), (0, 2, 1), (0, 3, 2)],
        2,
    )
    kw = dict(dtype=dtype, device=device)
    return MeshParams(
        vertices=V3(*(torch.tensor([p[i] for p in verts], **kw) for i in range(3))),
        materials=stack_materials([
            make_material(rgb=(0.55, 0.57, 0.62), roughness=0.9, **kw),
            make_material(rgb=(1.0, 1.0, 1.0), roughness=0.1, metallic=1.0, **kw),
            make_material(rgb=(1.0, 0.186, 0.0), clearcoat=1.0, clearcoat_gloss=1.0, roughness=0.1, **kw),
        ]),
        sky_horizon=v3(1.0, 1.0, 1.0, **kw),
        sky_zenith=v3(0.5, 0.7, 1.0, **kw),
        sky_scale=torch.tensor(0.5, **kw),
        tri_idx=torch.tensor(tris, dtype=torch.int64, device=device),
        tri_mat=torch.tensor(mats, dtype=torch.int64, device=device),
    )


def corners(p: MeshParams) -> tuple[V3, V3, V3]:
    """The three corners of every triangle, V3s of [T]."""
    take = lambda i: V3(p.vertices.x[i], p.vertices.y[i], p.vertices.z[i])
    return take(p.tri_idx[:, 0]), take(p.tri_idx[:, 1]), take(p.tri_idx[:, 2])


def _tri_ts(p: MeshParams, ro: V3, rd: V3) -> torch.Tensor:
    """Hit distance of every ray against every triangle, [..., T]."""
    col = lambda v: V3(v.x[..., None], v.y[..., None], v.z[..., None])
    return ray_triangle(col(ro), col(rd), *corners(p))


def closest_hit(p: MeshParams, ro: V3, rd: V3) -> SurfaceHit:
    """First minimum over the triangles in order, the winner's geometric
    normal turned against the ray (two-sided triangles), its material by
    its static id. A miss takes triangle 0's normal and the default
    material."""
    ts = _tri_ts(p, ro, rd)
    # the first minimum, as the strict `<` chain: at a tie (an edge two
    # triangles share) t and its gradient are the first triangle's alone,
    # where amin would share the gradient
    idx = torch.argmin(ts, dim=-1)
    t = torch.take_along_dim(ts, idx[..., None], dim=-1)[..., 0]
    hit = torch.isfinite(t)
    a, b, c = corners(p)
    n = safe_normalize((b - a).cross(c - a))
    normal = V3(n.x[idx], n.y[idx], n.z[idx])
    normal = normal * torch.where(dot(normal, rd) > 0.0, -1.0, 1.0)
    mat = gather_material(p.materials, p.tri_mat[idx])
    mat = select_material(hit, mat, default_material(t.shape, rd.x.dtype, rd.x.device))
    return SurfaceHit(t=torch.where(hit, t, MISS), normal=normal, material=mat)


def any_hit(p: MeshParams, ro: V3, rd: V3, max_dist) -> torch.Tensor:
    """Occlusion closer than max_dist (the fixed semantics)."""
    return torch.amin(_tri_ts(p, ro, rd), dim=-1) < max_dist


def make_scene(
    dtype=torch.float32,
    recursion_depth: int = 4,
    params: MeshParams | None = None,
    lights=None,
    device=None,
) -> Scene:
    """The mesh demo scene with the analytical demo's light (spherical at
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
