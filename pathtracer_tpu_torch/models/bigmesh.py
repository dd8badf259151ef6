"""The large triangle-mesh scene: a 1,088-triangle UV sphere over a ground
quad (1,090 triangles), lit and framed like the analytical demo.

Port of `pathtracer_tpu/models/bigmesh.py`. Möller-Trumbore is written over
16 coefficients per triangle (`coef_tables`) and 16 features per ray
(direction d, moment m = o x d, origin o):

    det     = -(n . d)                       n   = e1 x e2
    u * det = (v0 x e2) . d  +  e2 . m
    v * det = (e1 x v0) . d  -  e1 . m
    t * det = n . o  -  v0 . n

`mt_terms` and `mt_hit_t` keep the JAX package's operation order, so a
pair's t rounds as JAX's does. Triangles are Morton-ordered by centroid
and padded to chunks of CHUNK = 128 with per-chunk bounding boxes, which
the CUDA backend (`csrc/bigmesh.cuh`, K8 inside K1) tests per ray to skip
chunks. The closest hit is the first minimum over all triangles (argmin's
lowest index). Where JAX's twin materialises [N, Tpad] pair matrices, the
plain version here walks blocks of rays with the same per-pair arithmetic,
so it fits in the card's memory at 1920x1080. Vertices are buffers, and
autograd reaches them through the tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.intersect import MISS
from ..ops.vecmath import V3, dot, safe_normalize, v3, where3
from .analytical import background  # the same sky: gamma-decoded lerp times sky_scale
from .camera import default_pinhole
from .light import spherical_light
from .material import Material, default_material, gather_material, make_material, select_material, stack_materials
from ..utils.tree import tree_map
from .scene import Scene, SurfaceHit

EPS = 1e-7  # the guards of ops.intersect.ray_triangle
CHUNK = 128  # triangles per culling chunk
FEAT = 16  # ray features [d(3), m(3), o(3), 1, pad(6)]
BLOCK_PAIRS = 2**24  # (ray, triangle) pairs per block of the plain version


# BigMeshParams' static fields: no leaves of the JAX package's pytree, so
# no entries of a scene file
STATIC = ("tri_a", "tri_b", "tri_c", "tri_mat")


class BigMeshParams(NamedTuple):
    """The big mesh scene's values; field order and names are the JAX
    package's. The topology (Morton-ordered) is integer buffers that nothing
    differentiates."""

    vertices: V3  # [V]
    materials: Material  # [M]
    sky_horizon: V3
    sky_zenith: V3
    sky_scale: torch.Tensor
    tri_a: torch.Tensor  # [T] int64, static
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    tri_mat: torch.Tensor  # [T] int64, static


def num_tris(p: BigMeshParams) -> int:
    return int(p.tri_a.shape[0])


def tpad(p: BigMeshParams) -> int:
    """The triangle count padded to whole chunks."""
    return -(-num_tris(p) // CHUNK) * CHUNK


def _tri_corners(p: BigMeshParams) -> tuple[V3, V3, V3]:
    take = lambda i: V3(p.vertices.x[i], p.vertices.y[i], p.vertices.z[i])
    return take(p.tri_a), take(p.tri_b), take(p.tri_c)


def mt_terms(cols, d, m, o):
    """Möller-Trumbore pair terms from the 16 coefficient columns, in the
    JAX package's operation order. Column layout (coef_tables):
    0-2 n | 3-5 v0 x e2 | 6-8 e2 | 9-11 e1 x v0 | 12-14 -e1 | 15 -v0.n"""
    det = -((cols[0] * d[0] + cols[1] * d[1]) + cols[2] * d[2])
    u_num = ((cols[3] * d[0] + cols[4] * d[1]) + cols[5] * d[2]) + ((cols[6] * m[0] + cols[7] * m[1]) + cols[8] * m[2])
    v_num = ((cols[9] * d[0] + cols[10] * d[1]) + cols[11] * d[2]) + (
        (cols[12] * m[0] + cols[13] * m[1]) + cols[14] * m[2])
    t_num = ((cols[0] * o[0] + cols[1] * o[1]) + cols[2] * o[2]) + cols[15]
    return det, u_num, v_num, t_num


def mt_hit_t(det, u_num, v_num, t_num, eps=EPS):
    """Hit distance per pair, MISS where invalid: ray_triangle's guards at
    the same eps (inv = 0 where |det| <= eps)."""
    absdet = torch.abs(det)
    inv = torch.where(absdet > eps, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    u = u_num * inv
    v = v_num * inv
    t = t_num * inv
    ok = (absdet > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return torch.where(ok, t, MISS)


def coef_tables(p: BigMeshParams) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The intersection tables, float32 on the scene's device (autograd
    reaches the vertices through coef and attrT; every product is its own
    tensor op, never a fused cross product):

      coef  [Tpad, 16] the mt_terms coefficients; padding rows are zero
            (det = 0, never a hit);
      attrT [8, Tpad]  rows n.x, n.y, n.z (the unnormalised e1 x e2),
            material id, then zeros;
      aabb  [nchunk, 8] each chunk's min xyz, max xyz, 0, 0, detached."""
    T, Tp = num_tris(p), tpad(p)
    v0, v1, v2 = _tri_corners(p)
    e1, e2 = v1 - v0, v2 - v0
    n = e1.cross(e2)
    cud = v0.cross(e2)
    cvd = e1.cross(v0)
    coef = torch.stack(
        [n.x, n.y, n.z, cud.x, cud.y, cud.z, e2.x, e2.y, e2.z, cvd.x, cvd.y, cvd.z, -e1.x, -e1.y, -e1.z, -dot(v0, n)],
        dim=1,
    )
    coef = torch.nn.functional.pad(coef, (0, 0, 0, Tp - T))
    zero = torch.zeros_like(n.x)
    attrT = torch.stack([n.x, n.y, n.z, p.tri_mat.to(n.x.dtype)] + [zero] * 4, dim=0)
    attrT = torch.nn.functional.pad(attrT, (0, Tp - T))
    with torch.no_grad():
        big = 3.4e38
        lo = [torch.minimum(torch.minimum(a, b), c) for a, b, c in zip(v0, v1, v2)]
        hi = [torch.maximum(torch.maximum(a, b), c) for a, b, c in zip(v0, v1, v2)]
        chunked = lambda x, fill: torch.nn.functional.pad(x.float(), (0, Tp - T), value=fill).reshape(-1, CHUNK)
        mins = [chunked(x, big).amin(dim=1) for x in lo]
        maxs = [chunked(x, -big).amax(dim=1) for x in hi]
        pad = torch.zeros_like(mins[0])
        aabb = torch.stack(mins + maxs + [pad, pad], dim=1)
    return coef.to(torch.float32), attrT.to(torch.float32), aabb


def _ray_rows(ro: V3, rd: V3):
    """Flat [N, 1] feature columns (d, m, o)."""
    flat = lambda a: a.reshape(-1, 1)
    ro = V3(*(torch.broadcast_to(c, rd.x.shape) for c in ro))
    mv = ro.cross(rd)
    return [flat(c) for c in rd], [flat(c) for c in mv], [flat(c) for c in ro]


def _blocks(n: int, tp: int):
    """Slices of at most BLOCK_PAIRS // tp rays."""
    rows = max(1, BLOCK_PAIRS // tp)
    return [slice(a, min(a + rows, n)) for a in range(0, n, rows)]


def pair_ts(coef: torch.Tensor, d, m, o) -> torch.Tensor:
    """t of every (ray, triangle) pair, [B, Tpad], for feature columns of
    B rays."""
    cols = [coef[:, k][None, :] for k in range(FEAT)]
    return mt_hit_t(*mt_terms(cols, d, m, o))


def closest_hit(p: BigMeshParams, ro: V3, rd: V3) -> SurfaceHit:
    """The first minimum over the whole table (lowest index on a tie), the
    winner's normalised normal from attrT turned against the ray (up
    (0, 1, 0) on a miss), its material id from attrT."""
    n_shape = rd.x.shape
    coef, attrT, _ = coef_tables(p)
    d, m, o = _ray_rows(ro, rd)
    ts, idxs = [], []
    for b in _blocks(d[0].shape[0], coef.shape[0]):
        t_pairs = pair_ts(coef, [c[b] for c in d], [c[b] for c in m], [c[b] for c in o])
        ts.append(torch.amin(t_pairs, dim=1))
        idxs.append(torch.argmin(t_pairs, dim=1))
    t, idx = torch.cat(ts), torch.cat(idxs)
    hit = torch.isfinite(t)
    normal = safe_normalize(V3(attrT[0][idx], attrT[1][idx], attrT[2][idx]))
    up = V3(torch.zeros_like(t), torch.ones_like(t), torch.zeros_like(t))
    normal = where3(hit, normal, up)
    rdf = V3(*(c.reshape(-1) for c in rd))
    normal = normal * torch.where(dot(normal, rdf) > 0.0, -1.0, 1.0)
    mat = gather_material(p.materials, attrT[3][idx].to(torch.int64))
    mat = select_material(hit, mat, default_material(t.shape, rd.x.dtype, rd.x.device))
    shape = lambda a: a.reshape(n_shape)
    return SurfaceHit(
        t=shape(torch.where(hit, t, MISS)),
        normal=V3(*(shape(c) for c in normal)),
        material=tree_map(shape, mat),
    )


def any_hit(p: BigMeshParams, ro: V3, rd: V3, max_dist) -> torch.Tensor:
    """Occlusion closer than max_dist (the fixed semantics)."""
    n_shape = rd.x.shape
    coef, _, _ = coef_tables(p)
    d, m, o = _ray_rows(ro, rd)
    md = torch.broadcast_to(torch.as_tensor(max_dist, device=rd.x.device), n_shape).reshape(-1, 1)
    out = [
        (pair_ts(coef, [c[b] for c in d], [c[b] for c in m], [c[b] for c in o]) < md[b]).any(dim=1)
        for b in _blocks(d[0].shape[0], coef.shape[0])
    ]
    return torch.cat(out).reshape(n_shape)


# ---------------------------------------------------------------------------
# Demo geometry: a tessellated UV sphere over a ground quad
# ---------------------------------------------------------------------------


def uv_sphere(center, radius, stacks=17, sectors=34):
    """(stacks-2)*sectors*2 + 2*sectors triangles (17 x 34 -> 1088)."""
    cx, cy, cz = center
    verts = [(cx, cy + radius, cz)]
    for i in range(1, stacks):
        phi = np.pi * i / stacks
        for j in range(sectors):
            th = 2.0 * np.pi * j / sectors
            verts.append((
                cx + radius * np.sin(phi) * np.cos(th),
                cy + radius * np.cos(phi),
                cz + radius * np.sin(phi) * np.sin(th),
            ))
    verts.append((cx, cy - radius, cz))
    bot = len(verts) - 1
    ring = lambda i, j: 1 + (i - 1) * sectors + (j % sectors)
    tris = []
    for j in range(sectors):
        tris.append((0, ring(1, j + 1), ring(1, j)))
    for i in range(1, stacks - 1):
        for j in range(sectors):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            tris += [(a, b, d), (a, d, c)]
    for j in range(sectors):
        tris.append((bot, ring(stacks - 1, j), ring(stacks - 1, j + 1)))
    return verts, tris


def morton_order(verts, tris):
    """The permutation of the triangles by their centroids' Morton codes
    (stable), so chunks are compact in space."""
    v = np.asarray(verts, np.float64)
    cent = v[np.asarray(tris)].mean(axis=1)
    lo, hi = cent.min(axis=0), cent.max(axis=0)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint64)

    def spread(x):
        x &= 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def grid_quad(corner, du, dv, nu=8, nv=8):
    """A parallelogram of nu x nv x 2 triangles."""
    cx, cy, cz = corner
    verts, tris = [], []
    for i in range(nu + 1):
        for j in range(nv + 1):
            fi, fj = i / nu, j / nv
            verts.append((cx + fi * du[0] + fj * dv[0], cy + fi * du[1] + fj * dv[1], cz + fi * du[2] + fj * dv[2]))
    at = lambda i, j: i * (nv + 1) + j
    for i in range(nu):
        for j in range(nv):
            a, b, c, d = at(i, j), at(i + 1, j), at(i + 1, j + 1), at(i, j + 1)
            tris += [(a, b, c), (a, c, d)]
    return verts, tris


def default_params(dtype=torch.float32, device=None, ground_grid: int = 0) -> BigMeshParams:
    """The demo: a 1,088-triangle orange clearcoat sphere over the ground
    (one quad, or ground_grid x ground_grid x 2 triangles), Morton-ordered,
    verbatim from the JAX package."""
    verts, tris, mats = [], [], []

    def add(vs, ts, mat_id):
        base = len(verts)
        verts.extend(vs)
        tris.extend(tuple(base + i for i in t) for t in ts)
        mats.extend([mat_id] * len(ts))

    s = 6.0
    if ground_grid > 0:
        add(*grid_quad((-s, -1.0, -s), (2 * s, 0.0, 0.0), (0.0, 0.0, 2 * s), nu=ground_grid, nv=ground_grid),
            mat_id=0)
    else:
        add([(-s, -1.0, -s), (s, -1.0, -s), (s, -1.0, s), (-s, -1.0, s)], [(0, 1, 2), (0, 2, 3)], 0)
    add(*uv_sphere((0.0, 0.0, 0.0), 1.0), mat_id=1)
    order = morton_order(verts, tris)
    tris = [tris[i] for i in order]
    mats = [mats[i] for i in order]
    kw = dict(dtype=dtype, device=device)
    topo = lambda col: torch.tensor([t[col] for t in tris], dtype=torch.int64, device=device)
    return BigMeshParams(
        vertices=V3(*(torch.tensor([p[i] for p in verts], **kw) for i in range(3))),
        materials=stack_materials([
            make_material(rgb=(0.55, 0.57, 0.62), roughness=0.9, **kw),
            make_material(rgb=(1.0, 0.186, 0.0), clearcoat=1.0, clearcoat_gloss=1.0, roughness=0.15, **kw),
        ]),
        sky_horizon=v3(1.0, 1.0, 1.0, **kw),
        sky_zenith=v3(0.5, 0.7, 1.0, **kw),
        sky_scale=torch.tensor(0.5, **kw),
        tri_a=topo(0),
        tri_b=topo(1),
        tri_c=topo(2),
        tri_mat=torch.tensor(mats, dtype=torch.int64, device=device),
    )


def make_scene(
    dtype=torch.float32,
    recursion_depth: int = 4,
    params: BigMeshParams | None = None,
    lights=None,
    device=None,
) -> Scene:
    """The big mesh demo scene with the analytical demo's light (spherical
    at (3,2,2), r = 1, emission (3,3,3)) and camera."""
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
