"""The small triangle-mesh scene on the megakernel: its packed layout and
topology (K7's input), and the layout's inverse for the plain version.

Port of `pathtracer_tpu/ops/megakernel_mesh.py`. The mesh backend K7 (the
Möller-Trumbore loop over the triangles, the first-minimum winner, its
face-forward normal and material) is `csrc/mesh.cuh`, which K1
(`csrc/megakernel_fwd.cu`) instantiates, and its adjoint
`csrc/mesh_adj.cuh`, which K2 (`csrc/megakernel_bwd.cu`) does;
`ops/megakernel` launches them for a mesh scene. Their plain versions are
the eager integrator on `models/mesh` and its autograd. The JAX kernel
keeps the topology in its static meta and unrolls the triangle loop at
trace time; here it is an int32 table [T, 4] of (a, b, c, material) that
K1 and K2 copy to shared memory beside the packed vector. `hit_margins`
reads how near the plain path's hits pass to an edge, where K2 and the
plain version may pick the two triangles of a shared edge apart.
"""

from __future__ import annotations

import torch

from ..integrator.tracer import VERBATIM, draw_uniforms, init_state, make_bounce_step
from ..models import mesh
from ..models.camera import gen_ray, pixel_coords
from ..models.scene import Scene
from .pack import (
    col3, cols, pack_camera, pack_lights, pack_materials, records, unpack_camera, unpack_lights, unpack_materials,
)
from .rng import split
from .vecmath import V2, V3, dot

# K1's shared memory per block, which it takes without opting in to more:
# the packed vector and the topology must fit. K2 holds its gradient table
# there too and opts in to the card's maximum (ops/megakernel.launch_backward
# checks that budget).
SHARED_BYTES = 48 * 1024


def pack_mesh_scene(scene: Scene, width: int, height: int, with_medium: bool = False) -> torch.Tensor:
    """The mesh scene as one [1, P] float32 vector on its device, the JAX
    package's layout: camera 12, vertices V x 3, sky horizon(3) zenith(3)
    scale, lights L x 15, materials M x 20 (26 with_medium). P = 145 for
    the demo scene."""
    p = scene.params.unpack()
    flat = torch.cat(
        [
            pack_camera(scene, width, height),
            records(cols(p.vertices)),
            torch.stack(cols(p.sky_horizon, p.sky_zenith, p.sky_scale)),
            pack_lights(scene),
            pack_materials(p.materials, with_medium),
        ]
    )
    return flat[None, :]


def unpack_mesh_scene(sv: torch.Tensor, scene: Scene) -> tuple[Scene, tuple]:
    """The inverse of pack_mesh_scene, with or without the medium: `scene` with
    every packed float leaf replaced by its entry of sv, and the camera
    basis (lower_left, horizontal, vertical, origin) that sv holds."""
    v = sv.reshape(-1)
    p = scene.params.unpack()
    nv = int(p.vertices.x.shape[0])
    at = 12 + 3 * nv
    at3 = lambda i: V3(v[i], v[i + 1], v[i + 2])
    params = p._replace(
        vertices=col3(v[12:at].reshape(nv, 3), 0), sky_horizon=at3(at), sky_zenith=at3(at + 3), sky_scale=v[at + 6],
    )
    lights_at = at + 7
    params = params._replace(materials=unpack_materials(v, lights_at + 15 * scene.num_lights, p.materials))
    return scene.replace(params=params, lights=unpack_lights(v, lights_at, scene)), unpack_camera(v)


def mesh_counts(scene: Scene) -> tuple[int, int]:
    """(triangles, vertices) of a mesh scene, the ints its entry points take
    after the topology. The packed vector and the topology must fit in K1's
    shared memory per block (SHARED_BYTES)."""
    p = scene.params
    n_tris, n_verts = int(p.tri_idx.shape[0]), int(p.vertices.x.shape[0])
    n_sv = 12 + 3 * n_verts + 7 + 15 * scene.num_lights + 20 * int(p.materials.roughness.shape[0])
    if 4 * (n_sv + 4 * n_tris) > SHARED_BYTES:
        raise ValueError(f"a mesh of {n_tris} triangles and {n_verts} vertices does not fit in shared memory "
                         f"({4 * (n_sv + 4 * n_tris)} > {SHARED_BYTES} bytes); the big mesh backend takes it")
    return n_tris, n_verts


def mesh_topology(scene: Scene) -> tuple[torch.Tensor]:
    """The launch's topology: [T, 4] int32 (a, b, c, material) on the
    scene's device."""
    p = scene.params
    return (torch.cat([p.tri_idx, p.tri_mat[:, None]], dim=1).to(torch.int32).contiguous(),)


def _bounce_hits(scene: Scene, key, width: int, height: int, spp: int, quirks, pixels):
    """Each bounce of the plain version's paths through the `pixels` of the
    frame (all by default), sample by sample: (state entering the bounce,
    hit distance of every triangle [n, T])."""
    p, dev = scene.params.unpack(), scene.device
    coords = pixel_coords(width, height, torch.float64, dev)
    if pixels is not None:
        coords = V2(coords.x[pixels], coords.y[pixels])
    with torch.no_grad():
        step = make_bounce_step(scene, quirks, detach=True)
        for k in [key] if spp == 1 else list(split(key, spp)):
            cam_u, bounce_u = draw_uniforms(k, width * height, scene.recursion_depth, torch.float32, dev)
            if pixels is not None:
                cam_u, bounce_u = cam_u[pixels], bounce_u[:, pixels]
            ro, rd = gen_ray(scene.camera.unpack(), coords, V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height))
            state = init_state(ro, rd, quirks)
            for u in bounce_u:
                yield state, mesh._tri_ts(p, state.ro, state.rd)
                state = step(state, u)


def hit_margins(scene: Scene, key, width: int, height: int, spp: int = 1, quirks=VERBATIM,
                pixels: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(margin, |det|) where each bounce of the plain version's path meets
    the mesh: min(u, v, 1 - u - v) of the winning triangle's barycentric
    coordinates and its Möller-Trumbore determinant, each [spp, depth, n]
    for the `pixels` of the frame given (all by default), +inf where the
    path is dead or misses. Where the margin is small the ray passes near
    an edge, and the last bits of the incoming ray can pick the other
    triangle of a shared edge (another normal, other vertices) or miss;
    where |det| is small it grazes the triangle's plane."""
    a, b, c = mesh.corners(scene.params.unpack())
    margins, dets = [], []
    for state, ts in _bounce_hits(scene, key, width, height, spp, quirks, pixels):
        idx = torch.argmin(ts, dim=-1)
        hit = state.alive & torch.isfinite(torch.take_along_dim(ts, idx[..., None], dim=-1)[..., 0])
        v0, v1, v2 = (V3(q.x[idx], q.y[idx], q.z[idx]) for q in (a, b, c))
        e1, e2, s = v1 - v0, v2 - v0, state.ro - v0
        pv = state.rd.cross(e2)
        det = dot(e1, pv)
        inv = 1.0 / torch.where(det != 0.0, det, 1.0)
        bu, bv = dot(s, pv) * inv, dot(state.rd, s.cross(e1)) * inv
        margin = torch.minimum(torch.minimum(bu, bv), 1.0 - bu - bv)
        margins.append(torch.where(hit, margin, torch.inf))
        dets.append(torch.where(hit, det.abs(), torch.inf))
    shape = (spp, scene.recursion_depth, -1)
    return torch.stack(margins).reshape(shape), torch.stack(dets).reshape(shape)


def hit_ties(scene: Scene, key, width: int, height: int, spp: int = 1, quirks=VERBATIM,
             pixels: torch.Tensor | None = None) -> torch.Tensor:
    """(t2 - t1) / t1 where each bounce of the plain version's path meets
    the mesh, t1 <= t2 the two nearest triangles' hit distances,
    [spp, depth, n] as hit_margins, +inf where the path is dead or meets
    one triangle alone. Near 0 the ray meets two coplanar triangles at
    once (the demo cube's bottom face lies on the floor), and the first
    minimum that wins depends on the last bits of the ray."""
    gaps = []
    for state, ts in _bounce_hits(scene, key, width, height, spp, quirks, pixels):
        t12 = torch.topk(ts, 2, dim=-1, largest=False).values
        t1, t2 = t12[..., 0], t12[..., 1]
        gaps.append(torch.where(state.alive & torch.isfinite(t2), (t2 - t1) / t1, torch.inf))
    return torch.stack(gaps).reshape(spp, scene.recursion_depth, -1)
