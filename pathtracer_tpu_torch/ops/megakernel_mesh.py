"""The small triangle-mesh scene on the megakernel: its packed layout and
topology (K7's input), and the layout's inverse for the plain version.

Port of `pathtracer_tpu/ops/megakernel_mesh.py`. The mesh backend K7 (the
Möller-Trumbore loop over the triangles, the first-minimum winner, its
face-forward normal and material) is `csrc/mesh.cuh`, which K1
(`csrc/megakernel_fwd.cu`) instantiates; `ops/megakernel` launches it for a
mesh scene. Its plain version is the eager integrator on `models/mesh`.
The JAX kernel keeps the topology in its static meta and unrolls the
triangle loop at trace time; here it is an int32 table [T, 4] of (a, b, c,
material) that K1 copies to shared memory beside the packed vector.
"""

from __future__ import annotations

import torch

from ..models.scene import Scene
from .pack import (
    col3, cols, pack_camera, pack_lights, pack_materials, records, unpack_camera, unpack_lights, unpack_materials,
)
from .vecmath import V3

# A block's shared memory without opting in to more: the packed vector and
# the topology must fit.
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
    """The inverse of pack_mesh_scene on a media-free scene: `scene` with
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
    """(triangles, vertices) of a mesh scene, the ints its entry point takes
    after the topology. The packed vector and the topology must fit in a
    block's shared memory."""
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
