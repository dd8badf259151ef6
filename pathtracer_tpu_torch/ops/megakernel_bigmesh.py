"""The big triangle-mesh scene on the megakernel: its packed layout and
tables (K8's input), and the layout's inverse for the plain version.

Port of `pathtracer_tpu/ops/megakernel_bigmesh.py`. The big mesh backend K8
(the per-chunk box test, mt_terms and mt_hit_t over each admitted chunk,
the first-minimum winner's normal and material) is `csrc/bigmesh.cuh`, which
K1 (`csrc/megakernel_fwd.cu`) instantiates; `ops/megakernel` launches it
for a big mesh scene. Its plain version is the eager integrator on
`models/bigmesh`. As in the JAX package, the triangles do not ride in the
packed vector: the three tables of `models/bigmesh.coef_tables`, built on
the scene's device for each call, go beside it. The kernel is forward-only
here as the Pallas one is.
"""

from __future__ import annotations

import torch

from ..models import bigmesh
from ..models.scene import Scene
from .pack import cols, pack_camera, pack_lights, pack_materials, unpack_camera, unpack_lights, unpack_materials
from .vecmath import V3


def pack_bigmesh_scene(scene: Scene, width: int, height: int, with_medium: bool = False) -> torch.Tensor:
    """The big mesh scene's camera 12, sky horizon(3) zenith(3) scale,
    lights L x 15 and materials M x 20 (26 with_medium) as one [1, P]
    float32 vector on its device, the JAX package's layout. P = 74 for the
    demo scene."""
    p = scene.params.unpack()
    flat = torch.cat(
        [
            pack_camera(scene, width, height),
            torch.stack(cols(p.sky_horizon, p.sky_zenith, p.sky_scale)),
            pack_lights(scene),
            pack_materials(p.materials, with_medium),
        ]
    )
    return flat[None, :]


def unpack_bigmesh_scene(sv: torch.Tensor, scene: Scene) -> tuple[Scene, tuple]:
    """The inverse of pack_bigmesh_scene, with or without the medium: `scene` with
    every packed float leaf replaced by its entry of sv (the vertices are
    not packed and stay the scene's), and the camera basis."""
    v = sv.reshape(-1)
    p = scene.params.unpack()
    at3 = lambda i: V3(v[i], v[i + 1], v[i + 2])
    params = p._replace(sky_horizon=at3(12), sky_zenith=at3(15), sky_scale=v[18])
    params = params._replace(materials=unpack_materials(v, 19 + 15 * scene.num_lights, p.materials))
    return scene.replace(params=params, lights=unpack_lights(v, 19, scene)), unpack_camera(v)


def bigmesh_counts(scene: Scene) -> tuple[int]:
    """(chunks,) of a big mesh scene, the int its entry point takes after
    the tables."""
    return (bigmesh.tpad(scene.params) // bigmesh.CHUNK,)


def bigmesh_tables(scene: Scene) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """coef [Tpad, 16], attrT [8, Tpad] and aabb [nchunk, 8], float32 and
    contiguous on the scene's device."""
    return tuple(t.contiguous() for t in bigmesh.coef_tables(scene.params.unpack()))
