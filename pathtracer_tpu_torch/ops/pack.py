"""The records every packed scene vector shares: the camera basis, the
light table and the material table, in the JAX package's layout
(`pathtracer_tpu/ops/megakernel.py` `pack_scene`, `pack_camera`,
`pack_lights`, `pack_materials`). Each family's packer
(`megakernel.pack_scene`, `megakernel_sdf.pack_sdf_scene`,
`megakernel_mesh.pack_mesh_scene`, `megakernel_bigmesh.pack_bigmesh_scene`)
puts its own records between the camera and the lights.

They are also the helpers of a scene-backend plugin's packer and its
inverse (`megakernel.KernelBackend`; `tests/torch_plugin_toy.py`): a
plugin's vector is `pack_camera`, its own records, `pack_lights`,
`pack_materials` (with the medium's fields where the scene declares a
medium), which is the layout its kernels read (`csrc/tracer.cuh`
plugin_view); `unpack_camera`, `unpack_lights` and `unpack_materials`
read them back for the plain version, which differentiates through them.
"""

from __future__ import annotations

import torch

from ..models.camera import camera_basis
from ..models.scene import Scene
from .vecmath import V3

MAT_FIELDS = (
    # (field, arity) of the media-free material record: 20 scalars.
    ("rgb", 3),
    ("anisotropic", 1),
    ("emission", 3),
    ("metallic", 1),
    ("roughness", 1),
    ("subsurface", 1),
    ("specular_tint", 1),
    ("sheen", 1),
    ("sheen_tint", 1),
    ("clearcoat", 1),
    ("clearcoat_gloss", 1),
    ("spec_trans", 1),
    ("ior", 1),
    ("opacity", 1),
    ("alpha_mode", 1),
    ("alpha_cutoff", 1),
)
# Appended to each record when with_medium: type, density, color(3), anisotropy.
MEDIUM_FIELDS = (("medium_type", 1), ("density", 1), ("color", 3), ("anisotropy", 1))


def cols(*leaves) -> list[torch.Tensor]:
    """Flatten V3s into their components, everything as float32."""
    out = []
    for leaf in leaves:
        parts = leaf if isinstance(leaf, tuple) else (leaf,)
        out += [t.to(torch.float32) for t in parts]
    return out


def records(columns: list[torch.Tensor]) -> torch.Tensor:
    """[K] columns -> the flat row-major [K x len(columns)] record table."""
    return torch.stack(columns, dim=1).reshape(-1)


def pack_camera(scene: Scene, width: int, height: int) -> torch.Tensor:
    """lower_left, horizontal, vertical, origin: 12 floats."""
    cam = scene.camera.unpack()
    lower_left, horizontal, vertical = camera_basis(cam, width, height)
    return torch.stack(cols(lower_left, horizontal, vertical, cam.origin))


def pack_lights(scene: Scene) -> torch.Tensor:
    """L x [position(3), emission(3), u(3), v(3), radius, area, type]."""
    lt = scene.lights.unpack()
    return records(cols(lt.position, lt.emission, lt.u, lt.v, lt.radius, lt.area, lt.light_type))


def pack_materials(materials, with_medium: bool = False) -> torch.Tensor:
    """M x 20 (M x 26 with the medium fields)."""
    leaves = [getattr(materials, name) for name, _ in MAT_FIELDS]
    if with_medium:
        leaves += [getattr(materials.medium, name) for name, _ in MEDIUM_FIELDS]
    return records(cols(*leaves))


def col3(t: torch.Tensor, i: int) -> V3:
    """Columns i, i+1, i+2 of a record table [K, stride] as a V3 of [K]."""
    return V3(t[:, i], t[:, i + 1], t[:, i + 2])


def unpack_camera(v: torch.Tensor) -> tuple:
    """The camera basis (lower_left, horizontal, vertical, origin) that a
    packed vector holds in its first 12 entries."""
    return tuple(V3(v[i], v[i + 1], v[i + 2]) for i in (0, 3, 6, 9))


def unpack_lights(v: torch.Tensor, at: int, scene: Scene) -> tuple:
    """The scene's light table with its float leaves read from the L x 15
    records at v[at:]."""
    n = scene.num_lights
    lt = v[at:at + 15 * n].reshape(n, 15)
    return scene.lights.unpack()._replace(
        position=col3(lt, 0), emission=col3(lt, 3), u=col3(lt, 6), v=col3(lt, 9), radius=lt[:, 12],
        area=lt[:, 13],
    )


def unpack_materials(v: torch.Tensor, at: int, materials) -> tuple:
    """`materials` with its float fields read from the records at v[at:],
    the vector's tail: M x 20, or M x 26 with the medium's fields (the int
    leaves alpha_mode and medium_type are kept)."""
    n = int(materials.roughness.shape[0])
    stride = (v.shape[0] - at) // n if n else 20
    if stride not in (20, 26) or at + stride * n != v.shape[0]:
        raise ValueError(f"{v.shape[0] - at} scalars after offset {at} are not {n} material records")
    mt = v[at:].reshape(n, stride)
    fields, col = {}, 0
    for name, arity in MAT_FIELDS + (MEDIUM_FIELDS if stride == 26 else ()):
        if name not in ("alpha_mode", "medium_type"):
            fields[name] = col3(mt, col) if arity == 3 else mt[:, col]
        col += arity
    medium = {k: fields.pop(k) for k in ("density", "color", "anisotropy") if k in fields}
    return materials._replace(**fields, medium=materials.medium._replace(**medium))
