"""Scene-backend plugins of the port, defined entirely here, outside the
package: what a downstream package writes to render its own scene family
through the port's kernels (`ops/megakernel.KernelBackend`,
`register_backend`), and the torch twin of the JAX package's plugin test
(`tests/test_backend_plugin.py:53-173`). Not a test file: the tests
(`test_torch_backend_plugin.py`, `test_torch_plugin_kernel_host.py`,
`test_torch_kernel_cuda.py`) and `chip_smoke.py` phase 38 import it. It
imports no JAX.

Three plugins, registered when this module is imported (`register`), their
backend structs in `torch_plugin_toy.cuh`:

- `toy`: one sphere, a sky gradient, one spherical light and one material
  (JAX's `make_toy_scene`), with its packer in JAX's layout (`toy_pack`:
  camera 12, center 3, radius, horizon 3, zenith 3, scale, the lights, the
  material) and its inverse, and an adjoint struct: K1, K3 and K2.
- `toy_extra`: the same scene with the sphere's center and radius in an
  extra tensor beside the packed vector (the JAX package's `extra_of`):
  K1 and K3 only.
- `stripes`: the analytical scene with the JAX package's `_stripes`
  procedural hook (`tests/test_procedural.py:16-27`) applied after its
  closest hit, the kernel route of a procedural hook: K1 and K3 only.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from pathtracer_tpu_torch.integrator.inverse import named_leaves, replace_leaves
from pathtracer_tpu_torch.models import analytical
from pathtracer_tpu_torch.models.camera import default_pinhole
from pathtracer_tpu_torch.models.light import spherical_light
from pathtracer_tpu_torch.models.material import (
    Material,
    MediumType,
    default_material,
    gather_material,
    make_material,
    select_material,
    stack_materials,
)
from pathtracer_tpu_torch.models.scene import Scene, SurfaceHit
from pathtracer_tpu_torch.ops import megakernel as mk
from pathtracer_tpu_torch.ops.intersect import MISS, ray_sphere
from pathtracer_tpu_torch.ops.pack import (
    cols,
    pack_camera,
    pack_lights,
    pack_materials,
    unpack_camera,
    unpack_lights,
    unpack_materials,
)
from pathtracer_tpu_torch.ops.vecmath import V3, mix, safe_normalize, splat3, v3

HEADER = Path(__file__).with_suffix(".cuh")
# where the toy's lights start in its packed vector (toy_pack), and the
# toy_extra's
TOY_LIGHTS_AT, EXTRA_LIGHTS_AT = 23, 19


class ToyParams(NamedTuple):
    center: V3  # scalar V3
    radius: torch.Tensor
    materials: Material  # [1]
    sky_horizon: V3
    sky_zenith: V3
    sky_scale: torch.Tensor


def toy_background(p: ToyParams, rd: V3) -> V3:
    t = 0.5 * (rd.y + 1.0)
    return mix(p.sky_horizon, p.sky_zenith, t).to_linear() * splat3(p.sky_scale)


def toy_closest_hit(p: ToyParams, ro: V3, rd: V3) -> SurfaceHit:
    t = ray_sphere(ro, rd, p.center, p.radius)
    hit = torch.isfinite(t)
    hp = ro + rd * torch.where(hit, t, 0.0)
    normal = safe_normalize(hp - p.center)
    n = rd.x.shape
    mat = gather_material(p.materials, torch.zeros(n, dtype=torch.int64, device=rd.x.device))
    mat = select_material(hit, mat, default_material(n, rd.x.dtype, rd.x.device))
    return SurfaceHit(t=torch.where(hit, t, MISS), normal=normal, material=mat)


def toy_any_hit(p: ToyParams, ro: V3, rd: V3, max_dist) -> torch.Tensor:
    t = ray_sphere(ro, rd, p.center, p.radius)
    return torch.isfinite(t) & (t < max_dist)


def toy_extra_closest_hit(p: ToyParams, ro: V3, rd: V3) -> SurfaceHit:
    """The toy's closest hit under the toy_extra family's name (a plugin
    claims its scenes by this function)."""
    return toy_closest_hit(p, ro, rd)


def make_toy_scene(dtype=torch.float32, recursion_depth: int = 3, device=None, extra: bool = False) -> Scene:
    """JAX's make_toy_scene (tests/test_backend_plugin.py:89-107); with
    `extra`, the toy_extra family's scene of the same values."""
    kw = dict(dtype=dtype, device=device)
    mat = make_material(rgb=(0.8, 0.25, 0.2), roughness=0.6, **kw)
    return Scene(
        params=ToyParams(
            center=v3(0.0, 0.0, 0.0, **kw),
            radius=torch.tensor(1.0, **kw),
            materials=stack_materials([mat]),
            sky_horizon=v3(1.0, 1.0, 1.0, **kw),
            sky_zenith=v3(0.6, 0.7, 0.9, **kw),
            sky_scale=torch.tensor(0.6, **kw),
        ),
        camera=default_pinhole(**kw),
        lights=spherical_light((3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0), **kw),
        background_fn=toy_background,
        closest_hit_fn=toy_extra_closest_hit if extra else toy_closest_hit,
        any_hit_fn=toy_any_hit,
        recursion_depth=recursion_depth,
    )


def make_toy_media_scene(dtype=torch.float32, recursion_depth: int = 6, device=None) -> Scene:
    """The toy with its sphere glass filled with a Scatter medium of
    anisotropy 0.4 (chip_smoke.py's MEDIA_MAIN), which takes the MEDIA
    instantiations."""
    scene = make_toy_scene(dtype, recursion_depth, device)
    m = scene.params.materials
    with torch.no_grad():
        m.spec_trans[0], m.metallic[0], m.roughness[0], m.ior[0] = 1.0, 0.0, 0.05, 1.5
        med = m.medium
        med.medium_type[0], med.density[0], med.anisotropy[0] = int(MediumType.SCATTER), 0.8, 0.4
        med.color.x[0], med.color.y[0], med.color.z[0] = 0.9, 0.2, 0.1
    return scene


def toy_pack(scene: Scene, width: int, height: int, with_medium: bool = False) -> torch.Tensor:
    """The toy's packed vector in JAX's toy_pack layout
    (tests/test_backend_plugin.py:109-117): [1, 23 + 15 L + 20 M]."""
    p = scene.params.unpack()
    own = torch.stack(cols(p.center, p.radius, p.sky_horizon, p.sky_zenith, p.sky_scale))
    flat = torch.cat([pack_camera(scene, width, height), own, pack_lights(scene),
                      pack_materials(p.materials, with_medium)])
    return flat[None, :]


def _at3(v: torch.Tensor, i: int) -> V3:
    return V3(v[i], v[i + 1], v[i + 2])


def toy_unpack(sv: torch.Tensor, scene: Scene) -> tuple[Scene, tuple]:
    """toy_pack's inverse: the scene with its packed leaves read from sv,
    and the camera basis."""
    v = sv.reshape(-1)
    p = scene.params.unpack()
    p = p._replace(center=_at3(v, 12), radius=v[15], sky_horizon=_at3(v, 16), sky_zenith=_at3(v, 19), sky_scale=v[22])
    p = p._replace(materials=unpack_materials(v, TOY_LIGHTS_AT + 15 * scene.num_lights, p.materials))
    return scene.replace(params=p, lights=unpack_lights(v, TOY_LIGHTS_AT, scene)), unpack_camera(v)


def toy_extra_pack(scene: Scene, width: int, height: int, with_medium: bool = False) -> torch.Tensor:
    """The toy_extra's vector: the camera, the sky, the lights, the
    material; the sphere goes beside it (toy_extras)."""
    p = scene.params.unpack()
    own = torch.stack(cols(p.sky_horizon, p.sky_zenith, p.sky_scale))
    flat = torch.cat([pack_camera(scene, width, height), own, pack_lights(scene),
                      pack_materials(p.materials, with_medium)])
    return flat[None, :]


def toy_extra_unpack(sv: torch.Tensor, scene: Scene) -> tuple[Scene, tuple]:
    v = sv.reshape(-1)
    p = scene.params.unpack()
    p = p._replace(sky_horizon=_at3(v, 12), sky_zenith=_at3(v, 15), sky_scale=v[18])
    p = p._replace(materials=unpack_materials(v, EXTRA_LIGHTS_AT + 15 * scene.num_lights, p.materials))
    return scene.replace(params=p, lights=unpack_lights(v, EXTRA_LIGHTS_AT, scene)), unpack_camera(v)


def toy_extras(scene: Scene) -> tuple:
    """The toy_extra's extra tensor: the center and the radius, float32 [4]
    on the scene's device."""
    p = scene.params.unpack()
    return (torch.stack(cols(p.center, p.radius)).contiguous(),)


def stripes(p, hit: SurfaceHit, ro: V3, rd: V3) -> Material:
    """JAX's `_stripes` hook (tests/test_procedural.py:16-27): the albedo
    0.05 where floor(4 x) of the hit point's x is odd, `%` flooring as
    Python's does (torch.remainder, not torch.fmod)."""
    fhp_x = ro.x + rd.x * torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    band = torch.remainder(torch.floor(fhp_x * 4.0), 2.0) < 1.0
    m = hit.material
    rgb = V3(*(torch.where(band, c, 0.05) for c in m.rgb))
    return m._replace(rgb=rgb)


def stripes_closest_hit(p, ro: V3, rd: V3) -> SurfaceHit:
    """The analytical closest hit with the stripes hook applied after it,
    as Scene.closest_hit applies a procedural_fn."""
    hit = analytical.closest_hit(p, ro, rd)
    return hit._replace(material=stripes(p, hit, ro, rd))


def make_stripes_scene(**kw) -> Scene:
    """The analytical scene (analytical.make_scene's arguments) whose closest
    hit is stripes_closest_hit: the eager twin of `toy::Stripes`."""
    return analytical.make_scene(**kw).replace(closest_hit_fn=stripes_closest_hit)


TOY = mk.KernelBackend(
    name="toy", matches=lambda scene: scene.closest_hit_fn is toy_closest_hit, pack=toy_pack, unpack=toy_unpack,
    header=str(HEADER), forward="toy::Toy", adjoint="toy::ToyAdj",
)
TOY_EXTRA = mk.KernelBackend(
    name="toy_extra", matches=lambda scene: scene.closest_hit_fn is toy_extra_closest_hit, pack=toy_extra_pack,
    unpack=toy_extra_unpack, header=str(HEADER), forward="toy::ToyExtra", extras=toy_extras,
)
STRIPES = mk.KernelBackend(
    name="stripes", matches=lambda scene: scene.closest_hit_fn is stripes_closest_hit, pack=mk.pack_scene,
    unpack=mk.unpack_scene, header=str(HEADER), forward="toy::Stripes",
)
PLUGINS = (TOY, TOY_EXTRA, STRIPES)


def register() -> None:
    """Register the three plugins, those not registered yet in this process
    (registering a name twice raises)."""
    for plugin in PLUGINS:
        if plugin.name not in mk.BACKENDS:
            mk.register_backend(plugin)


def sources() -> list:
    """The plugins' library sources (ops/_build.PluginSource), for a build
    beside the built-in kernels."""
    return [mk.plugin_source(p) for p in PLUGINS]


def toy_scene_from_arrays(arrays: dict, dtype=torch.float32, device=None, recursion_depth: int = 3) -> Scene:
    """The port's toy scene with every leaf taken from `arrays`, numpy arrays
    keyed by the JAX toy scene's dotted leaf paths (its ToyParams, camera
    and lights as `jax.tree_util.keystr` names them, e.g.
    `params.center.x`): how a JAX toy scene's values reach the port. Every
    leaf of the port's toy must be given; float leaves take `dtype`."""
    scene = make_toy_scene(dtype, recursion_depth, device)
    leaves = dict(named_leaves(scene))
    if set(leaves) != set(arrays):
        raise ValueError(f"the toy's leaves are {sorted(leaves)}, got {sorted(arrays)}")
    new = {name: torch.as_tensor(np.asarray(arrays[name]), device=leaf.device).to(leaf.dtype)
           for name, leaf in leaves.items()}
    return replace_leaves(scene, new)


register()
