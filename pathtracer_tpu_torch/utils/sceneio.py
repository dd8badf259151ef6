"""Scene descriptions: JSON files of a scene's leaves, shared with the JAX
package.

Port of `pathtracer_tpu/utils/sceneio.py`. `scene_to_dict(scene, family)`
(the JAX package's and the port's give equal dicts for equal scenes) emits

    {"family": "analytical", "recursion_depth": 4,
     "params": {".sphere_radius": [1.0, 1.0], ...},
     "lights": {".emission.x": [3.0], ...},
     "camera": {".origin.z": 3.0, ...}}

whose keys are `jax.tree_util.keystr` paths into the scene's pytrees. The
port's scene buffers are named by the same paths (`params.sphere_radius`),
so `scene_from_dict` writes each value over the family default. This is
how parameters cross between a JAX scene and a port scene, for every family
("analytical", "sdf", "mesh", "bigmesh"): a file that `save_scene` of
either package writes, `load_scene` of the other reads. The mesh families'
topology is static structure (`STATIC` of their modules), the family
default's, and no entry of a file.

An optimizer's state crosses too: `invert_state_from_jax` reads the
checkpoint a JAX `recover_demo` writes for either family
(`invert_XXXXXX.npz`: the trainable leaves, optax Adam's count, mu and nu,
then the step), so a run started in JAX resumes in the port.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..models.families import FAMILIES, make_family_scene, require_family
from ..models.light import concat_lights, spherical_light
from ..models.scene import Scene, TreeModule

SECTIONS = ("params", "lights", "camera")


def _leaves(tree: TreeModule, static=(), prefix: str = "") -> dict:
    """Buffer name -> tensor in field order (the JAX flatten order), the
    top-level fields named in `static` left out."""
    out = {}
    for field in tree._tree_type._fields:
        if field in static:
            continue
        child = getattr(tree, field)
        if isinstance(child, TreeModule):
            out.update(_leaves(child, prefix=f"{prefix}{field}."))
        else:
            out[prefix + field] = child
    return out


def _static(family: str, section: str) -> tuple:
    return getattr(FAMILIES[family], "STATIC", ()) if section == "params" else ()


def scene_to_dict(scene: Scene, family: str) -> dict:
    """A scene's leaves (params, lights, camera) by JAX keystr path, as
    Python numbers and lists of the values each tensor holds."""
    require_family(family)
    out = {"family": family, "recursion_depth": int(scene.recursion_depth)}
    for section in SECTIONS:
        out[section] = {"." + name: t.detach().cpu().tolist()
                        for name, t in _leaves(getattr(scene, section), _static(family, section)).items()}
    return out


def save_scene(scene: Scene, path: str, family: str) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene, family), f, indent=1)


def load_scene(path: str, dtype=torch.float32, recursion_depth: int | None = None, device=None) -> Scene:
    """The scene a file describes (scene_from_dict), on `device`;
    `recursion_depth`, where given, overrides the file's."""
    with open(path) as f:
        return scene_from_dict(json.load(f), device=device, dtype=dtype, recursion_depth=recursion_depth)


def scene_from_dict(desc: dict, device=None, dtype=torch.float32,
                    recursion_depth: int | None = None) -> Scene:
    """The family's default scene with the description's leaves written
    over it (a light table of another count than the default's starts as
    placeholder lights). Unknown
    families (ValueError), paths (KeyError; the mesh families' static
    topology among them) and shape mismatches (ValueError) raise. The mesh
    families' topology is the family default's, as in the JAX package."""
    depth = recursion_depth if recursion_depth is not None else int(desc.get("recursion_depth", 4))
    family = desc.get("family", "analytical")
    scene = make_family_scene(family, dtype=dtype, recursion_depth=depth, device=device)
    n_lights = len(desc.get("lights", {}).get(".radius", [None] * scene.num_lights))
    if n_lights != scene.num_lights:
        # another light count: that many placeholder lights, which the
        # dict's leaves overwrite
        scene = scene.replace(lights=concat_lights(*[
            spherical_light((0.0, 0.0, 0.0), 1.0, (0.0, 0.0, 0.0), dtype=dtype, device=device)
            for _ in range(n_lights)
        ]))
    for section in SECTIONS:
        tree = getattr(scene, section)
        known = _leaves(tree, _static(family, section))
        for path, val in desc.get(section, {}).items():
            name = path.removeprefix(".")
            if name not in known:
                raise KeyError(f"unknown {section} leaf path {path!r}; known: {sorted(known)}")
            ref = known[name]
            arr = torch.as_tensor(val, dtype=ref.dtype, device=ref.device)
            if arr.shape != ref.shape:
                raise ValueError(f"{section} leaf {path}: shape {tuple(arr.shape)} != {tuple(ref.shape)}")
            owner, _, leaf = name.rpartition(".")
            setattr(tree.get_submodule(owner) if owner else tree, leaf, arr)
    return scene


def invert_state_from_jax(path: str, like: list[torch.Tensor]):
    """Read a JAX inverse-rendering checkpoint, the pytree
    `(train, (ScaleByAdamState(count, mu, nu), EmptyState()), step)` flattened
    into leaf_0 .. leaf_{3k+1} for k trainable leaves. `like` are the port's
    trainable tensors in the same (JAX flatten) order; shapes must match.
    Returns (trainable tensors, Adam state, step) with the Adam state as
    (count, mu list, nu list), what `torch.optim.Adam` keeps per parameter
    as step, exp_avg and exp_avg_sq."""
    k = len(like)
    with np.load(path) as data:
        n_saved = sum(1 for f in data.files if f.startswith("leaf_"))
        if n_saved != 3 * k + 2:
            raise ValueError(f"{path}: {n_saved} leaves, a JAX Adam state of {k} leaves has {3 * k + 2}")
        treedef = bytes(data["__treedef__"]).decode() if "__treedef__" in data.files else ""
        if "ScaleByAdamState" not in treedef:
            raise ValueError(f"{path} is not a JAX optax-Adam checkpoint")
        leaves = [data[f"leaf_{i}"] for i in range(n_saved)]
    as_like = lambda arr, t: torch.as_tensor(arr, dtype=t.dtype, device=t.device)
    for i, t in enumerate(like):
        for j in (i, k + 1 + i, 2 * k + 1 + i):
            if leaves[j].shape != tuple(t.shape):
                raise ValueError(f"{path}: leaf {j} shape {leaves[j].shape} != {tuple(t.shape)}")
    train = [as_like(leaves[i], t) for i, t in enumerate(like)]
    mu = [as_like(leaves[k + 1 + i], t) for i, t in enumerate(like)]
    nu = [as_like(leaves[2 * k + 1 + i], t) for i, t in enumerate(like)]
    return train, (int(leaves[k]), mu, nu), int(leaves[3 * k + 1])
