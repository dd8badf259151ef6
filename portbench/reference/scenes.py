"""A scene from a configuration's scene description.

The description is the dict `pathtracer_tpu_torch/utils/sceneio.scene_to_dict`
writes (`docs/scene_example.json`): the family, the recursion depth and
every leaf of the params, lights and camera by its JAX keystr path. The
family's module of this package (`analytical.py`, `sdf.py`, a later
configuration's own) gives the default scene, whose leaves the
description overwrites, as `sceneio.scene_from_dict` does.
"""

from __future__ import annotations

import importlib

import torch

from .light import concat_lights, spherical_light
from .scene import Scene, TreeModule

SECTIONS = ("params", "lights", "camera")
ORDER = ("params", "camera", "lights")  # the JAX Scene's data fields, the order leaves are named and trained in


def family_module(family: str):
    """This package's module of the scene family `family`: it has a
    make_scene and a closest_hit."""
    if not family.isidentifier():
        raise ValueError(f"bad scene family name {family!r}")
    try:
        module = importlib.import_module(f".{family}", __package__)
    except ModuleNotFoundError as e:
        raise ValueError(f"the reference has no scene family {family!r} (portbench/reference/{family}.py)") from e
    if not (hasattr(module, "make_scene") and hasattr(module, "closest_hit")):
        raise ValueError(f"portbench/reference/{family}.py is no scene family (make_scene, closest_hit)")
    return module


def leaves(tree: TreeModule, prefix: str = "") -> dict:
    """Buffer name -> tensor, in field order."""
    out = {}
    for field in tree._tree_type._fields:
        child = getattr(tree, field)
        if isinstance(child, TreeModule):
            out.update(leaves(child, prefix=f"{prefix}{field}."))
        else:
            out[prefix + field] = child
    return out


def scene_from_dict(desc: dict, device=None, dtype=torch.float32) -> Scene:
    """The family's default scene with every leaf of `desc` written over it.
    An unknown path raises KeyError, a shape mismatch ValueError."""
    module = family_module(desc["family"])
    scene = module.make_scene(dtype=dtype, recursion_depth=int(desc["recursion_depth"]), device=device)
    n_lights = len(desc.get("lights", {}).get(".radius", [None] * scene.num_lights))
    if n_lights != scene.num_lights:
        scene = scene.replace(lights=concat_lights(*[
            spherical_light((0.0, 0.0, 0.0), 1.0, (0.0, 0.0, 0.0), dtype=dtype, device=device)
            for _ in range(n_lights)
        ]))
    for section in SECTIONS:
        tree = getattr(scene, section)
        known = leaves(tree)
        for path, val in desc.get(section, {}).items():
            name = path.removeprefix(".")
            if name not in known:
                raise KeyError(f"unknown {section} leaf path {path!r}")
            ref = known[name]
            arr = torch.as_tensor(val, dtype=ref.dtype, device=ref.device)
            if arr.shape != ref.shape:
                raise ValueError(f"{section} leaf {path}: shape {tuple(arr.shape)} != {tuple(ref.shape)}")
            owner, _, leaf = name.rpartition(".")
            setattr(tree.get_submodule(owner) if owner else tree, leaf, arr)
    return scene


def named_leaves(scene: Scene) -> dict:
    """Every leaf of the scene as 'section.path' -> tensor, in the JAX
    flatten order."""
    return {f"{section}.{name}": t for section in ORDER for name, t in leaves(getattr(scene, section)).items()}
