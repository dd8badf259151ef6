"""Scene descriptions: build a port scene from the JAX package's scene dict.

`pathtracer_tpu/utils/sceneio.scene_to_dict(scene, "analytical")` emits

    {"family": "analytical", "recursion_depth": 4,
     "params": {".sphere_radius": [1.0, 1.0], ...},
     "lights": {".emission.x": [3.0], ...},
     "camera": {".origin.z": 3.0, ...}}

whose keys are `jax.tree_util.keystr` paths into the scene's pytrees. The
port's scene buffers are named by the same paths (`params.sphere_radius`),
so `scene_from_dict` writes each value over the family default. This is
how parameters cross from a JAX scene to a port scene.
"""

from __future__ import annotations

import torch

from ..models.analytical import make_scene
from ..models.light import concat_lights, spherical_light
from ..models.scene import Scene


def scene_from_dict(desc: dict, device=None, dtype=torch.float32,
                    recursion_depth: int | None = None) -> Scene:
    """The family's default scene with the description's leaves written
    over it (a default light table has the dict's light count). Unknown
    paths and shape mismatches raise."""
    family = desc.get("family", "analytical")
    if family != "analytical":
        raise NotImplementedError(f"scene family {family!r} is not ported yet")
    depth = recursion_depth if recursion_depth is not None else int(desc.get("recursion_depth", 4))
    # The light count is the length of the dict's light leaves; the table
    # starts as that many placeholder lights that the leaves overwrite.
    n_lights = len(desc.get("lights", {}).get(".radius", [None]))
    lights = concat_lights(*[
        spherical_light((0.0, 0.0, 0.0), 1.0, (0.0, 0.0, 0.0), dtype=dtype, device=device)
        for _ in range(n_lights)
    ])
    scene = make_scene(dtype=dtype, recursion_depth=depth, device=device, lights=lights)
    for section in ("params", "lights", "camera"):
        tree = getattr(scene, section)
        known = dict(tree.named_buffers(remove_duplicate=False))
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
