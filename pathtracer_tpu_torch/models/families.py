"""The scene families of the port by name: the names of the render CLI's
`--scene` and of the JAX package's scene dicts (`utils/sceneio`). Every
caller that picks a family by name, or asks which family a scene is, goes
through here.
"""

from __future__ import annotations

from . import analytical, bigmesh, mesh, sdf
from .scene import Scene

# name -> the family's module (its make_scene and closest_hit); every
# family of the JAX package
FAMILIES = {"analytical": analytical, "sdf": sdf, "mesh": mesh, "bigmesh": bigmesh}


def require_family(family: str) -> None:
    """An unknown family raises ValueError."""
    if family not in FAMILIES:
        raise ValueError(f"unknown scene family {family!r} (choose {'|'.join(FAMILIES)})")


def make_family_scene(family: str, **kw) -> Scene:
    """The demo scene of `family` (require_family's errors otherwise); `kw`
    go to its make_scene."""
    require_family(family)
    return FAMILIES[family].make_scene(**kw)


def family_of(scene: Scene) -> str:
    """The family of a scene, by its closest-hit function."""
    for name, module in FAMILIES.items():
        if scene.closest_hit_fn is module.closest_hit:
            return name
    raise NotImplementedError(f"the port covers the {', '.join(FAMILIES)} scenes")
