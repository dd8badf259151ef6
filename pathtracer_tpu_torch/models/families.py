"""The scene families of the port by name: the names of the render CLI's
`--scene` and of the JAX package's scene dicts (`utils/sceneio`). Every
caller that picks a family by name, or asks which family a scene is, goes
through here.

Beside the built-in families, code outside the package registers
scene-backend plugins (`ops/megakernel.register_backend`, which calls
`register_plugin`): `family_of` names a plugin whose `matches(scene)`
claims a scene that no built-in family does, as the JAX package's
`_resolve_backend` dispatches. The CLIs and scene files take the built-in
families only, as the JAX package's do.
"""

from __future__ import annotations

from typing import Callable

from . import analytical, bigmesh, mesh, sdf
from .scene import Scene

# name -> the family's module (its make_scene and closest_hit); every
# family of the JAX package
FAMILIES = {"analytical": analytical, "sdf": sdf, "mesh": mesh, "bigmesh": bigmesh}
# name -> a registered plugin's matches(scene), in registration order
PLUGINS: dict[str, Callable[[Scene], bool]] = {}


def register_plugin(name: str, matches: Callable[[Scene], bool]) -> None:
    """Claim `name` for a plugin whose `matches(scene)` says which scenes
    are its; a name that a built-in family or another plugin holds raises
    ValueError."""
    if name in FAMILIES or name in PLUGINS:
        raise ValueError(f"the scene family {name!r} is taken ({'built in' if name in FAMILIES else 'registered'})")
    PLUGINS[name] = matches


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
    """The family of a scene: a built-in family by its closest-hit
    function, else the first plugin, in registration order, whose matches
    claims it; so no plugin takes a built-in family's scene."""
    for name, module in FAMILIES.items():
        if scene.closest_hit_fn is module.closest_hit:
            return name
    for name, matches in PLUGINS.items():
        if matches(scene):
            return name
    raise NotImplementedError(f"the port covers the {', '.join(FAMILIES)} scenes and the registered plugins' "
                              f"({', '.join(PLUGINS) or 'none'}); register a plugin with "
                              "ops.megakernel.register_backend")
