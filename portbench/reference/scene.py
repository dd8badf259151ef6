# Frozen copy of pathtracer_tpu_torch/models/scene.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""Scene: parameter trees held as module buffers, plus pure scene functions.

Port of `pathtracer_tpu/models/scene.py`. The JAX `Scene` is a pytree of
leaves and static functions; here it is an `nn.Module` whose `params`,
`camera` and `lights` children hold every leaf as a buffer. Buffer names
follow the NamedTuple field paths, so `scene.named_buffers()` yields
`params.materials.rgb.x`, the JAX `keystr` path `.materials.rgb.x` of the
`params` section. `.to(device)` moves the whole scene; `unpack()` turns a
child back into its NamedTuple for the pure functions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from .vecmath import V3
from .material import Material


class SurfaceHit(NamedTuple):
    """closest_hit over a ray batch: t is +inf on a miss, where the
    material holds the Material::new defaults."""

    t: torch.Tensor
    normal: V3
    material: Material


class TreeModule(nn.Module):
    """A NamedTuple tree of tensors held as buffers named by field."""

    def __init__(self, tree: tuple):
        super().__init__()
        self._tree_type = type(tree)
        for name, val in zip(tree._fields, tree):
            if isinstance(val, tuple):
                self.add_module(name, TreeModule(val))
            else:
                self.register_buffer(name, val)

    def unpack(self) -> tuple:
        vals = []
        for name in self._tree_type._fields:
            child = getattr(self, name)
            vals.append(child.unpack() if isinstance(child, TreeModule) else child)
        return self._tree_type(*vals)


class Scene(nn.Module):
    """Scene data plus its pure functions:

    - background_fn(params, rd) -> V3
    - closest_hit_fn(params, ro, rd) -> SurfaceHit
    - any_hit_fn(params, ro, rd, max_dist) -> bool tensor
    - procedural_fn(params, hit, ro, rd) -> Material, optional
    """

    def __init__(
        self,
        params: tuple,
        camera: tuple,
        lights: tuple,
        background_fn: Callable,
        closest_hit_fn: Callable,
        any_hit_fn: Callable,
        recursion_depth: int = 4,
        procedural_fn: Callable | None = None,
    ):
        super().__init__()
        self.params = TreeModule(params)
        self.camera = TreeModule(camera)
        self.lights = TreeModule(lights)
        self.background_fn = background_fn
        self.closest_hit_fn = closest_hit_fn
        self.any_hit_fn = any_hit_fn
        self.recursion_depth = recursion_depth
        self.procedural_fn = procedural_fn

    @property
    def dtype(self) -> torch.dtype:
        return self.lights.radius.dtype

    @property
    def device(self) -> torch.device:
        return self.lights.radius.device

    @property
    def num_lights(self) -> int:
        return int(self.lights.radius.shape[0])

    def background(self, rd: V3) -> V3:
        return self.background_fn(self.params.unpack(), rd)

    def closest_hit(self, ro: V3, rd: V3) -> SurfaceHit:
        p = self.params.unpack()
        hit = self.closest_hit_fn(p, ro, rd)
        if self.procedural_fn is not None:
            hit = hit._replace(material=self.procedural_fn(p, hit, ro, rd))
        return hit

    def any_hit(self, ro: V3, rd: V3, max_dist) -> torch.Tensor:
        return self.any_hit_fn(self.params.unpack(), ro, rd, max_dist)

    def replace(self, **kw) -> "Scene":
        """A new Scene with some of params/camera/lights/functions swapped."""
        args = dict(
            params=self.params.unpack(),
            camera=self.camera.unpack(),
            lights=self.lights.unpack(),
            background_fn=self.background_fn,
            closest_hit_fn=self.closest_hit_fn,
            any_hit_fn=self.any_hit_fn,
            recursion_depth=self.recursion_depth,
            procedural_fn=self.procedural_fn,
        )
        args.update(kw)
        return Scene(**args)
