"""The inverse-rendering step, plainly: two eager renders of the scene on
the keys split from the step's key (the first differentiated under the
detached-sampling estimator), the paired loss against the target, the
gradient of the trained leaves by autograd, and Adam.

The loss, the projections and the leaf selection follow
`pathtracer_tpu_torch/integrator/inverse.py` (`paired_image_loss`,
`clamp_material_params`, `sdf_projection`, `select_leaves`); Adam is
written out here with torch.optim.Adam's arithmetic at optax's defaults.
"""

from __future__ import annotations

import torch

from . import rng, tracer
from .scene import Scene
from .scenes import SECTIONS, named_leaves
from .vecmath import V3, clip, maximum

BETAS, EPS = (0.9, 0.999), 1e-8


def render(scene: Scene, key, width: int, height: int) -> torch.Tensor:
    """One spp-1 frame through the eager integrator under the
    detached-sampling estimator (its forward values are the plain ones)."""
    return tracer.render_frame(scene, key, width, height, spp=1, quirks=tracer.VERBATIM, detach=True)


def paired_image_loss(img_a, img_b, target):
    a = img_a[..., :3] - target[..., :3]
    b = (img_b[..., :3] - target[..., :3]).detach()
    return torch.mean(a * b)


def _replace(tree: tuple, path: str, new: dict) -> tuple:
    vals = []
    for name, val in zip(tree._fields, tree):
        p = f"{path}.{name}"
        vals.append(_replace(val, p, new) if isinstance(val, tuple) else new.get(p, val))
    return type(tree)(*vals)


def replace_leaves(scene: Scene, new: dict) -> Scene:
    """A new scene with the leaves named 'section.path' in `new` replaced."""
    return scene.replace(**{s: _replace(getattr(scene, s).unpack(), s, new) for s in SECTIONS})


def select(scene: Scene, patterns) -> list[str]:
    """The float leaves whose dotted name holds a pattern, in field order."""
    names = [n for n, t in named_leaves(scene).items() if any(q in n for q in patterns) and t.is_floating_point()]
    if not names:
        raise ValueError(f"no leaves match {patterns}")
    return names


def leaf_values(scene: Scene, names) -> list[torch.Tensor]:
    got = named_leaves(scene)
    return [got[n] for n in names]


def clamp_material_params(scene: Scene) -> Scene:
    """The analytical trainer's projection: materials and lights kept
    physically plausible (clip / maximum)."""
    m = scene.params.materials.unpack()
    lights = scene.lights.unpack()
    clip3 = lambda v, lo, hi: V3(clip(v.x, lo, hi), clip(v.y, lo, hi), clip(v.z, lo, hi))
    m = m._replace(
        rgb=clip3(m.rgb, 0.0, 1.0),
        roughness=clip(m.roughness, 0.001, 1.0),
        metallic=clip(m.metallic, 0.0, 1.0),
        clearcoat=clip(m.clearcoat, 0.0, 1.0),
        spec_trans=clip(m.spec_trans, 0.0, 1.0),
    )
    lights = lights._replace(
        emission=V3(*(maximum(c, 0.0) for c in lights.emission)),
        radius=maximum(lights.radius, 1e-3),
    )
    return scene.replace(params=scene.params.unpack()._replace(materials=m), lights=lights)


def sdf_projection(scene: Scene) -> Scene:
    """The SDF trainer's projection: sphere and torus major radii at least
    0.05, emission at least 0."""
    p = scene.params.unpack()
    lights = scene.lights.unpack()
    return scene.replace(
        params=p._replace(sphere_radius=maximum(p.sphere_radius, 0.05), torus_major=maximum(p.torus_major, 0.05)),
        lights=lights._replace(emission=V3(*(maximum(c, 0.0) for c in lights.emission))),
    )


PROJECTIONS = {"clamp_material_params": clamp_material_params, "sdf_projection": sdf_projection}


class Trainer:
    """The trained leaves of `start` named by `names`, Adam's state over
    them, and the step: `step(target, key)` returns the loss and keeps the
    gradient it took in `last_grads`."""

    def __init__(self, start: Scene, names, projection: str, lr: float, width: int, height: int):
        self.scene, self.names, self.lr = start, list(names), lr
        self.project = PROJECTIONS[projection]
        self.width, self.height = width, height
        self.values = [v.detach().clone() for v in leaf_values(start, self.names)]
        self.m = [torch.zeros_like(v) for v in self.values]
        self.v = [torch.zeros_like(v) for v in self.values]
        self.count = 0
        self.last_grads: list[torch.Tensor] = []

    def step(self, target: torch.Tensor, key) -> float:
        ka, kb = rng.split(key)
        train = [v.clone().requires_grad_(True) for v in self.values]
        s = self.project(replace_leaves(self.scene, dict(zip(self.names, train))))
        img_a = render(s, ka, self.width, self.height)
        with torch.no_grad():
            img_b = render(s, kb, self.width, self.height)
        loss = paired_image_loss(img_a, img_b, target)
        grads = torch.autograd.grad(loss, train, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g for g, v in zip(grads, self.values)]
        self.last_grads = grads
        self.count += 1
        b1, b2 = BETAS
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        with torch.no_grad():
            for i, g in enumerate(grads):
                self.m[i] = b1 * self.m[i] + (1.0 - b1) * g
                self.v[i] = b2 * self.v[i] + (1.0 - b2) * g * g
                denom = self.v[i].sqrt() / c2 ** 0.5 + EPS
                self.values[i] = self.values[i] - (self.lr / c1) * self.m[i] / denom
        return float(loss.detach())


def target_of(scene: Scene, keys, width: int, height: int) -> torch.Tensor:
    """The target: the mean of the renders of the true scene on `keys`."""
    with torch.no_grad():
        return sum(render(scene, k, width, height) for k in keys) / float(len(keys))
