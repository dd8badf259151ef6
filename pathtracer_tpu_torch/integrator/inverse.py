"""Inverse rendering: pixel-loss gradients to scene parameters.

Port of `pathtracer_tpu/integrator/inverse.py`. Every scene quantity
(material table, lights, geometry, checker albedos, sky, camera) is a
scene leaf, and the render is differentiable end to end under the
detached-sampling estimator: through the eager integrator
(`kernel="eager"`), or through the megakernels (`kernel="megakernel"`: K1
forward and K2 backward with the scene's backend on a CUDA scene, the
eager integrator on a CPU scene). On the SDF scene the geometry's gradient
is the implicit-function derivative of the sphere-traced hit
(`models/sdf.sphere_trace`'s Newton reattachment); on the small mesh the
vertices' gradient flows through Möller-Trumbore's t and the face normal,
so `inverse_render` of a CUDA mesh scene is 2 K1-mesh launches and 1
K2-mesh launch a step. The big mesh has no K2 (the JAX package
differentiates it through its XLA twin): its CUDA gradient raises.

Parameter selection is by key-path substring: `select=("materials.rgb",
"lights.emission")` optimizes exactly those float leaves and freezes the
rest. Leaves are named and ordered as `jax.tree_util.tree_flatten_with_path`
names and orders them on the JAX scene (`params.materials.rgb.x`, ...), so
trainable lists, optimizer states and checkpoints line up with the JAX
package's.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from ..models.families import make_family_scene, require_family
from ..models.scene import Scene
from ..ops import rng
from ..ops.megakernel import render_frame_megakernel
from ..ops.vecmath import V3, clip, maximum
from ..utils.checkpoint import STRUCTURE_KEY, latest_checkpoint, load_checkpoint, save_checkpoint
from ..utils.sceneio import invert_state_from_jax
from .tracer import VERBATIM, Quirks, render_frame

_SECTIONS = ("params", "camera", "lights")  # the JAX Scene's data fields, in order
KERNELS = ("megakernel", "eager")
# recover_demo's trainable leaves by default, per scene family
DEMO_SELECTS = {
    "analytical": ("materials.rgb", "materials.roughness", "lights.emission"),
    "sdf": ("sphere_radius", "torus_major", "lights.emission"),
}


def keypath_str(path: Iterable[str]) -> str:
    """'params.materials.rgb.x'-style dotted name of a leaf path."""
    return ".".join(str(p) for p in path)


def _tree_leaves(tree: tuple, path: tuple):
    for name, val in zip(tree._fields, tree):
        if isinstance(val, tuple):
            yield from _tree_leaves(val, path + (name,))
        else:
            yield path + (name,), val


def _tree_replace(tree: tuple, path: tuple, new: dict) -> tuple:
    vals = []
    for name, val in zip(tree._fields, tree):
        p = path + (name,)
        vals.append(_tree_replace(val, p, new) if isinstance(val, tuple) else new.get(keypath_str(p), val))
    return type(tree)(*vals)


def named_leaves(scene: Scene) -> list[tuple[str, torch.Tensor]]:
    """Every leaf of the scene as (dotted name, tensor), in JAX flatten order."""
    out = []
    for section in _SECTIONS:
        tree = getattr(scene, section).unpack()
        out += [(keypath_str(p), leaf) for p, leaf in _tree_leaves(tree, (section,))]
    return out


def replace_leaves(scene: Scene, new: dict) -> Scene:
    """A new scene with the leaves named in `new` replaced."""
    return scene.replace(**{
        section: _tree_replace(getattr(scene, section).unpack(), (section,), new) for section in _SECTIONS
    })


def select_leaves(scene: Scene, select: Iterable[str]):
    """Split the scene into (trainable leaf list, rebuild fn, names): a leaf
    is trainable iff a pattern of `select` is a substring of its dotted name
    and it is a float tensor. The trainable leaves are fresh tensors that
    require grad; rebuild(values) is the scene with them swapped in."""
    patterns = tuple(select)
    names, train = [], []
    for name, leaf in named_leaves(scene):
        if any(p in name for p in patterns) and leaf.is_floating_point():
            names.append(name)
            train.append(leaf.detach().clone().requires_grad_(True))
    if not names:
        raise ValueError(f"no trainable leaves matched {patterns}")

    def rebuild(train_vals) -> Scene:
        return replace_leaves(scene, dict(zip(names, train_vals)))

    return train, rebuild, names


def image_loss(img, target):
    """Mean squared error on RGB (alpha is constant 1)."""
    return torch.mean((img[..., :3] - target[..., :3]) ** 2)


def paired_image_loss(img_a, img_b, target):
    """Unbiased surrogate for the MSE of the expected image:
    E[(I_a - t)(I_b - t)] = ||E[I] - t||^2 for two independent renders, so
    the variance term of the naive single-sample MSE drops out. The
    gradient flows through I_a only; render I_b under torch.no_grad()."""
    a = img_a[..., :3] - target[..., :3]
    b = (img_b[..., :3] - target[..., :3]).detach()
    return torch.mean(a * b)


def make_renderer(kernel: str, width: int, height: int, spp: int, quirks: Quirks) -> Callable:
    if kernel == "megakernel":
        return lambda s, k: render_frame_megakernel(s, k, width, height, spp, quirks)
    if kernel == "eager":
        return lambda s, k: render_frame(s, k, width, height, spp=spp, quirks=quirks, detach=True)
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


def render_loss(
    scene: Scene, target, key, width: int, height: int, spp: int = 4,
    quirks: Quirks = VERBATIM, kernel: str = "eager",
):
    """Differentiable render + MSE against a target image."""
    return image_loss(make_renderer(kernel, width, height, spp, quirks)(scene, key), target)


def make_adam(train, lr: float) -> torch.optim.Adam:
    """optax.adam's defaults."""
    return torch.optim.Adam(train, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def paired_step(train, rebuild, projection, opt, render, target, key) -> torch.Tensor:
    """One optimizer step on the paired loss: two renders of the same scene
    on the keys split from `key`, the first with grad, then backward and
    opt.step(). Returns the detached loss."""
    ka, kb = rng.split(key)
    opt.zero_grad(set_to_none=True)
    s = rebuild(train)
    if projection is not None:
        s = projection(s)
    img_a = render(s, ka)
    with torch.no_grad():
        img_b = render(s, kb)
    loss = paired_image_loss(img_a, img_b, target)
    loss.backward()
    opt.step()
    return loss.detach()


class OptResult(NamedTuple):
    scene: Scene
    losses: torch.Tensor  # [steps]


def inverse_render(
    scene: Scene,
    target,
    key,
    select: Iterable[str],
    width: int,
    height: int,
    steps: int = 100,
    lr: float = 2e-2,
    spp: int = 4,
    quirks: Quirks = VERBATIM,
    param_transform: Callable | None = None,
    crn: bool = True,
    unbiased: bool = True,
    kernel: str = "eager",
) -> OptResult:
    """Adam-optimize the selected scene leaves against a target image.

    unbiased=True descends the two-render paired loss (paired_step),
    unbiased=False the single-render MSE (render_loss); crn=True reuses one
    key every step (a deterministic surrogate), crn=False splits a fresh key
    per step. `param_transform` maps the rebuilt scene before rendering
    (e.g. clamp_material_params)."""
    train, rebuild, _ = select_leaves(scene, select)
    opt = make_adam(train, lr)
    render = make_renderer(kernel, width, height, spp, quirks)

    def rebuilt(vals):
        s = rebuild(vals)
        return s if param_transform is None else param_transform(s)

    losses = []
    for _ in range(steps):
        if crn:
            sub = key
        else:
            key, sub = rng.split(key)
        if unbiased:
            losses.append(paired_step(train, rebuild, param_transform, opt, render, target, sub))
        else:
            opt.zero_grad(set_to_none=True)
            loss = render_loss(rebuilt(train), target, sub, width, height, spp, quirks, kernel)
            loss.backward()
            opt.step()
            losses.append(loss.detach())

    with torch.no_grad():
        final = rebuilt([t.detach() for t in train])
    return OptResult(scene=final, losses=torch.stack(losses))


class RecoverRow(NamedTuple):
    """One parameter's recovery record in a RecoverReport."""

    name: str
    true_value: float
    start_value: float
    recovered: float
    rel_err: float


class RecoverReport(NamedTuple):
    rows: list  # [RecoverRow]
    losses: torch.Tensor  # [steps run]
    scene: Scene  # recovered scene


def adam_state(opt: torch.optim.Adam, train) -> tuple:
    """optax's ScaleByAdamState layout (count, mu list, nu list) of a torch
    Adam over `train`; zeros before the first step."""
    states = [opt.state.get(t, {}) for t in train]
    count = int(states[0]["step"]) if states[0] else 0
    mu = [st["exp_avg"] if st else torch.zeros_like(t) for st, t in zip(states, train)]
    nu = [st["exp_avg_sq"] if st else torch.zeros_like(t) for st, t in zip(states, train)]
    return count, mu, nu


def set_adam_state(opt: torch.optim.Adam, train, state: tuple) -> None:
    """Install an optax-layout (count, mu, nu) Adam state into `opt`."""
    count, mu, nu = state
    for t, m, v in zip(train, mu, nu):
        opt.state[t] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.detach().clone().to(t),
            "exp_avg_sq": v.detach().clone().to(t),
        }


def _invert_state(train, opt, step: int) -> tuple:
    """The checkpointed state, in the JAX package's leaf order:
    (train, (count, mu, nu), step)."""
    count, mu, nu = adam_state(opt, train)
    return ([t.detach() for t in train], (torch.tensor(count), mu, nu), torch.tensor(step))


def resume_state(path: str, train, opt) -> int:
    """Load a checkpoint written by recover_demo, the port's or the JAX
    package's, into `train` and `opt`; returns the step it was taken after."""
    with np.load(path) as data:
        own = STRUCTURE_KEY in data.files
    if own:
        vals, (count, mu, nu), step = load_checkpoint(path, _invert_state(train, opt, 0))
        count, step = int(count), int(step)
    else:
        vals, (count, mu, nu), step = invert_state_from_jax(path, train)
    with torch.no_grad():
        for t, v in zip(train, vals):
            t.copy_(v)
    set_adam_state(opt, train, (count, mu, nu))
    return step


# The mesh's vertex recovery that the tests and chip_smoke.py pass to
# inverse_render, as the JAX package's tests/test_mesh.py passes its scene
# (its recover_demo has no mesh demo): the leaves it trains, and its start
# (mesh_start_scene).
MESH_SELECT = ("params.vertices.y", "lights.emission")
MESH_APEX, MESH_APEX_Y, MESH_DIM = 16, 1.25, 0.45


def mesh_start_scene(true_scene: Scene) -> Scene:
    """The demo mesh with the pyramid's apex (vertex 16) raised from y 0.9
    to 1.25 and the light's emission dimmed to 0.45 of its value."""
    y = true_scene.params.vertices.y.clone()
    y[MESH_APEX] = MESH_APEX_Y
    emission = true_scene.lights.unpack().emission
    return replace_leaves(true_scene, {"params.vertices.y": y, **{
        f"lights.emission.{c}": getattr(emission, c) * MESH_DIM for c in "xyz"}})


def demo_scenes(recursion_depth: int = 4, device=None, scene: str = "analytical") -> tuple[Scene, Scene]:
    """(true, start) scenes of recover_demo for the `scene` family: the
    demo scene, and the start with the light dimmed and, on the analytical
    scene, the albedo shifted and the roughness flattened; on the SDF
    scene, the sphere shrunk and the torus's major radius grown."""
    true_scene = make_family_scene(scene, recursion_depth=recursion_depth, device=device)
    with torch.no_grad():
        lights = true_scene.lights.unpack()
        dimmed = {f"lights.emission.{c}": getattr(lights.emission, c) * 0.45 for c in "xyz"}
        p = true_scene.params.unpack()
        if scene == "sdf":
            start = {"params.sphere_radius": p.sphere_radius * 0.75, "params.torus_major": p.torus_major * 1.25}
        else:
            m = p.materials
            start = {
                **{f"params.materials.rgb.{c}": getattr(m.rgb, c) * 0.55 + 0.25 for c in "xyz"},
                "params.materials.roughness": clip(m.roughness * 0.3 + 0.35, 0.001, 1.0),
            }
        start_scene = replace_leaves(true_scene, {**start, **dimmed})
    return true_scene, start_scene


def recover_demo(
    key=None,
    width: int = 256,
    height: int = 192,
    steps: int = 80,
    spp: int = 1,
    lr: float = 3e-2,
    select: Iterable[str] | None = None,
    scene: str = "analytical",
    kernel: str = "megakernel",
    mesh=None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    recursion_depth: int = 4,
    device="cuda",
    verbose: bool = True,
) -> RecoverReport:
    """Recover scene parameters from a target render of a demo scene:
    scene="analytical" the material albedo, roughness and light emission;
    scene="sdf" the GEOMETRY (sphere radius, torus major radius) through the
    implicit-function hit-distance gradient, and the light emission.
    `select=None` picks the family's default (DEMO_SELECTS).

    Render the target with the true parameters (the mean of 4 frames),
    perturb the selected leaves (demo_scenes), then Adam-descend the paired
    loss (`paired_image_loss`) through the chosen render path, projected
    each step by the family's PROJECTIONS: per step two renders of the same
    scene on keys split from fold_in(fold_in(key, 29), step), the first
    with grad. With kernel="megakernel" on a CUDA device a step is 2
    launches of K1 and 1 of K2, each with the scene's backend. The state is
    checkpointed every `ckpt_every` steps to `ckpt_dir` and the demo
    resumes from the newest checkpoint there, the port's or one a JAX
    `recover_demo` of the same family wrote.

    mesh= (a `parallel/mesh.Mesh` over the initialised process group, every
    rank calling this with the same arguments) shards each render: the
    target through the sharded render (render_frame_sharded_megakernel, or
    render_frame_sharded for kernel="eager"), each step through
    `parallel/mesh.paired_step_sharded` (each rank's pixels, on the card K1
    and K2 over its range, the gradients and the loss summed over the
    mesh). Rank 0 alone prints and writes checkpoints.

    The mesh scene families have no demo here (ROADMAP item 12): the JAX package's
    recover_demo trains the analytical demo under their names, which the
    port does not copy; `inverse_render` takes a mesh scene."""
    require_family(scene)
    if scene not in DEMO_SELECTS:
        raise NotImplementedError(f"recover_demo has no demo of the {scene} scene (ROADMAP item 12); "
                                  "inverse_render takes a mesh scene")
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    if mesh is not None:
        from ..parallel import mesh as sharding

        if not isinstance(mesh, sharding.Mesh):
            raise TypeError(f"mesh= takes a parallel.mesh.Mesh, got {type(mesh).__name__}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available")
    if key is None:
        key = rng.prng_key(0)
    if select is None:
        select = DEMO_SELECTS[scene]
    projection = PROJECTIONS[scene]

    true_scene, start_scene = demo_scenes(recursion_depth, device, scene)
    lead = mesh is None or mesh.rank == 0
    verbose = verbose and lead
    if mesh is None:
        render = make_renderer(kernel, width, height, spp, VERBATIM)
    else:
        if kernel == "megakernel":
            render = lambda s, k: sharding.render_frame_sharded_megakernel(s, k, mesh, width, height, spp)
        else:
            render = lambda s, k: sharding.render_frame_sharded(s, k, mesh, width, height, spp, detach=True)
    with torch.no_grad():
        tkeys = rng.split(rng.fold_in(key, 17), 4)
        target = sum(render(true_scene, k) for k in tkeys) / 4.0

    train, rebuild, names = select_leaves(start_scene, select)
    true_train, _, _ = select_leaves(true_scene, select)
    start_train = [t.detach().clone() for t in train]
    opt = make_adam(train, lr)

    start_step = 0
    if ckpt_dir is not None:
        path = latest_checkpoint(ckpt_dir, prefix="invert_")
        if path is not None:
            start_step = resume_state(path, train, opt)
            if verbose:
                print(f"resumed from {path} at step {start_step}")

    kbase = rng.fold_in(key, 29)
    losses = []
    for i in range(start_step, steps):
        if mesh is None:
            losses.append(paired_step(train, rebuild, projection, opt, render, target, rng.fold_in(kbase, i)))
        else:
            losses.append(sharding.paired_step_sharded(train, rebuild, projection, opt, mesh, kernel, width, height,
                                                       spp, VERBATIM, target, rng.fold_in(kbase, i)))
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {float(losses[-1]):.6e}")
        if lead and ckpt_dir is not None and ((i + 1) % ckpt_every == 0 or i == steps - 1):
            os.makedirs(ckpt_dir, exist_ok=True)
            save_checkpoint(os.path.join(ckpt_dir, f"invert_{i + 1:06d}.npz"), _invert_state(train, opt, i + 1))

    with torch.no_grad():
        final_scene = projection(rebuild([t.detach() for t in train]))
    final_train, _, _ = select_leaves(final_scene, select)

    rows = []
    for name, tv, sv, rv in zip(names, true_train, start_train, final_train):
        tv, sv, rv = (x.detach().cpu().double().reshape(-1) for x in (tv, sv, rv))
        for j in range(tv.numel()):
            t, s0, r = float(tv[j]), float(sv[j]), float(rv[j])
            rows.append(RecoverRow(f"{name}[{j}]", t, s0, r, abs(r - t) / max(abs(t), 1e-3)))

    if verbose:
        print(f"{'parameter':28s} {'true':>8s} {'start':>8s} {'recovered':>10s} {'rel err':>8s}")
        for r in rows:
            print(f"{r.name:28s} {r.true_value:8.4f} {r.start_value:8.4f} {r.recovered:10.4f} {r.rel_err:8.3f}")
        med = sorted(r.rel_err for r in rows)[len(rows) // 2]
        print(f"median rel err: {med:.3f}")

    return RecoverReport(
        rows=rows,
        losses=torch.stack(losses).cpu() if losses else torch.zeros(0),
        scene=final_scene,
    )


def clamp_material_params(scene: Scene) -> Scene:
    """Projection keeping optimized materials and lights physically
    plausible (jnp.clip / jnp.maximum, with their tie gradients)."""
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
    """The SDF demo's projection: sphere and torus major radii at least
    0.05, emission at least 0 (jnp.maximum, with its tie gradients)."""
    p = scene.params.unpack()
    lights = scene.lights.unpack()
    return scene.replace(
        params=p._replace(sphere_radius=maximum(p.sphere_radius, 0.05), torus_major=maximum(p.torus_major, 0.05)),
        lights=lights._replace(emission=V3(*(maximum(c, 0.0) for c in lights.emission))),
    )


# recover_demo's projection per scene family
PROJECTIONS = {"analytical": clamp_material_params, "sdf": sdf_projection}
