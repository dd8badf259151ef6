"""The plain version of K2's media branch held to the JAX package's
gradients with respect to every float leaf of the scene.

The scenes are tests/test_medium.py's glass demo (sphere 1 glass: spec_trans
1, metallic 0, roughness 0.05, ior 1.5) filled with Absorb, Emissive or
Scatter g 0.4 (density 0.8, color (0.9, 0.2, 0.1); Emissive as
test_torch_media.py's), and the lit-medium case: the Scatter demo with the
light moved inside sphere 1 (center (1.1, 0, 0), radius 0.25) and shadow
rays that stop at the light (`any_hit_respecting_max_dist`), so that a
scatter point sees the light and the HG-phase NEE contributes (in the
closed glass demo every shadow ray from a scatter point meets the sphere's
own wall).

The JAX side is committed under tests/golden_torch/:
  grad_media_64x48_d6_k3.npz  jax.grad of mean(rgb^2) of the float32
      render_frame(detach=True, remat=True), 64x48, depth 6, PRNGKey(3),
      with respect to every float leaf (geometry, lights, camera, the
      materials with their media), keyed "<case>/<leaf>" for each case of
      CASES, and the same loss's gradient from each of ROW_BLOCKS bands of
      rows alone ("<case>/rows<k>/<leaf>", the vjp of the band's part of
      the cotangent); chip_smoke.py holds K2's MEDIA instantiation to it on
      the card;
  grad_media_pallas_16x8_d6_k5.npz  the lit-medium case at 16x8, depth 6,
      PRNGKey(5): jax.grad through the TPU kernel itself,
      render_frame_pallas(media=True, uniforms="hbm", interpret=True,
      tile_rows=8) ("pallas/<leaf>", its backward is _pallas_backward with
      has_media), and through the XLA integrator ("xla/<leaf>").
Regenerate them with `JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_media_grad.py`; the checks that JAX still computes them
are marked `slow`.

Tolerances: tests/test_torch_grad.py's (rtol 1e-2 / atol 1e-7 for the
geometry, the light's position and radius, and the camera, rtol 5e-3 /
atol 1e-8 for the rest), for each band's gradient and for the whole one;
the whole one's rtol is taken of the sum of the bands' magnitudes where
that is larger than its own. A float32 sum rounds in proportion to the
magnitudes of its terms: in the lit case the light position's x gradient,
-6.4e-5, sums bands of up to 5.1e-3 of either sign, one of them 1.8e-6
(3.7e-4 of it) off JAX's, the rounding of the light's silhouette pixels
seen through the glass.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.inverse import named_leaves
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.models.material import MediumType
from pathtracer_tpu_torch.ops import rng
from test_torch_kernel_host import one_torch_thread  # noqa: F401
from test_torch_media_kernel_host import DEMO, LIT_LIGHT, lit_scene, make_glass

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_torch")
FIXTURE = os.path.join(GOLDEN, "grad_media_64x48_d6_k3.npz")
PALLAS_FIXTURE = os.path.join(GOLDEN, "grad_media_pallas_16x8_d6_k5.npz")
W, H, DEPTH = 64, 48, 6
PALLAS_W, PALLAS_H, PALLAS_KEY = 16, 8, 5
# case -> (medium type, medium kwargs, light inside the medium)
CASES = {
    "absorb": (MediumType.ABSORB, DEMO, False),
    "emissive": (MediumType.EMISSIVE, dict(density=0.5, color=(0.2, 0.8, 0.3)), False),
    "scatter": (MediumType.SCATTER, dict(anisotropy=0.4, **DEMO), False),
    "lit": (MediumType.SCATTER, dict(anisotropy=0.4, **DEMO), True),
}
GEOMETRY = ("params.sphere", "params.plane", "lights.position", "lights.radius", "camera")
ROW_BLOCKS = 4
MATERIAL_LIGHT = dict(rtol=5e-3, atol=1e-8)
GEOMETRY_CAMERA = dict(rtol=1e-2, atol=1e-7)


def tolerance(name: str) -> dict:
    return GEOMETRY_CAMERA if name.startswith(GEOMETRY) else MATERIAL_LIGHT


def media_case(name: str, dtype=torch.float32, depth: int = DEPTH, device=None):
    """The port's scene of case `name`."""
    med_type, medium, lit = CASES[name]
    if lit:
        return lit_scene(med_type, dtype, depth, device, **medium)
    return make_glass(make_scene(dtype=dtype, recursion_depth=depth, device=device), 1, med_type, **medium)


def jax_media_case(name: str, dtype=jnp.float32, depth: int = DEPTH):
    """The JAX package's scene of case `name`."""
    from pathtracer_tpu.models.light import spherical_light as jax_spherical_light

    med_type, medium, lit = CASES[name]
    lights = jax_spherical_light(LIT_LIGHT["position"], LIT_LIGHT["radius"], LIT_LIGHT["emission"], dtype=dtype) \
        if lit else None
    scene = pt.make_analytical_scene(dtype=dtype, recursion_depth=depth, respect_max_dist=lit, lights=lights)
    m = scene.params.materials
    m = m._replace(spec_trans=m.spec_trans.at[1].set(1.0), metallic=m.metallic.at[1].set(0.0),
                   roughness=m.roughness.at[1].set(0.05), ior=m.ior.at[1].set(1.5))
    med, (cx, cy, cz) = m.medium, medium["color"]
    med = med._replace(
        medium_type=med.medium_type.at[1].set(med_type), density=med.density.at[1].set(medium["density"]),
        color=med.color._replace(x=med.color.x.at[1].set(cx), y=med.color.y.at[1].set(cy),
                                 z=med.color.z.at[1].set(cz)),
        anisotropy=med.anisotropy.at[1].set(medium.get("anisotropy", 0.0)),
    )
    return scene.replace(params=scene.params._replace(materials=m._replace(medium=med)))


@functools.lru_cache(maxsize=None)
def fixture(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def case_grads(path: str, prefix: str) -> dict:
    """The fixture's entries under `prefix/`, those of the row bands aside."""
    return {k[len(prefix) + 1:]: v for k, v in fixture(path).items()
            if k.startswith(prefix + "/") and "/" not in k[len(prefix) + 1:]}


def band_masks(h: int, w: int) -> list:
    """[h, w, 4] float32 masks of the ROW_BLOCKS bands of rows (rgb only)."""
    rows = h // ROW_BLOCKS
    masks = []
    for k in range(ROW_BLOCKS):
        m = np.zeros((h, w, 4), np.float32)
        m[k * rows:h if k == ROW_BLOCKS - 1 else (k + 1) * rows, :, :3] = 1.0
        masks.append(m)
    return masks


def port_grads(scene, key, w, h, names, bands: bool = False):
    """Autograd of mean(rgb^2) of the eager detached estimator (K2's plain
    version) with respect to the leaves `names`; zeros where unused. With
    `bands`, also each band's part: (whole, [band 0, ...])."""
    leaves = dict(named_leaves(scene))
    for n in names:
        leaves[n].requires_grad_(True)
    img = T.render_frame(scene, key, w, h, detach=True)
    inputs = [leaves[n] for n in names]

    def grads(loss):
        gs = torch.autograd.grad(loss, inputs, allow_unused=True, retain_graph=True)
        return {n: np.zeros(tuple(leaves[n].shape)) if g is None else g.numpy() for n, g in zip(names, gs)}

    whole = grads((img[..., :3] ** 2).mean())
    if not bands:
        return whole
    ct = img.detach() * (2.0 / (h * w * 3))
    return whole, [grads((img * (torch.from_numpy(m) * ct)).sum()) for m in band_masks(h, w)]


def leaf_close(got, want, name, scale=None) -> bool:
    """Within tolerance(name) of `want`, its rtol taken of `scale` where
    that is larger than |want|."""
    tol = tolerance(name)
    want = np.asarray(want, np.float64)
    scale = np.abs(want) if scale is None else np.maximum(np.abs(want), scale)
    return bool(np.all(np.abs(np.asarray(got, np.float64) - want) <= tol["atol"] + tol["rtol"] * scale))


def band_scale(path: str, case: str, name: str):
    """The sum of the magnitudes of the bands' gradients of leaf `name`."""
    return sum(np.abs(fixture(path)[f"{case}/rows{k}/{name}"]) for k in range(ROW_BLOCKS))


def assert_leaves_close(got: dict, want: dict, label: str, scales: dict | None = None) -> None:
    bad = [(n, got[n], want[n]) for n in sorted(want)
           if not leaf_close(got[n], want[n], n, None if scales is None else scales[n])]
    assert not bad, f"{label}: {bad}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_eager_grad_of_every_leaf_matches_jax(name):
    """Every float leaf, the geometry, lights and camera a medium changes
    among them, at 64x48, depth 6."""
    want = case_grads(FIXTURE, name)
    scene = media_case(name)
    floats = sorted(n for n, leaf in named_leaves(scene) if leaf.is_floating_point())
    assert sorted(want) == floats
    whole, bands = port_grads(scene, rng.prng_key(3), W, H, floats, bands=True)
    for k, got in enumerate(bands):
        assert_leaves_close(got, case_grads(FIXTURE, f"{name}/rows{k}"), f"{name} rows band {k}")
    assert_leaves_close(whole, want, name, {n: band_scale(FIXTURE, name, n) for n in floats})


def test_fixture_exercises_the_media_adjoint():
    """What the fixture holds: the Scatter density's gradient is exactly 0
    (the free flight is detached), the medium-free materials' media entries
    are 0, and the lit case's anisotropy and light emission carry gradient
    (its scatter points see the light)."""
    medium = ["params.materials.medium.density", "params.materials.medium.anisotropy"] + [
        f"params.materials.medium.color.{c}" for c in "xyz"]
    for name in CASES:
        g = case_grads(FIXTURE, name)
        for n in medium:
            assert not g[n][[0, 2]].any(), (name, n)
        assert np.abs(g["params.sphere_center.x"]).max() > 0, name
    for name in ("scatter", "lit"):
        assert case_grads(FIXTURE, name)["params.materials.medium.density"][1] == 0.0
    lit = case_grads(FIXTURE, "lit")
    assert abs(lit["params.materials.medium.anisotropy"][1]) > 1e-6
    assert np.abs(lit["lights.emission.x"]).max() > 1e-6
    assert np.abs(case_grads(FIXTURE, "absorb")["params.materials.medium.density"][1]) > 1e-6


def test_pallas_media_gradient_matches_xla():
    """The TPU kernel's media backward (_pallas_backward with has_media, in
    interpret mode) against the XLA integrator's jax.grad, as committed."""
    pallas, xla = case_grads(PALLAS_FIXTURE, "pallas"), case_grads(PALLAS_FIXTURE, "xla")
    assert sorted(pallas) == sorted(xla)
    assert_leaves_close(pallas, xla, "pallas vs xla")
    assert abs(xla["params.materials.medium.anisotropy"][1]) > 0


def test_plain_grad_matches_pallas_kernel():
    """The port's plain media gradient against the TPU kernel's, every
    leaf, on the lit-medium case at 16x8."""
    want = case_grads(PALLAS_FIXTURE, "pallas")
    got = port_grads(media_case("lit"), rng.prng_key(PALLAS_KEY), PALLAS_W, PALLAS_H, sorted(want))
    assert_leaves_close(got, want, "port vs pallas")


# What JAX computes, for the fixtures and their guards.


def _jax_grads(scene, render) -> dict:
    from pathtracer_tpu.integrator.inverse import select_leaves

    train, rebuild, names = select_leaves(scene, ("",))

    def loss(tv):
        img = render(rebuild(tv))
        return jnp.mean(img[..., :3] ** 2)

    return {n: np.asarray(g) for n, g in zip(names, jax.grad(loss)(train))}


def _jax_band_grads(scene, render, h, w) -> dict:
    """Each band's part of mean(rgb^2)'s gradient, by the vjp of the frame
    with that band's part of the cotangent 2 rgb / (3 h w)."""
    from pathtracer_tpu.integrator.inverse import select_leaves

    train, rebuild, names = select_leaves(scene, ("",))
    img, vjp = jax.vjp(lambda tv: render(rebuild(tv)), train)
    out = {}
    for k, m in enumerate(band_masks(h, w)):
        (grads,) = vjp(jnp.asarray(m) * img / (h * w * 3) * 2.0)
        out.update({f"rows{k}/{n}": np.asarray(g) for n, g in zip(names, grads)})
    return out


def jax_media_grads() -> dict:
    out = {}
    for name in CASES:
        scene = jax_media_case(name)
        render = lambda s: pt.render_frame(s, jax.random.PRNGKey(3), W, H, detach=True, remat=True)  # noqa: E731
        grads = {**_jax_grads(scene, render), **_jax_band_grads(scene, render, H, W)}
        out.update({f"{name}/{n}": g for n, g in grads.items()})
    return out


def jax_pallas_grads() -> dict:
    from pathtracer_tpu.ops.megakernel import render_frame_pallas

    scene, key = jax_media_case("lit"), jax.random.PRNGKey(PALLAS_KEY)
    pallas = _jax_grads(scene, lambda s: render_frame_pallas(s, key, PALLAS_W, PALLAS_H, media=True, uniforms="hbm",
                                                             interpret=True, tile_rows=8))
    xla = _jax_grads(scene, lambda s: pt.render_frame(s, key, PALLAS_W, PALLAS_H, detach=True, remat=True))
    return {**{f"pallas/{n}": g for n, g in pallas.items()}, **{f"xla/{n}": g for n, g in xla.items()}}


@pytest.mark.slow
def test_fixtures_are_what_jax_computes():
    for path, grads in ((FIXTURE, jax_media_grads()), (PALLAS_FIXTURE, jax_pallas_grads())):
        assert sorted(fixture(path)) == sorted(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(fixture(path)[k], g, rtol=1e-5, atol=1e-9, err_msg=k)


if __name__ == "__main__":
    import sys

    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py
    if "--pallas" not in sys.argv[1:]:
        np.savez(FIXTURE, **jax_media_grads())
    if "--xla" not in sys.argv[1:]:
        np.savez(PALLAS_FIXTURE, **jax_pallas_grads())
