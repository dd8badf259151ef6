"""Participating media and the direct-lighting estimators of the port's
eager integrator, held to the JAX package and the float64 CPU oracle.

The scenes are tests/test_medium.py's: the analytical demo with sphere 1
made glass (spec_trans 1, metallic 0, roughness 0.05, ior 1.5) and filled
with a medium (Absorb, Emissive or HG Scatter), built here from each
package's own models (`glass_scene`, `jax_glass_scene`); and
tests/test_physics.py's scatter scene for the estimators.

The JAX side is committed under tests/golden_torch/:
  media_24x16_d6_f64.npz  float64 render_frame frames, 24x16, depth 6, one
      per case of CASES (each with its key);
  media_analytical_64x48_d6_k3.npy  the float32 frame of the Scatter demo
      (g 0.4) at 64x48, depth 6, PRNGKey(3); chip_smoke.py holds K1's media
      instantiation to it on the card;
  grad_media_16x8_d6_k5.npz  jax.grad of mean(rgb^2) (detach=True) with
      respect to the medium's density, color and anisotropy, float64,
      16x8, depth 6, PRNGKey(5), for the Absorb, Emissive and Scatter demos
      (keyed "<case>/<leaf>");
  occupancy_media_128x32_d6_k4.npz  JAX's occupancy probe and its Pallas
      K3 in interpret mode (flat tiles, "hbm" uniforms) on the float32
      Scatter demo, 128x32, depth 6, PRNGKey(4).
Regenerate them with `JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_media.py` (a few minutes); the checks that JAX still
computes them are marked `slow`. The oracle frames come from
tests/golden/ through tests/oracle_cache.py, test_medium.py's own.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from oracle_cache import cached_render
from pathtracer_tpu.oracle import cpu_oracle as O
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.inverse import named_leaves
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.models.material import MediumType
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from test_torch_kernel_host import one_torch_thread  # noqa: F401
from test_torch_media_kernel_host import DEMO, make_glass
from test_torch_render import assert_image_close

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_torch")
EAGER_FIXTURE = os.path.join(GOLDEN, "media_24x16_d6_f64.npz")
F32_FIXTURE = os.path.join(GOLDEN, "media_analytical_64x48_d6_k3.npy")
GRAD_FIXTURE = os.path.join(GOLDEN, "grad_media_16x8_d6_k5.npz")
OCC_FIXTURE = os.path.join(GOLDEN, "occupancy_media_128x32_d6_k4.npz")
W, H, DEPTH = 24, 16, 6

# case -> (scene: "glass" or "physics", medium kwargs or None, key seed,
# estimator, quirks)
CASES = {
    "glass": ("glass", None, 2, "mis", "verbatim"),
    "none": ("glass", dict(med_type=MediumType.NONE, density=5.0), 2, "mis", "verbatim"),
    "absorb": ("glass", dict(med_type=MediumType.ABSORB, **DEMO), 11, "mis", "verbatim"),
    "emissive": ("glass", dict(med_type=MediumType.EMISSIVE, density=0.5, color=(0.2, 0.8, 0.3)), 12, "mis",
                 "verbatim"),
    "scatter": ("glass", dict(med_type=MediumType.SCATTER, anisotropy=0.4, **DEMO), 13, "mis", "verbatim"),
    "scatter_g0": ("glass", dict(med_type=MediumType.SCATTER, density=2.0, color=(1.0, 1.0, 1.0), anisotropy=0.0),
                   14, "mis", "verbatim"),
    "scatter_g-0.3": ("glass", dict(med_type=MediumType.SCATTER, density=1.5, color=(0.8, 0.8, 0.9),
                                    anisotropy=-0.3), 15, "mis", "fixed"),
    "scatter_bsdf": ("glass", dict(med_type=MediumType.SCATTER, anisotropy=0.4, **DEMO), 13, "bsdf", "verbatim"),
    "scatter_nee": ("glass", dict(med_type=MediumType.SCATTER, anisotropy=0.4, **DEMO), 13, "nee", "verbatim"),
    "physics_mis": ("physics", None, 300, "mis", "fixed"),
    "physics_bsdf": ("physics", None, 300, "bsdf", "fixed"),
    "physics_nee": ("physics", None, 300, "nee", "fixed"),
}
# test_medium.py's oracle configurations: (medium kwargs, key seed)
ORACLE = {
    "absorb": (dict(med_type=MediumType.ABSORB), 11),
    "emissive": (dict(med_type=MediumType.EMISSIVE, density=0.5, color=(0.2, 0.8, 0.3)), 12),
    "scatter": (dict(med_type=MediumType.SCATTER, density=1.5, color=(0.8, 0.8, 0.9), anisotropy=0.4), 13),
    "scatter_g0": (dict(med_type=MediumType.SCATTER, density=2.0, color=(1.0, 1.0, 1.0), anisotropy=0.0), 14),
}
# the media of the gradient fixture
GRAD_CASES = ("absorb", "emissive", "scatter")
GRAD_LEAVES = ["params.materials.medium.density"] + [f"params.materials.medium.color.{c}" for c in "xyz"] + [
    "params.materials.medium.anisotropy"]
MATERIAL_LIGHT = dict(rtol=5e-3, atol=1e-8)  # tests/test_torch_grad.py's


def glass_scene(dtype=torch.float64, med_type=None, density=0.8, color=(0.9, 0.2, 0.1), anisotropy=0.0,
                depth=DEPTH):
    """The port's demo scene with sphere 1 glass, filled with a medium
    when med_type is given."""
    return make_glass(make_scene(dtype=dtype, recursion_depth=depth), 1, med_type, density, color, anisotropy)


def physics_scene(dtype=torch.float64):
    """tests/test_physics.py's MIS-vs-NEE scatter scene."""
    scene = glass_scene(dtype, MediumType.SCATTER, 1.0, (0.9, 0.9, 0.9), 0.3)
    m = scene.params.materials
    with torch.no_grad():
        m.roughness.copy_(torch.tensor([0.4, 0.3, 1.0], dtype=dtype))
        m.clearcoat.zero_()
        m.ior[1] = 1.1
    return scene


def jax_glass_scene(dtype, med_type=None, density=0.8, color=(0.9, 0.2, 0.1), anisotropy=0.0, depth=DEPTH):
    """glass_scene of the JAX package."""
    scene = pt.make_analytical_scene(dtype=dtype, recursion_depth=depth)
    m = scene.params.materials
    m = m._replace(spec_trans=m.spec_trans.at[1].set(1.0), metallic=m.metallic.at[1].set(0.0),
                   roughness=m.roughness.at[1].set(0.05), ior=m.ior.at[1].set(1.5))
    if med_type is not None:
        med = m.medium
        med = med._replace(
            medium_type=med.medium_type.at[1].set(med_type), density=med.density.at[1].set(density),
            color=med.color._replace(x=med.color.x.at[1].set(color[0]), y=med.color.y.at[1].set(color[1]),
                                     z=med.color.z.at[1].set(color[2])),
            anisotropy=med.anisotropy.at[1].set(anisotropy),
        )
        m = m._replace(medium=med)
    return scene.replace(params=scene.params._replace(materials=m))


def jax_physics_scene(dtype):
    scene = jax_glass_scene(dtype, MediumType.SCATTER, 1.0, (0.9, 0.9, 0.9), 0.3)
    m = scene.params.materials
    m = m._replace(roughness=jnp.asarray([0.4, 0.3, 1.0], dtype), clearcoat=jnp.zeros_like(m.clearcoat),
                   ior=m.ior.at[1].set(1.1))
    return scene.replace(params=scene.params._replace(materials=m))


def port_case(name: str):
    kind, medium, seed, estimator, quirks = CASES[name]
    scene = physics_scene() if kind == "physics" else glass_scene(**(medium or {}))
    return scene, rng.prng_key(seed), estimator, T.FIXED if quirks == "fixed" else T.VERBATIM


def jax_case(name: str):
    kind, medium, seed, estimator, quirks = CASES[name]
    scene = jax_physics_scene(jnp.float64) if kind == "physics" else jax_glass_scene(jnp.float64, **(medium or {}))
    return scene, jax.random.PRNGKey(seed), estimator, pt.FIXED if quirks == "fixed" else pt.VERBATIM


@functools.lru_cache(maxsize=None)
def fixture(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", sorted(CASES))
def test_eager_matches_jax(name):
    scene, key, estimator, quirks = port_case(name)
    img = T.render_frame(scene, key, W, H, quirks=quirks, estimator=estimator).numpy()
    assert img.dtype == np.float64 and np.isfinite(img).all()
    np.testing.assert_allclose(img, fixture(EAGER_FIXTURE)[name], rtol=1e-9, atol=1e-12)


def test_medium_none_is_noop():
    key = rng.prng_key(2)
    base = T.render_frame(glass_scene(), key, W, H)
    noop = T.render_frame(glass_scene(med_type=MediumType.NONE, density=5.0), key, W, H)
    assert torch.equal(base, noop)


@pytest.mark.parametrize("name", sorted(ORACLE))
def test_eager_matches_oracle(name):
    medium, seed = ORACLE[name]
    js = jax_glass_scene(jnp.float64, **medium)
    cam_u, bounce_u = (np.asarray(a, np.float64) for a in pt.draw_uniforms(jax.random.PRNGKey(seed), W * H, DEPTH,
                                                                             jnp.float64))
    oracle = cached_render(O.OracleScene(js.params, js.lights, js.camera, recursion_depth=DEPTH), W, H, cam_u,
                           bounce_u)
    img = T.render_frame(glass_scene(**medium), rng.prng_key(seed), W, H)
    np.testing.assert_allclose(img.numpy(), oracle, rtol=1e-9, atol=1e-11)


def test_media_change_the_image():
    """Absorb darkens, Emissive brightens, Scatter differs from vacuum."""
    key = rng.prng_key(4)
    frame = lambda **m: T.render_frame(glass_scene(**m), key, W, H)[..., :3].sum().item()  # noqa: E731
    base = frame()
    assert frame(med_type=MediumType.ABSORB, density=4.0, color=(0.0, 0.0, 0.0)) < base
    assert frame(med_type=MediumType.EMISSIVE, density=2.0, color=(1.0, 1.0, 1.0)) > base
    assert frame(med_type=MediumType.SCATTER, anisotropy=0.4, **DEMO) != base


def test_f32_eager_matches_jax():
    img = T.render_frame(glass_scene(torch.float32, MediumType.SCATTER, anisotropy=0.4, **DEMO), rng.prng_key(3),
                         64, 48)
    assert img.dtype == torch.float32
    assert_image_close(img, np.load(F32_FIXTURE))


def test_megakernel_cpu_path_renders_media():
    """render_frame_megakernel on a CPU media scene is the plain version,
    and render_frame_packed reads the medium from the 26-scalar records."""
    scene = glass_scene(torch.float32, MediumType.SCATTER, anisotropy=0.4, **DEMO)
    key = rng.prng_key(6)
    launches = MK.render_frame_megakernel.launches
    img = MK.render_frame_megakernel(scene, key, W, H)
    assert MK.render_frame_megakernel.launches == launches
    assert torch.equal(img, MK.render_frame_reference(scene, key, W, H))
    sv = MK.pack_scene(scene, W, H, with_medium=True)
    assert sv.shape == (1, 37 + 15 + 26 * 3)
    assert torch.equal(MK.render_frame_packed(sv, scene, key, W, H), img)


def test_packed_media_gradient_reaches_the_medium():
    """render_grad_reference (K2's plain version over the packed vector)
    reads the medium from the 26-scalar records: its entries there are
    autograd's through the scene's medium leaves."""
    scene = glass_scene(torch.float32, MediumType.ABSORB, **DEMO)
    key, (w, h) = rng.prng_key(9), (16, 8)
    sv = MK.pack_scene(scene, w, h, with_medium=True)
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((h, w, 4)).astype(np.float32))
    g = MK.render_grad_reference(sv, scene, key, ct, w, h).reshape(-1)
    leaves = dict(named_leaves(scene))
    names = GRAD_LEAVES[:4]  # density and color; Absorb reads no anisotropy
    for n in names:
        leaves[n].requires_grad_(True)
    img = MK.render_frame_reference(scene, key, w, h)
    want = torch.autograd.grad((img * ct).sum(), [leaves[n] for n in names])
    at = 37 + 15 * scene.num_lights + 26 * 1 + 21  # material 1's density
    got = g[at:at + 4]
    np.testing.assert_allclose(got.numpy(), torch.stack([w_[1] for w_ in want]).numpy(), rtol=1e-5, atol=1e-7)
    assert float(got.abs().max()) > 0


def _port_medium_grads(scene, key, w, h):
    leaves = dict(named_leaves(scene))
    for n in GRAD_LEAVES:
        leaves[n].requires_grad_(True)
    img = T.render_frame(scene, key, w, h, detach=True)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in GRAD_LEAVES], allow_unused=True)
    return {n: np.zeros(leaves[n].shape) if g is None else g.numpy() for n, g in zip(GRAD_LEAVES, grads)}


@pytest.mark.parametrize("name", GRAD_CASES)
def test_eager_grad_matches_jax(name):
    """The plain version of K2's media branch: autograd of the detached
    estimator through the medium's leaves, against jax.grad."""
    _, medium, _, _, _ = CASES[name]
    got = _port_medium_grads(glass_scene(**medium), rng.prng_key(5), 16, 8)
    want = fixture(GRAD_FIXTURE)
    for leaf in GRAD_LEAVES:
        np.testing.assert_allclose(got[leaf], want[f"{name}/{leaf}"], err_msg=leaf, **MATERIAL_LIGHT)
    assert max(np.abs(got[n][1]) for n in GRAD_LEAVES) > 1e-6


def test_plain_k3_counts_match_jax():
    """bounces_entered (K3's plain version) on the float32 Scatter demo:
    JAX's probe, and its Pallas K3's flat tiles of 8 x 128 lanes."""
    want = fixture(OCC_FIXTURE)
    scene = glass_scene(torch.float32, MediumType.SCATTER, anisotropy=0.4, **DEMO)
    entered = T.bounces_entered(scene, rng.prng_key(4), 128, 32)
    assert entered.shape == (1, 32, 128) and 1 <= int(entered.min()) and int(entered.max()) <= DEPTH
    lanes = entered.reshape(-1, 8 * 128).numpy()
    counts = np.stack([(lanes > b).sum(axis=1) for b in range(DEPTH)], axis=1)
    np.testing.assert_array_equal(counts, want["flat_spp1_counts"])
    frac = [(entered > b).double().mean().item() for b in range(DEPTH)]
    np.testing.assert_allclose(frac, want["probe_spp1"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("g", [0.0, 5e-4, -2e-3, 0.4, -0.3, 0.9])
def test_hg_matches_jax(g):
    """hg_phase and sample_hg against the JAX package's, float64, the
    isotropic branch (|g| < 1e-3) and both signs of g included."""
    from pathtracer_tpu.ops import sampling as jax_sampling
    from pathtracer_tpu.ops.vecmath import V3 as JV3
    from pathtracer_tpu_torch.ops import sampling
    from pathtracer_tpu_torch.ops.vecmath import V3, safe_normalize

    r = np.random.default_rng(17)
    d = r.standard_normal((3, 256))
    d /= np.linalg.norm(d, axis=0)
    r1, r2, cos = r.random(256), r.random(256), r.uniform(-1.0, 1.0, 256)
    gt = torch.full((256,), g, dtype=torch.float64)
    got = sampling.sample_hg(safe_normalize(V3(*map(torch.from_numpy, d))), gt, torch.from_numpy(r1),
                             torch.from_numpy(r2))
    want = jax_sampling.sample_hg(JV3(*map(jnp.asarray, d)), jnp.full(256, g), jnp.asarray(r1), jnp.asarray(r2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(sampling.hg_phase(torch.from_numpy(cos), gt).numpy(),
                               np.asarray(jax_sampling.hg_phase(jnp.asarray(cos), jnp.full(256, g))), rtol=1e-12)


def test_media_work_counts():
    """tools/work.count_media_work: every segment of the frame, those inside
    the medium and the scatter events among them; none off media."""
    from pathtracer_tpu_torch.tools.work import count_media_work, count_segments

    key = rng.prng_key(8)
    scene = glass_scene(torch.float32, MediumType.SCATTER, anisotropy=0.4, **DEMO)
    work = count_media_work(scene, key, 32, 24)
    assert work["segments"] == count_segments(scene, key, 32, 24)
    assert 0 < work["scatter"] < work["medium"] < work["segments"]
    vacuum = count_media_work(glass_scene(torch.float32), key, 32, 24)
    assert vacuum["medium"] == vacuum["scatter"] == 0


# What JAX computes, for the fixtures and their guards.


def jax_eager_frames() -> dict:
    out = {}
    for name in CASES:
        scene, key, estimator, quirks = jax_case(name)
        out[name] = np.asarray(pt.render_frame(scene, key, W, H, quirks=quirks, estimator=estimator))
    return out


def jax_f32_frame() -> np.ndarray:
    scene = jax_glass_scene(jnp.float32, MediumType.SCATTER, anisotropy=0.4, **DEMO)
    return np.asarray(pt.render_frame(scene, jax.random.PRNGKey(3), 64, 48))


def jax_medium_grads() -> dict:
    from pathtracer_tpu.integrator.inverse import select_leaves

    out = {}
    for name in GRAD_CASES:
        _, medium, _, _, _ = CASES[name]
        train, rebuild, names = select_leaves(jax_glass_scene(jnp.float64, **medium), ("medium",))

        def loss(tv):
            img = pt.render_frame(rebuild(tv), jax.random.PRNGKey(5), 16, 8, detach=True, remat=True)
            return jnp.mean(img[..., :3] ** 2)

        assert sorted(names) == sorted(GRAD_LEAVES)
        out.update({f"{name}/{n}": np.asarray(g) for n, g in zip(names, jax.grad(loss)(train))})
    return out


def jax_occupancy() -> dict:
    from pathtracer_tpu.integrator.tracer import measure_occupancy
    from pathtracer_tpu.ops.megakernel import measure_occupancy_pallas

    scene = jax_glass_scene(jnp.float32, MediumType.SCATTER, anisotropy=0.4, **DEMO)
    key = jax.random.PRNGKey(4)
    stats = measure_occupancy_pallas(scene, key, 128, 32, tile_rows=8, uniforms="hbm", interpret=True, tiling="flat")
    return {"probe_spp1": np.asarray(measure_occupancy(scene, key, 128, 32)),
            "flat_spp1_counts": np.asarray(stats["counts"])}


@pytest.mark.slow
def test_fixtures_are_what_jax_computes():
    for name, frame in jax_eager_frames().items():
        np.testing.assert_allclose(fixture(EAGER_FIXTURE)[name], frame, rtol=1e-12, atol=1e-14, err_msg=name)
    for name, g in jax_medium_grads().items():
        np.testing.assert_allclose(fixture(GRAD_FIXTURE)[name], g, rtol=1e-9, atol=1e-14, err_msg=name)
    np.testing.assert_allclose(np.load(F32_FIXTURE), jax_f32_frame(), rtol=0, atol=1e-6)
    for k, v in jax_occupancy().items():
        np.testing.assert_allclose(fixture(OCC_FIXTURE)[k], v, rtol=0, atol=1e-6, err_msg=k)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py
    np.save(F32_FIXTURE, jax_f32_frame())
    np.savez(OCC_FIXTURE, **jax_occupancy())
    np.savez(EAGER_FIXTURE, **jax_eager_frames())
    np.savez(GRAD_FIXTURE, **jax_medium_grads())
