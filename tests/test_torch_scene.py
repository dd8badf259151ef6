"""Scene data of the port held to the JAX package: parameters cross over
through `scene_to_dict` / `scene_from_dict`, `pack_scene` gives the same
vector, and `gen_ray` the same camera rays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as pt
from pathtracer_tpu.ops.megakernel import pack_scene as jax_pack_scene
from pathtracer_tpu.utils.sceneio import scene_to_dict
from pathtracer_tpu_torch.models import camera as TC
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.ops.megakernel import pack_scene
from pathtracer_tpu_torch.ops.vecmath import V2, V3
from pathtracer_tpu_torch.utils.sceneio import scene_from_dict


def _jax_leaves(tree) -> dict:
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _assert_same_leaves(jax_scene, scene):
    for section in ("params", "lights", "camera"):
        ref = _jax_leaves(getattr(jax_scene, section))
        got = {"." + k: v.numpy() for k, v in getattr(scene, section).named_buffers(remove_duplicate=False)}
        assert sorted(ref) == sorted(got), section
        for path, r in ref.items():
            assert got[path].dtype == r.dtype, (section, path)
            np.testing.assert_array_equal(got[path], r, err_msg=f"{section}{path}")


def _modified_jax_scene():
    s = pt.make_analytical_scene(recursion_depth=3)
    p = s.params
    mats = p.materials._replace(
        roughness=jnp.asarray([0.2, 0.3, 0.9], jnp.float32),
        alpha_mode=jnp.asarray([0, 1, 2], jnp.int32),
    )
    p = p._replace(sphere_radius=jnp.asarray([0.5, 0.75], jnp.float32), materials=mats)
    lights = pt.concat_lights(
        pt.spherical_light((3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0)),
        pt.rect_light((-2.0, 3.0, -1.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (2.0, 2.0, 2.0)),
        pt.distant_light((0.3, 1.0, 0.2), (0.5, 0.5, 0.5)),
    )
    f32 = jnp.float32
    cam = s.camera.set(pt.v3(0.5, 1.0, 4.0, dtype=f32), pt.v3(0.0, 0.0, 0.0, dtype=f32)).set_fov(60.0)
    return s.replace(params=p, lights=lights, camera=cam)


def test_scene_from_dict_default_equals_make_scene():
    jax_scene = pt.make_analytical_scene()
    scene = scene_from_dict(scene_to_dict(jax_scene, "analytical"))
    own = make_scene()
    for section in ("params", "lights", "camera"):
        a = dict(getattr(scene, section).named_buffers(remove_duplicate=False))
        b = dict(getattr(own, section).named_buffers(remove_duplicate=False))
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (section, k)
    _assert_same_leaves(jax_scene, own)


def test_scene_from_dict_carries_every_leaf():
    jax_scene = _modified_jax_scene()
    scene = scene_from_dict(scene_to_dict(jax_scene, "analytical"))
    _assert_same_leaves(jax_scene, scene)
    assert scene.recursion_depth == 3 and scene.num_lights == 3


def test_scene_from_dict_rejects_bad_leaves():
    desc = scene_to_dict(pt.make_analytical_scene(), "analytical")
    with pytest.raises(KeyError):
        scene_from_dict({**desc, "params": {".no_such_leaf": 1.0}})
    with pytest.raises(ValueError):
        scene_from_dict({**desc, "params": {".sphere_radius": [1.0, 2.0, 3.0]}})
    with pytest.raises(NotImplementedError):
        scene_from_dict({**desc, "family": "sdf"})


@pytest.mark.parametrize("with_medium", [False, True])
@pytest.mark.parametrize("modified", [False, True])
def test_pack_scene_matches_jax(with_medium, modified):
    jax_scene = _modified_jax_scene() if modified else pt.make_analytical_scene()
    scene = scene_from_dict(scene_to_dict(jax_scene, "analytical"))
    ref = np.asarray(jax_pack_scene(jax_scene, 64, 48, with_medium=with_medium))
    got = pack_scene(scene, 64, 48, with_medium=with_medium).numpy()
    assert got.shape == ref.shape == (1, 37 + 15 * jax_scene.lights.count + (26 if with_medium else 20) * 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gen_ray_matches_jax(dtype):
    w, h = 37, 23
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    off = rng.random((2, w * h)).astype(dtype)
    jax_cam = pt.default_pinhole(jd).set(pt.v3(0.5, 1.0, 4.0, dtype=jd), pt.v3(0.1, 0.0, 0.0, dtype=jd))
    jc = pt.pixel_coords(w, h, jd)
    ro, rd = pt.gen_ray(jax_cam, jc, pt.V2(jnp.asarray(off[0]), jnp.asarray(off[1])), float(w), float(h))

    cam = TC.default_pinhole(td)._replace(
        origin=TC.v3(0.5, 1.0, 4.0, dtype=td), center=TC.v3(0.1, 0.0, 0.0, dtype=td)
    )
    tc = TC.pixel_coords(w, h, td)
    tro, trd = TC.gen_ray(cam, tc, V2(torch.from_numpy(off[0]), torch.from_numpy(off[1])), float(w), float(h))
    np.testing.assert_array_equal(tc.x.numpy(), np.asarray(jc.x))
    np.testing.assert_array_equal(tc.y.numpy(), np.asarray(jc.y))
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == "float64" else dict(rtol=1e-5, atol=1e-6)
    for a, b in zip((*ro, *rd), (*tro, *trd)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


def test_scene_module_moves_and_unpacks():
    scene = make_scene(dtype=torch.float64)
    assert scene.dtype == torch.float64 and scene.num_lights == 1
    names = dict(scene.named_buffers(remove_duplicate=False))
    assert "params.materials.rgb.x" in names and "camera.origin.z" in names
    assert names["params.materials.alpha_mode"].dtype == torch.int32
    p = scene.params.unpack()
    assert p.materials.medium.medium_type.shape == (3,)


def test_make_ray_matches_jax():
    from pathtracer_tpu.models.ray import make_ray as jax_make_ray
    from pathtracer_tpu_torch.models.ray import make_ray

    d = np.array([[1.0, 0.0, -0.5], [0.2, -0.3, 0.0], [0.0, 2.0, 0.1]], np.float32)
    o = np.ones((3, 3), np.float32)
    ref = jax_make_ray(pt.V3(*map(jnp.asarray, o)), pt.V3(*map(jnp.asarray, d)))
    got = make_ray(V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d)))
    for a, b in zip(jax.tree_util.tree_leaves(ref), [t for f in got for t in (f if isinstance(f, tuple) else (f,))]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(got.at(2.0).x.numpy(), np.asarray(ref.at(2.0).x))
