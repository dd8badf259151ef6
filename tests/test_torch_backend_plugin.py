"""Scene-backend plugins: families registered from test code
(`torch_plugin_toy.py`) held to the JAX package's plugin test.

The JAX package registers a one-sphere toy from test code
(`tests/test_backend_plugin.py`) and renders it through its generic kernel
body; `tests/test_procedural.py` renders the analytical scene with a
`_stripes` procedural hook. The port registers the same toy, the toy with
its sphere in an extra tensor, and the stripes hook as a plugin that wraps
the analytical backend (`ops/megakernel.register_backend`), and these
tests hold, on the CPU:

- dispatch (`models/families.family_of`), as `test_plugin_backend_dispatch`:
  the plugins claim their scenes, the built-in families keep theirs, a
  plugin never takes a built-in scene, a name taken twice raises;
- the toy's frame (the plain version that `render_frame_megakernel` runs on
  the CPU) against JAX's: float64 at the oracle tolerance (rtol 1e-9,
  atol 1e-11) against the XLA integrator, float32 at the JAX test's rtol
  1e-4, atol 1e-5 against both JAX's Pallas kernel (interpret mode) and
  its XLA integrator;
- the stripes frame against JAX's hooked frame (the scene of
  `test_megakernel_procedural_parity`) at that test's atol 2e-5, rtol 1e-4
  in float32 (one knife-edge pixel of the analytical scene left out) and
  at the oracle tolerance in float64;
- the toy's gradient (eager autograd, the plain version of K2) against
  jax.grad of every float leaf in float64, rtol 1e-7, atol 1e-12;
- the refusals: a plugin's library build names its header when nvcc is
  missing; a plugin without an adjoint struct, or with extras, keeps eager
  autograd on the CPU.

The JAX renders and gradients are committed under
tests/golden_torch/plugin/ (the JAX toy's leaves beside them, which
`toy_scene_from_arrays` carries into the port's toy); `__main__`
regenerates them (`JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_backend_plugin.py`, ~1 min), and the check that they are
still what JAX computes is marked `slow`. The kernels' code is held on the
host in test_torch_plugin_kernel_host.py and on the card in
test_torch_kernel_cuda.py and chip_smoke.py phase 38. About 5 s.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_plugin_toy as toy
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.inverse import named_leaves
from pathtracer_tpu_torch.models import families
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.models.scene import SurfaceHit
from pathtracer_tpu_torch.ops import _build, rng
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops.vecmath import V3
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_torch", "plugin")
# JAX's toy test's frame (tests/test_backend_plugin.py W, H, KEY; depth 3)
TOY_FIXTURE = os.path.join(GOLDEN, "toy_32x16_d3_k11.npz")
TOY_W, TOY_H, TOY_SEED, TOY_DEPTH = 32, 16, 11, 3
# test_megakernel_procedural_parity's frame (depth 4)
STRIPES_FIXTURE = os.path.join(GOLDEN, "stripes_32x24_d4_k5.npz")
STRIPES_W, STRIPES_H, STRIPES_SEED = 32, 24, 5
# jax.grad of mean(img[..., :3]**2) of the float64 toy, every float leaf
GRAD_FIXTURE = os.path.join(GOLDEN, "toy_grad_32x16_d3_k7_f64.npz")
GRAD_W, GRAD_H, GRAD_SEED = 32, 16, 7
ORACLE = dict(rtol=1e-9, atol=1e-11)
JAX_TEST = dict(rtol=1e-4, atol=1e-5)
PROCEDURAL_TEST = dict(rtol=1e-4, atol=2e-5)
GRAD_F64 = dict(rtol=1e-7, atol=1e-12)


def _fixture(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _section(data: dict, prefix: str) -> dict:
    """The entries of `data` under `prefix:`, the prefix taken off."""
    return {k[len(prefix) + 1:]: v for k, v in data.items() if k.startswith(prefix + ":")}


def test_plugin_dispatch():
    """family_of, as JAX's _resolve_backend: each plugin claims its scenes,
    the built-in families keep theirs, the plugin rows are in BACKENDS and
    their launch counters exist."""
    assert families.family_of(toy.make_toy_scene()) == "toy"
    assert families.family_of(toy.make_toy_scene(extra=True)) == "toy_extra"
    assert families.family_of(toy.make_stripes_scene()) == "stripes"
    for name in families.FAMILIES:
        assert families.family_of(families.make_family_scene(name)) == name
    assert list(families.PLUGINS)[-3:] == ["toy", "toy_extra", "stripes"]
    for p in toy.PLUGINS:
        assert MK.BACKENDS[p.name].plugin is p
        assert MK.render_frame_megakernel.__dict__[f"{p.name}_launches"] >= 0
        assert MK.measure_occupancy_megakernel.__dict__[f"{p.name}_launches"] >= 0
    assert (MK.BACKENDS["toy"].backward, MK.BACKENDS["toy"].media_backward) == (
        "pt_render_backward_plugin", "pt_render_backward_media_plugin")
    assert MK.BACKENDS["toy_extra"].backward is None and MK.BACKENDS["stripes"].backward is None


def test_registration_refuses_a_taken_name():
    """A second registration of a name raises, and so does a built-in
    family's name; a plugin whose matches claims every scene still never
    takes a built-in family's scene (the built-in families are asked
    first), and takes a scene no one else claims."""
    before = dict(families.PLUGINS), dict(MK.BACKENDS)
    with pytest.raises(ValueError, match="'toy' is taken"):
        MK.register_backend(toy.TOY)
    with pytest.raises(ValueError, match="'analytical' is taken"):
        MK.register_backend(toy.TOY._replace(name="analytical"))
    assert (dict(families.PLUGINS), dict(MK.BACKENDS)) == before
    greedy = toy.TOY._replace(name="greedy_test_plugin", matches=lambda scene: True)
    MK.register_backend(greedy)
    try:
        assert families.family_of(make_scene()) == "analytical"
        assert families.family_of(toy.make_toy_scene()) == "toy"  # registered first
        orphan = make_scene().replace(closest_hit_fn=lambda p, ro, rd: None)
        assert families.family_of(orphan) == "greedy_test_plugin"
    finally:
        del families.PLUGINS["greedy_test_plugin"], MK.BACKENDS["greedy_test_plugin"]
    with pytest.raises(NotImplementedError, match="register_backend"):
        families.family_of(orphan)


def test_toy_is_the_jax_toy():
    """The port's make_toy_scene has the JAX toy's leaves, bit for bit in
    float32 and float64, and toy_scene_from_arrays rebuilds them."""
    data = _fixture(TOY_FIXTURE)
    for dtype, prefix in ((torch.float32, "f32"), (torch.float64, "f64")):
        want = _section(data, prefix)
        got = {name: leaf.numpy() for name, leaf in named_leaves(toy.make_toy_scene(dtype))}
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
            assert got[name].dtype == want[name].dtype, name
        carried = dict(named_leaves(toy.toy_scene_from_arrays(want, dtype)))
        for name in want:
            np.testing.assert_array_equal(carried[name].numpy(), want[name], err_msg=name)
    with pytest.raises(ValueError, match="leaves"):
        toy.toy_scene_from_arrays({"params.radius": np.float32(1.0)})


def test_toy_f64_matches_jax_xla():
    """The eager toy in float64 against JAX's XLA integrator on the same
    threefry numbers, at the oracle tolerance."""
    data = _fixture(TOY_FIXTURE)
    scene = toy.toy_scene_from_arrays(_section(data, "f64"), torch.float64, recursion_depth=TOY_DEPTH)
    img = T.render_frame(scene, rng.prng_key(TOY_SEED), TOY_W, TOY_H)
    assert img.dtype == torch.float64
    np.testing.assert_allclose(img.numpy(), data["xla_f64"], **ORACLE)


@pytest.mark.parametrize("jax_frame", ["pallas_f32", "xla_f32"])
def test_toy_f32_matches_jax(jax_frame):
    """render_frame_megakernel on the toy's CPU scene (the plain version of
    K1) against JAX's toy frame, through its Pallas kernel in interpret
    mode and through its XLA integrator, at the JAX test's tolerance; the
    frame a function of the packed vector (render_frame_packed, toy_unpack)
    is the same bit for bit."""
    data = _fixture(TOY_FIXTURE)
    scene = toy.toy_scene_from_arrays(_section(data, "f32"), recursion_depth=TOY_DEPTH)
    key = rng.prng_key(TOY_SEED)
    img = MK.render_frame_megakernel(scene, key, TOY_W, TOY_H)
    assert img.dtype == torch.float32 and np.isfinite(img.numpy()).all()
    np.testing.assert_allclose(img.numpy(), data[jax_frame], **JAX_TEST)
    sv = toy.toy_pack(scene, TOY_W, TOY_H)
    assert sv.shape == (1, toy.TOY_LIGHTS_AT + 15 + 20)
    assert torch.equal(MK.render_frame_packed(sv, scene, key, TOY_W, TOY_H), img)


def test_stripes_matches_jax_hooked_frame():
    """The stripes plugin's eager frame (the analytical closest hit with the
    stripes hook after it) against JAX's analytical scene with the
    `_stripes` procedural_fn, through its Pallas kernel (interpret mode) and
    its XLA integrator, at test_megakernel_procedural_parity's tolerance.
    In float32 one pixel of the 768, (19, 5), takes another branch in the
    analytical scene itself, hook or none (XLA contracts a*b+c on the CPU,
    torch does not: ROADMAP's reference caveat "FMA on the CPU"): the
    pixels where the port's unhooked frame leaves that tolerance of JAX's
    are left out and counted, at most 1. In float64 every pixel of the
    hooked frame is held to JAX's at the oracle tolerance. The port's own
    procedural_fn scene renders the plugin's frame bit for bit on the eager
    tier."""
    data = _fixture(STRIPES_FIXTURE)
    key = rng.prng_key(STRIPES_SEED)
    img = MK.render_frame_megakernel(toy.make_stripes_scene(), key, STRIPES_W, STRIPES_H).numpy()
    unhooked = MK.render_frame_megakernel(make_scene(), key, STRIPES_W, STRIPES_H).numpy()
    tol = PROCEDURAL_TEST["atol"] + PROCEDURAL_TEST["rtol"] * np.abs(data["xla_unhooked"])
    flips = (np.abs(unhooked - data["xla_unhooked"]) > tol).any(-1)
    assert flips.sum() <= 1
    for frame in ("pallas", "xla"):
        np.testing.assert_allclose(img[~flips], data[frame][~flips], err_msg=frame, **PROCEDURAL_TEST)
    f64 = MK.render_frame_reference(toy.make_stripes_scene(dtype=torch.float64), key, STRIPES_W, STRIPES_H)
    np.testing.assert_allclose(f64.numpy(), data["xla_f64"], **ORACLE)
    hooked = make_scene().replace(procedural_fn=toy.stripes)
    assert np.array_equal(T.render_frame(hooked, key, STRIPES_W, STRIPES_H).numpy(), img)
    # the hook moved the frame
    assert np.abs(unhooked - img).max() > 1e-2


def test_stripes_floors_as_python():
    """Python's float `%` floors (the JAX hook's `jnp.floor(x) % 2`): a
    negative odd band is 1, not fmod's -1."""
    x = torch.tensor([-0.3, -0.2, 0.1, 0.3, -1.1])
    hit = SurfaceHit(t=torch.ones(5), normal=None, material=toy.make_toy_scene().params.unpack().materials)
    m = hit.material._replace(rgb=V3(*(torch.full((5,), 0.5) for _ in range(3))))
    out = toy.stripes(None, hit._replace(material=m), V3(x, x * 0, x * 0), V3(x * 0, x * 0, x * 0 + 1))
    # floor(4x): -2, -1, 0, 1, -5 -> bands even, odd, even, odd, odd
    np.testing.assert_array_equal(out.rgb.x.numpy(), np.float32([0.5, 0.05, 0.5, 0.05, 0.05]))


def test_toy_grad_matches_jax_f64():
    """The toy's eager gradient (the plain version of K2: autograd of the
    detached-sampling frame) of every float leaf against jax.grad in
    float64; the leaves that carry one all get one."""
    data = _fixture(GRAD_FIXTURE)
    scene = toy.toy_scene_from_arrays(_section(data, "leaf"), torch.float64, recursion_depth=TOY_DEPTH)
    want = _section(data, "grad")
    leaves = dict(named_leaves(scene))
    names = sorted(want)
    for name in names:
        leaves[name].requires_grad_(True)
    img = T.render_frame(scene, rng.prng_key(GRAD_SEED), GRAD_W, GRAD_H, detach=True)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in names], allow_unused=True)
    for name, g in zip(names, grads):
        got = np.zeros(want[name].shape) if g is None else g.numpy()
        np.testing.assert_allclose(got, want[name], err_msg=name, **GRAD_F64)
    for name in ("params.center.x", "params.radius", "params.materials.rgb.x", "params.sky_zenith.y",
                 "lights.emission.x", "camera.origin.z"):
        assert abs(want[name]).max() > 1e-6, name


@pytest.mark.parametrize("name", ["toy", "toy_extra", "stripes"])
def test_cpu_scene_keeps_eager_autograd(name):
    """On the CPU every plugin, with or without an adjoint struct or
    extras, renders through the plain version with autograd (nothing
    refuses, nothing is built); its occupancy counts are the plain
    version's."""
    scene = {"toy": toy.make_toy_scene, "toy_extra": lambda: toy.make_toy_scene(extra=True),
             "stripes": toy.make_stripes_scene}[name]()
    leaf = dict(named_leaves(scene))["lights.emission.x"].requires_grad_(True)
    key = rng.prng_key(3)
    img = MK.render_frame_megakernel(scene, key, 16, 8)
    (g,) = torch.autograd.grad(img[..., :3].mean(), [leaf])
    assert float(g.abs().sum()) > 0
    stats = MK.measure_occupancy_megakernel(scene, key, 16, 8)
    assert torch.equal(stats["entered"], T.bounces_entered(scene, key, 16, 8, 1))


def test_plugin_build_names_its_header_without_nvcc(tmp_path, monkeypatch):
    """A plugin's library build with no nvcc raises and names the plugin's
    header; nothing is left half built; the hash of a plugin's library takes
    in its header's bytes and its structs."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "torch_kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    src = MK.plugin_source(toy.TOY)
    with pytest.raises(RuntimeError, match="nvcc not found.*torch_plugin_toy.cuh"):
        _build.load_plugin(src)
    assert not list(tmp_path.glob("torch_kernels/*/*.so"))
    header = tmp_path / "copy" / "toy.cuh"
    header.parent.mkdir()
    header.write_text(toy.HEADER.read_text())
    copy = _build.plugin_source(src.name, header, src.forward, src.adjoint)
    first = _build.plugin_dir(copy)
    assert _build.plugin_dir(_build.plugin_source(src.name, header, src.forward)) != first
    header.write_text(toy.HEADER.read_text() + "\n// edited\n")
    edited = _build.plugin_source(src.name, header, src.forward, src.adjoint)
    assert _build.plugin_dir(edited) != first and edited != copy  # another key of load_plugin's cache
    flags = _build.plugin_flags(copy)
    assert "-fmad=false" in flags and f"-DPT_PLUGIN_ADJ={copy.adjoint}" in flags
    assert _build.PLUGIN_SOURCE not in _build.kernels()
    with pytest.raises(ValueError, match="load_plugin"):
        _build.load(_build.PLUGIN_SOURCE)


def test_procedural_hook_refusal_names_the_plugin_route():
    """The kernel path still refuses a procedural_fn, and says how a hook
    reaches the card."""
    hooked = make_scene().replace(procedural_fn=toy.stripes)
    with pytest.raises(NotImplementedError, match="plugin.*register_backend"):
        MK.render_frame_megakernel(hooked, rng.prng_key(0), 8, 8)


def test_toy_extras_table():
    """toy_extra's launch on the CPU tensors: its extras become a pointer
    table with their count, the tensors held beside it; a wrong dtype
    raises."""
    scene = toy.make_toy_scene(extra=True)
    k = MK.prepare_launch(scene, rng.prng_key(0), 8, 4, 1, T.VERBATIM)
    assert k.backend == "toy_extra" and k.counts == (1,) and len(k.held) == 1
    assert k.extras[0].dtype == torch.int64 and int(k.extras[0][0]) == k.held[0].data_ptr()
    np.testing.assert_array_equal(k.held[0].numpy(), np.float32([0, 0, 0, 1]))
    assert k.sv.shape == (1, toy.EXTRA_LIGHTS_AT + 15 + 20)
    with pytest.raises(ValueError, match="float32"):
        MK.extras_table("toy_extra", (torch.zeros(4, dtype=torch.float64),), torch.device("cpu"))


# ---------------------------------------------------------------------------
# The JAX side: what the fixtures hold
# ---------------------------------------------------------------------------


def _jax_leaves(scene) -> dict:
    from pathtracer_tpu.integrator.inverse import keypath_str

    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {keypath_str(path): np.asarray(leaf) for path, leaf in flat}


def jax_toy() -> dict:
    """JAX's toy frame: its f32 and f64 leaves, the XLA frames in both and
    the Pallas (interpret) frame in float32, tests/test_backend_plugin.py's
    configuration."""
    import pathtracer_tpu as pt
    import test_backend_plugin as jt
    from pathtracer_tpu.ops.megakernel import render_frame_pallas

    out = {}
    key = jax.random.PRNGKey(TOY_SEED)
    for dtype, prefix in ((jnp.float32, "f32"), (jnp.float64, "f64")):
        scene = jt.make_toy_scene(dtype=dtype, recursion_depth=TOY_DEPTH)
        out.update({f"{prefix}:{k}": v for k, v in _jax_leaves(scene).items()})
        out[f"xla_{prefix}"] = np.asarray(pt.render_frame(scene, key, TOY_W, TOY_H, spp=1))
    scene = jt.make_toy_scene(dtype=jnp.float32, recursion_depth=TOY_DEPTH)
    out["pallas_f32"] = np.asarray(render_frame_pallas(scene, key, TOY_W, TOY_H, spp=1, uniforms="hbm", tile_rows=8,
                                                       interpret=True))
    return out


def jax_stripes() -> dict:
    """test_megakernel_procedural_parity's hooked frame, Pallas (interpret)
    and XLA; the same scene's XLA frame without the hook, and with it in
    float64."""
    import pathtracer_tpu as pt
    import test_procedural as jp
    from pathtracer_tpu.ops.megakernel import render_frame_pallas

    plain = pt.make_analytical_scene(dtype=jnp.float32)
    scene = plain.replace(procedural_fn=jp._stripes)
    f64 = pt.make_analytical_scene(dtype=jnp.float64).replace(procedural_fn=jp._stripes)
    key = jax.random.PRNGKey(STRIPES_SEED)
    return {
        "xla": np.asarray(pt.render_frame(scene, key, STRIPES_W, STRIPES_H)),
        "pallas": np.asarray(render_frame_pallas(scene, key, STRIPES_W, STRIPES_H, uniforms="hbm", interpret=True,
                                                 tile_rows=8)),
        "xla_unhooked": np.asarray(pt.render_frame(plain, key, STRIPES_W, STRIPES_H)),
        "xla_f64": np.asarray(pt.render_frame(f64, key, STRIPES_W, STRIPES_H)),
    }


def jax_toy_grad() -> dict:
    """jax.grad of mean(img[..., :3]**2) of the float64 toy with respect to
    every float leaf (select_leaves), and the leaves."""
    import pathtracer_tpu as pt
    import test_backend_plugin as jt
    from pathtracer_tpu.integrator.inverse import select_leaves

    scene = jt.make_toy_scene(dtype=jnp.float64, recursion_depth=TOY_DEPTH)
    train, rebuild, names = select_leaves(scene, ("",))

    def loss(tv):
        img = pt.render_frame(rebuild(tv), jax.random.PRNGKey(GRAD_SEED), GRAD_W, GRAD_H, detach=True, remat=True)
        return jnp.mean(img[..., :3] ** 2)

    grads = jax.grad(loss)(train)
    out = {f"leaf:{k}": v for k, v in _jax_leaves(scene).items()}
    out.update({f"grad:{name}": np.asarray(g) for name, g in zip(names, grads)})
    return out


FIXTURES = {TOY_FIXTURE: jax_toy, STRIPES_FIXTURE: jax_stripes, GRAD_FIXTURE: jax_toy_grad}


@pytest.mark.slow
@pytest.mark.parametrize("path", sorted(FIXTURES), ids=os.path.basename)
def test_fixtures_are_what_jax_computes(path):
    want = _fixture(path)
    got = FIXTURES[path]()
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-12, err_msg=name)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(GOLDEN, exist_ok=True)
    for path, make in FIXTURES.items():
        np.savez(path, **make())
        print("wrote", path)
