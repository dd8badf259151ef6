"""The render CLI's host surface in the port, held to the JAX package on
the CPU: the prelude's math helpers and mix_materials, ColorBuffer's
accessors, RenderConfig's JSON, the metrics and the profiler hook, the
native runtime's binding, the ANSI preview, scene files, the camera's
controls, and the render state's checkpoints (the port's own resume, and a
render of the JAX CLI carried across).

No JAX render runs here: the JAX CLI's checkpoints are committed under
tests/golden_torch/render_ckpt_16x12_d2_f64/ (`python
tests/test_torch_host_surface.py` writes them again; the `slow` guard
checks that they are still what the JAX CLI writes).
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu
import pathtracer_tpu_torch
from pathtracer_tpu.models import camera as jax_camera
from pathtracer_tpu.models import material as jax_material
from pathtracer_tpu.ops import vecmath as jax_vm
from pathtracer_tpu.utils import buffer as jax_buffer
from pathtracer_tpu.utils import image as jax_image
from pathtracer_tpu.utils import metrics as jax_metrics
from pathtracer_tpu.utils import sceneio as jax_sceneio
from pathtracer_tpu_torch.app import render as cli
from pathtracer_tpu_torch.integrator.tracer import accumulate
from pathtracer_tpu_torch.models import camera, material
from pathtracer_tpu_torch.models.families import make_family_scene
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops import vecmath as vm
from pathtracer_tpu_torch.ops.megakernel import render_frame_megakernel
from pathtracer_tpu_torch.utils import buffer, checkpoint, image, metrics, sceneio
from pathtracer_tpu_torch.utils.config import RenderConfig
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_CKPT = ROOT / "tests" / "golden_torch" / "render_ckpt_16x12_d2_f64"
# the JAX render CLI's run that wrote JAX_CKPT (with JAX_ENABLE_X64=1: the
# CLI does not turn x64 on, and its f64 is float32 without it)
JAX_CLI_ARGS = ["--cpu", "--width", "16", "--height", "12", "--depth", "2", "--precision", "f64", "--frames", "4",
                "--ckpt-every", "2"]
FAMILIES = ("analytical", "sdf", "mesh", "bigmesh")
# the JAX prelude's names the port leaves out, and why
NOT_PORTED = {
    "render_frame_pallas": "the port's K1 entry point is render_frame_megakernel",
    "measure_occupancy_pallas": "the port's K3 entry point is measure_occupancy_megakernel",
    "resolve_tiling": "a TPU tile layout (ROADMAP: do not port)",
}


def _rs(seed=0):
    return np.random.default_rng(seed)


def _v3(a):
    """(port V3, JAX V3) of a [3, n] float64 array."""
    return vm.V3(*(torch.from_numpy(c.copy()) for c in a)), jax_vm.V3(*(jnp.asarray(c) for c in a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12, atol=0)


# (a) the math helpers and mix_materials, float64, rtol 1e-12


def test_b3_and_less_than_match_jax():
    a, ja = _v3(_rs(1).uniform(-1, 1, (3, 64)))
    b, jb = _v3(_rs(2).uniform(-1, 1, (3, 64)))
    c, jc = _v3(_rs(3).uniform(-1, 1, (3, 64)))
    lt, jlt = vm.less_than(a, b), jax_vm.less_than(ja, jb)
    lt2, jlt2 = vm.less_than(c, a), jax_vm.less_than(jc, ja)
    for got, want in ((lt, jlt), (lt & lt2, jlt & jlt2), (lt | lt2, jlt | jlt2), (~lt, ~jlt)):
        assert isinstance(got, vm.B3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(lt.any().numpy(), np.asarray(jlt.any()))
    np.testing.assert_array_equal(lt.all().numpy(), np.asarray(jlt.all()))
    for g, w in zip(lt.select(a, b), jlt.select(ja, jb)):
        _close(g, w)


def test_vector_helpers_match_jax():
    a, ja = _v3(_rs(4).uniform(0.1, 2.0, (3, 64)))
    b, jb = _v3(_rs(5).uniform(-2.0, 2.0, (3, 64)))
    for g, w in zip(vm.pow3(a, b), jax_vm.pow3(ja, jb)):
        _close(g, w)
    _close(vm.length(b), jax_vm.length(jb))
    x = _rs(6).uniform(-1.0, 2.0, 64)
    _close(vm.smoothstep(0.2, 1.3, torch.from_numpy(x)), jax_vm.smoothstep(0.2, 1.3, jnp.asarray(x)))
    dense = _rs(7).standard_normal((5, 3))
    for g, w in zip(vm.from_array(torch.from_numpy(dense)), jax_vm.from_array(jnp.asarray(dense))):
        _close(g, w)
    for g, w in zip(vm.ones3((2, 3), torch.float64), jax_vm.ones3((2, 3), jnp.float64)):
        assert g.dtype == torch.float64 and g.shape == w.shape
        _close(g, w)
    for g, w in zip(vm.hex_color("#1a80ff", torch.float64), jax_vm.hex_color("#1a80ff", jnp.float64)):
        _close(g, w)


def _random_material(seed, mod, dtype, n=16):
    """A finalized material table of n random records, the same values in
    either package (`mod`: the port's material module or the JAX one)."""
    rs = _rs(seed)
    u = lambda: rs.uniform(0.0, 1.0, n)
    t = (lambda a: torch.from_numpy(a)) if mod is material else jnp.asarray
    v3 = vm.V3 if mod is material else jax_vm.V3
    m = mod.default_material((n,), dtype)
    m = m._replace(rgb=v3(t(u()), t(u()), t(u())), emission=v3(t(u()), t(u()), t(u())), **{
        name: t(u()) for name in ("anisotropic", "metallic", "roughness", "subsurface", "specular_tint", "sheen",
                                  "sheen_tint", "clearcoat", "clearcoat_gloss", "spec_trans", "opacity")
    }, ior=t(1.0 + u()))
    return mod.finalize_material(m)


def test_mix_materials_matches_jax():
    t = _rs(9).uniform(0.0, 1.0, 16)
    got = material.mix_materials(_random_material(10, material, torch.float64),
                                 _random_material(11, material, torch.float64), torch.from_numpy(t))
    want = jax_material.mix_materials(_random_material(10, jax_material, jnp.float64),
                                      _random_material(11, jax_material, jnp.float64), jnp.asarray(t))
    import jax

    got_leaves = [x.numpy() for x in jax.tree_util.tree_leaves(got)]
    want_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(got_leaves) == len(want_leaves) == 29
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w)
    # the quirk: what Material::mix does not lerp keeps Material::new's value
    np.testing.assert_array_equal(got.ax.numpy(), 0.0)
    np.testing.assert_array_equal(got.opacity.numpy(), 1.0)


# (b) ColorBuffer's accessors and RenderConfig's JSON


def test_color_buffer_accessors_match_jax():
    px = _rs(12).standard_normal((5, 7, 4))
    got = buffer.ColorBuffer(torch.from_numpy(px), torch.tensor(3.0, dtype=torch.float64))
    want = jax_buffer.ColorBuffer(jnp.asarray(px), jnp.asarray(3.0))
    assert (got.width, got.height) == (want.width, want.height) == (7, 5)
    for x, y in ((0, 0), (6, 4), (3, 2)):
        np.testing.assert_array_equal(got.at(x, y).numpy(), np.asarray(want.at(x, y)))


def test_render_config_json_round_trip():
    cfg = RenderConfig(width=64, height=48, frames=3, scene="file:a.json", device="cpu", ckpt_dir="runs/a",
                       ckpt_every=2, metrics="m.jsonl", profile="prof", preview=True, serve=0, occupancy=True)
    assert RenderConfig.from_json(cfg.to_json()) == cfg
    assert json.loads(cfg.to_json())["serve"] == 0
    assert cfg.replace(frames=9).frames == 9 and cfg.frames == 3
    assert RenderConfig.from_json(RenderConfig().to_json()) == RenderConfig()
    for name in ("kernel", "tile_rows", "tiling", "rng", "unroll"):  # the TPU's execution fields
        assert not hasattr(RenderConfig(), name)


# (c) metrics and the profiler hook


def test_metrics_match_jax(tmp_path):
    times = [812.5, 3.25, 2.75, 3.0]
    logs = []
    for mod in (metrics, jax_metrics):
        log = mod.MetricsLog()
        for ms in times:
            log.record(mod.FrameMetrics(64, 48, 2, 4, ms))
        logs.append(log)
    got, want = logs
    assert [m.to_dict() for m in got.frames] == [m.to_dict() for m in want.frames]
    assert got.summary() == want.summary() and got.summary()["avg_frame_ms"] == 3.0
    assert metrics.MetricsLog().summary() == jax_metrics.MetricsLog().summary() == {}
    assert metrics.FrameMetrics(4, 4, 1, 1, 0.0).rays_per_s == 0.0
    got.dump_jsonl(str(tmp_path / "m.jsonl"))
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == [m.to_dict() for m in want.frames]
    assert metrics.Timer().stop() >= 0.0


def test_trace_to_writes_a_cpu_trace(tmp_path):
    with metrics.trace_to(None):
        pass
    with metrics.trace_to(str(tmp_path / "prof"), torch.device("cpu")):
        torch.ones(64).cumsum(0)
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name.endswith(".pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


# (d) the native runtime's binding, a mirror of tests/test_native.py


@pytest.fixture(scope="module")
def port_native():
    native, err = image.native_runtime()
    if native is None:
        pytest.skip(f"the native runtime does not build here (needs g++ and zlib): {err}")
    return native


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's binding of the same source, or None."""
    try:
        from pathtracer_tpu.utils import native
    except ImportError:
        return None
    return native


@pytest.fixture(scope="module")
def pixels():
    px = (_rs(7).random((41, 67, 4)) * 1.5).astype(np.float32)
    px[0, 0] = [np.nan, -1.0, 2.0, 0.5]  # NaN, negative, overbright
    px[1, 1] = [0.0, 1.0, 0.9999, 1.0]
    return px


def _decode(data: bytes, tmp_path) -> np.ndarray:
    path = tmp_path / "x.png"
    path.write_bytes(data)
    return image.read_png(str(path))


NATIVE_CASES = ("tonemap_gamma", "tonemap_linear", "encode_png", "tonemap_encode_png", "blit", "blit_edge",
                "save_render")


@pytest.mark.parametrize("case", NATIVE_CASES)
def test_native_runtime(case, port_native, jax_native, pixels, tmp_path):
    def run(native):
        if case == "tonemap_gamma":
            return native.tonemap_u8(pixels, True)
        if case == "tonemap_linear":
            return native.tonemap_u8(pixels, False)
        if case == "encode_png":
            return native.encode_png(native.tonemap_u8(pixels, True))
        if case == "tonemap_encode_png":
            return native.tonemap_encode_png(pixels, True)
        if case in ("blit", "blit_edge"):
            frame = np.zeros((60, 90, 4) if case == "blit" else (20, 20, 4), np.uint8)
            return native.blit_u8(pixels, frame, (11, 5) if case == "blit" else (10, 10))
        path = tmp_path / f"{native.__name__}.png"
        (image if native is port_native else jax_image).save_render(str(path), torch.from_numpy(pixels)
                                                                    if native is port_native else pixels)
        return path.read_bytes()

    got = run(port_native)
    if jax_native is not None:
        want = run(jax_native)
        assert (got == want) if isinstance(got, bytes) else np.array_equal(got, want)
    # and against the numpy versions
    if case == "tonemap_gamma":
        np.testing.assert_array_equal(got, buffer.to_u8(pixels))
    elif case == "tonemap_linear":
        np.testing.assert_array_equal(got, np.clip(np.nan_to_num(pixels.astype(np.float64)) * 255.0, 0, 255)
                                      .astype(np.uint8))
    elif case in ("encode_png", "tonemap_encode_png", "save_render"):
        np.testing.assert_array_equal(_decode(got, tmp_path), buffer.to_u8(pixels))
    elif case == "blit":
        want = buffer.blit_u8(np.nan_to_num(np.clip(pixels, 0, None)), np.zeros((60, 90, 4), np.uint8), (11, 5))
        np.testing.assert_array_equal(got, want)
    else:
        assert got[:10, :10].sum() == 0 and got[10:, 10:].any()


def test_native_builds_outside_its_source(port_native, pixels):
    path = port_native.library_path()
    assert path.exists() and path.is_relative_to(ROOT / "build" / "native")
    with pytest.raises(ValueError):  # no pointer to a buffer of another layout
        port_native.encode_png(pixels)
    with pytest.raises(ValueError):
        port_native.blit_u8(pixels[..., :3], np.zeros((8, 8, 4), np.uint8), (0, 0))


def test_save_render_names_the_numpy_encoder_when_the_runtime_fails(tmp_path, pixels, monkeypatch):
    monkeypatch.setattr(image, "native_runtime", lambda: (None, "no g++"))
    path = tmp_path / "x.png"
    assert image.save_render(str(path), pixels) == "numpy (native runtime unavailable: no g++)"
    np.testing.assert_array_equal(image.read_png(str(path)), buffer.to_u8(pixels))


# (e) the ANSI preview


@pytest.mark.parametrize("shape,max_cols,gamma", [((12, 16, 4), 100, True), ((37, 203, 4), 40, True),
                                                  ((30, 50, 3), 7, False), ((1, 8, 4), 100, True)])
def test_ansi_preview_is_the_jax_string(shape, max_cols, gamma):
    px = _rs(13).uniform(-0.2, 1.6, shape)
    px.flat[5] = np.nan
    got = image.ansi_preview(torch.from_numpy(px), max_cols=max_cols, gamma=gamma)
    assert got == jax_image.ansi_preview(px, max_cols=max_cols, gamma=gamma)
    assert (got == "") == (shape[0] < 2)


# (f) scene files


def _jax_scene(family, depth=4):
    return jax_sceneio._default_scene(family, jnp.float32, depth)


def _perturbed(desc: dict, seed: int) -> dict:
    """desc with the first entry of its first params leaf moved to a
    random float32 value."""
    out = json.loads(json.dumps(desc))
    path = next(iter(out["params"]))
    val = float(np.float32(_rs(seed).uniform(0.3, 0.9)))
    if isinstance(out["params"][path], list):
        out["params"][path][0] = val
    else:
        out["params"][path] = val
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_scene_to_dict_equals_jax(family):
    want = jax_sceneio.scene_to_dict(_jax_scene(family, 3), family)
    got = sceneio.scene_to_dict(make_family_scene(family, recursion_depth=3), family)
    assert got == want
    for section in ("params", "lights", "camera"):
        assert list(got[section]) == list(want[section])  # and in the same order
    moved = _perturbed(want, FAMILIES.index(family))
    assert moved != want
    got = sceneio.scene_to_dict(sceneio.scene_from_dict(moved), family)
    assert got == jax_sceneio.scene_to_dict(jax_sceneio.scene_from_dict(moved), family) == moved


@pytest.mark.parametrize("family", FAMILIES)
def test_scene_files_cross_between_the_packages(family, tmp_path):
    desc = _perturbed(jax_sceneio.scene_to_dict(_jax_scene(family), family), 20 + FAMILIES.index(family))
    jax_file, port_file = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jax_sceneio.save_scene(jax_sceneio.scene_from_dict(desc), jax_file, family)
    scene = sceneio.load_scene(jax_file, recursion_depth=2)
    assert scene.recursion_depth == 2
    sceneio.save_scene(sceneio.load_scene(jax_file), port_file, family)
    assert json.loads(pathlib.Path(port_file).read_text()) == desc
    assert jax_sceneio.scene_to_dict(jax_sceneio.load_scene(port_file), family) == desc


def test_partial_scene_dict_keeps_the_family_defaults():
    desc = {"family": "analytical", "params": {".sphere_radius": [0.25, 1.0]}, "lights": {".emission.x": [9.0]}}
    got = sceneio.scene_to_dict(sceneio.scene_from_dict(desc), "analytical")
    assert got == jax_sceneio.scene_to_dict(jax_sceneio.scene_from_dict(desc), "analytical")
    with pytest.raises(KeyError):  # static topology is no leaf of a file
        sceneio.scene_from_dict({"family": "mesh", "params": {".tri_mat": [0] * 20}})


@pytest.mark.parametrize("family", FAMILIES)
def test_cli_renders_a_scene_file_as_the_scene_itself(family, tmp_path):
    desc = _perturbed(sceneio.scene_to_dict(make_family_scene(family), family), 30)
    scene = sceneio.scene_from_dict(desc, recursion_depth=2)
    path = tmp_path / "scene.json"
    sceneio.save_scene(scene, str(path), family)
    cfg, _ = cli.parse_args(["--scene", f"file:{path}", "--device", "cpu", "--width", "8", "--height", "6",
                             "--frames", "2", "--depth", "2"])
    got = cli.render(cfg, str(tmp_path / "a.png"), log=lambda s: None)
    buf, key = buffer.new_buffer(8, 6), rng.prng_key(0)
    for _ in range(2):
        key, sub = rng.split(key)
        buf = buffer.ColorBuffer(*accumulate(buf.pixels, render_frame_megakernel(scene, sub, 8, 6), buf.frames))
    assert torch.equal(got.pixels, buf.pixels) and float(got.frames) == 2.0


# (g) the camera's controls, float64, atol 1e-12


def _cams():
    port = camera.default_pinhole(torch.float64)
    jax = jax_camera.default_pinhole(jnp.float64)
    o = (0.7, -1.2, 2.5)
    return [(port, jax), (port.set(vm.v3(*o, dtype=torch.float64), vm.v3(0.1, 0.2, -0.3, dtype=torch.float64)),
                          jax.set(jax_vm.v3(*o, dtype=jnp.float64), jax_vm.v3(0.1, 0.2, -0.3, dtype=jnp.float64)))]


def _same_cam(got, want):
    for g, w in zip((*got.origin, *got.center, got.fov), (*want.origin, *want.center, want.fov)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


@pytest.mark.parametrize("which", [0, 1])
def test_camera_controls_match_jax(which):
    port, jax = _cams()[which]
    for dyaw in np.linspace(-3.5, 3.5, 8):
        for dpitch in (-2.0, -0.7, 0.0, 0.3, 1.6):
            _same_cam(camera.orbit(port, float(dyaw), dpitch), jax_camera.orbit(jax, float(dyaw), dpitch))
    for factor in (1e-5, 0.1, 0.5, 1.0, 2.5, 40.0):
        _same_cam(camera.zoom(port, factor), jax_camera.zoom(jax, factor))
    for fov in (20.0, 80.0, 135.5):
        _same_cam(port.set_fov(fov), jax.set_fov(fov))
    _same_cam(port.set_fov(port.fov + 5.0), jax.set_fov(float(jax.fov) + 5.0))
    _same_cam(port.set(port.center, port.origin), jax.set(jax.center, jax.origin))


# (h) a render of the JAX CLI resumed in the port's CLI; (i) the port's own resume


def test_jax_render_checkpoint_resumes_in_the_port(tmp_path):
    ck = tmp_path / "ck"
    ck.mkdir()
    shutil.copy(JAX_CKPT / "ckpt_000002.npz", ck)
    with np.load(JAX_CKPT / "ckpt_000002.npz") as data:
        assert data["leaf_0"].dtype == np.float64 and data["leaf_2"].dtype == np.uint32
    lines = []
    cfg, _ = cli.parse_args(["--device", "cpu", "--width", "16", "--height", "12", "--depth", "2", "--precision",
                             "f64", "--frames", "4", "--ckpt-dir", str(ck), "--ckpt-every", "2"])
    buf = cli.render(cfg, str(tmp_path / "a.png"), log=lines.append)
    assert lines[0] == f"resumed from {ck / 'ckpt_000002.npz'} at frame 2"
    assert [x.split()[1] for x in lines if x.startswith("frame ")] == ["3/4", "4/4"]
    with np.load(JAX_CKPT / "ckpt_000004.npz") as want:
        np.testing.assert_allclose(buf.pixels.numpy(), want["leaf_0"], rtol=1e-9, atol=1e-11)
        assert float(buf.frames) == float(want["leaf_1"]) == 4.0
        state = checkpoint.load_render_state(str(ck / "ckpt_000004.npz"), (buf, rng.prng_key(0), 0))
        np.testing.assert_array_equal(state[1].numpy(), want["leaf_2"].astype(np.int64))
        assert state[2] == int(want["leaf_3"]) == 4


def test_render_state_from_jax_refuses_other_structures(tmp_path):
    like = (buffer.new_buffer(16, 12, torch.float64), rng.prng_key(0), 0)
    buf, key, frame = checkpoint.render_state_from_jax(str(JAX_CKPT / "ckpt_000002.npz"), like)
    assert isinstance(buf, buffer.ColorBuffer) and key.dtype == torch.int64 and frame == 2
    with pytest.raises(ValueError, match="float64"):
        checkpoint.render_state_from_jax(str(JAX_CKPT / "ckpt_000002.npz"), (buffer.new_buffer(16, 12),) + like[1:])
    other = tmp_path / "other.npz"
    with np.load(JAX_CKPT / "ckpt_000002.npz") as data:
        payload = dict(data)
    payload["__treedef__"] = np.frombuffer(json.dumps("PyTreeDef((*, *, *, *))").encode(), np.uint8)
    np.savez(other, **payload)
    with pytest.raises(ValueError, match="not a JAX render checkpoint"):
        checkpoint.render_state_from_jax(str(other), like)
    checkpoint.save_checkpoint(str(other), like)  # the port's own
    with pytest.raises(ValueError, match="no JAX tree"):
        checkpoint.render_state_from_jax(str(other), like)


def test_port_resume_is_the_straight_run_bit_for_bit(tmp_path):
    args = ["--device", "cpu", "--width", "12", "--height", "8", "--depth", "2", "--seed", "5"]
    straight = cli.render(cli.parse_args(args + ["--frames", "4"])[0], str(tmp_path / "s.png"), log=lambda s: None)
    ck = str(tmp_path / "ck")
    first = cli.parse_args(args + ["--frames", "2", "--ckpt-dir", ck, "--ckpt-every", "2"])[0]
    cli.render(first, str(tmp_path / "a.png"), log=lambda s: None)
    lines = []
    resumed = cli.render(first.replace(frames=4), str(tmp_path / "b.png"), log=lines.append)
    assert lines[0].endswith("at frame 2") and sorted(os.listdir(ck)) == ["ckpt_000002.npz", "ckpt_000004.npz"]
    assert torch.equal(resumed.pixels, straight.pixels) and float(resumed.frames) == 4.0
    assert image.read_png(str(tmp_path / "b.png")).tobytes() == image.read_png(str(tmp_path / "s.png")).tobytes()


def test_cli_metrics_profile_and_preview(tmp_path, capsys):
    out = tmp_path / "m.jsonl"
    lines = []
    cfg, _ = cli.parse_args(["--device", "cpu", "--width", "8", "--height", "6", "--depth", "1", "--frames", "3",
                             "--metrics", str(out), "--profile", str(tmp_path / "prof"), "--preview"])
    buf = cli.render(cfg, str(tmp_path / "a.png"), log=lines.append)
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(rows) == 3 and all(r["width"] == 8 and r["rays"] == 48 for r in rows)
    assert lines[-1].startswith("avg ") and "Mrays/s" in lines[-1]
    assert len(list((tmp_path / "prof").iterdir())) == 1
    shown = capsys.readouterr().out
    assert shown.startswith("\x1b[H\x1b[2J") and shown.count("\x1b[H") == 3
    assert image.ansi_preview(buf.pixels) in shown


# (l) the prelude


def test_prelude_covers_the_jax_names():
    public = {n for n in dir(pathtracer_tpu) if not n.startswith("_")} - {"integrator", "models", "ops", "oracle",
                                                                          "parallel", "utils"}
    missing = {n for n in public if not hasattr(pathtracer_tpu_torch, n)}
    assert missing == set(NOT_PORTED)
    assert not any(hasattr(pathtracer_tpu_torch, n) for n in NOT_PORTED)
    for name in ("render_frame_megakernel", "measure_occupancy_megakernel", "render_frame_reference"):
        assert callable(getattr(pathtracer_tpu_torch, name))


@pytest.mark.slow
def test_jax_checkpoint_fixture_is_what_the_jax_cli_writes(tmp_path):
    write_jax_checkpoints(tmp_path)
    for name in ("ckpt_000002.npz", "ckpt_000004.npz"):
        with np.load(tmp_path / name) as got, np.load(JAX_CKPT / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for f in got.files:
                np.testing.assert_array_equal(got[f], want[f], err_msg=f"{name} {f}")


def write_jax_checkpoints(directory) -> None:
    """Run the JAX render CLI that wrote JAX_CKPT, into `directory`."""
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(ROOT / "app" / "render.py"), *JAX_CLI_ARGS, "--ckpt-dir", str(directory),
                    "-o", str(pathlib.Path(directory) / "render.png")], check=True, env=env, cwd=ROOT,
                   capture_output=True)
    os.unlink(pathlib.Path(directory) / "render.png")


if __name__ == "__main__":
    write_jax_checkpoints(JAX_CKPT)
