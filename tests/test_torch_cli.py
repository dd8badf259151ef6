"""The port's CLI and host utilities, and the package's import rule."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from pathtracer_tpu.utils import buffer as jax_buffer
from pathtracer_tpu_torch.app import invert
from pathtracer_tpu_torch.app import render as cli
from pathtracer_tpu_torch.utils import buffer, image
from pathtracer_tpu_torch.utils.config import RenderConfig
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "pathtracer_tpu_torch"


def test_cli_renders_png_on_cpu(tmp_path):
    out = tmp_path / "frame.png"
    assert cli.main(["--device", "cpu", "--width", "32", "--height", "24", "--frames", "2", "--depth", "2",
                     "-o", str(out)]) == 0
    png = image.read_png(str(out))
    assert png.shape == (24, 32, 4) and png.dtype == np.uint8
    assert (png[..., 3] == 255).all() and png[..., :3].max() > 0


def test_cli_renders_the_sdf_scene_on_cpu(tmp_path):
    out = tmp_path / "sdf.png"
    cfg, output = cli.parse_args(["--scene", "sdf", "--device", "cpu", "--width", "32", "--height", "16",
                                  "--frames", "2", "--depth", "2", "-o", str(out)])
    buf = cli.render(cfg, output, log=lambda s: None)
    assert torch.isfinite(buf.pixels).all() and float(buf.frames) == 2.0
    png = image.read_png(str(out))
    assert png.shape == (16, 32, 4) and png[..., :3].max() > 0
    assert cli.parse_args(["--scene", "sdf"])[0].device == "cuda"


@pytest.mark.parametrize("scene", ["mesh", "bigmesh"])
def test_cli_renders_the_mesh_scenes_on_cpu(tmp_path, scene):
    out = tmp_path / f"{scene}.png"
    cfg, output = cli.parse_args(["--scene", scene, "--device", "cpu", "--width", "32", "--height", "16",
                                  "--frames", "2", "--depth", "2", "-o", str(out)])
    buf = cli.render(cfg, output, log=lambda s: None)
    assert torch.isfinite(buf.pixels).all() and float(buf.frames) == 2.0
    png = image.read_png(str(out))
    assert png.shape == (16, 32, 4) and png[..., :3].max() > 0
    assert cli.parse_args(["--scene", scene])[0].device == "cuda"


def test_cli_refuses_unported_scenes(tmp_path):
    with pytest.raises(FileNotFoundError):  # a scene file that is not there
        cli.main(["--scene", f"file:{tmp_path / 'scene.json'}", "--device", "cpu", "--frames", "1",
                  "-o", str(tmp_path / "x.png")])
    with pytest.raises(SystemExit):
        cli.main(["--scene", "teapot", "--device", "cpu", "--frames", "1", "-o", str(tmp_path / "x.png")])


def test_cli_render_accumulates_frames(tmp_path):
    cfg, _ = cli.parse_args(["--device", "cpu", "--width", "16", "--height", "8", "--frames", "3",
                             "--precision", "f64"])
    buf = cli.render(cfg, str(tmp_path / "a.png"), log=lambda s: None)
    assert buf.pixels.dtype == torch.float64 and float(buf.frames) == 3.0
    assert torch.isfinite(buf.pixels).all()


def test_cli_cuda_without_cuda_fails(tmp_path, monkeypatch):
    # --device cuda never falls back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(["--device", "cuda", "--frames", "1", "-o", str(tmp_path / "x.png")])


def test_cli_defaults_to_the_card():
    cfg, _ = cli.parse_args([])
    assert cfg.device == "cuda"
    args = invert.parse_args([])
    assert (args.device, args.width, args.height, args.steps, args.spp, args.lr, args.depth) == (
        "cuda", 256, 192, 80, 1, 3e-2, 4)


def test_render_config_defaults_to_the_card(tmp_path, monkeypatch):
    """RenderConfig, as the CLI, renders on the card unless asked for the
    CPU, and without CUDA fails rather than falling back."""
    assert RenderConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.render(RenderConfig(width=8, height=8, frames=1), str(tmp_path / "x.png"), log=lambda s: None)


def test_invert_cli_on_cpu(tmp_path):
    out = tmp_path / "report.json"
    assert invert.main(["--device", "cpu", "--width", "16", "--height", "8", "--steps", "2", "--depth", "2",
                        "--ckpt-dir", str(tmp_path / "ck"), "--json-out", str(out)], log=lambda s: None) == 0
    report = json.loads(out.read_text())
    assert len(report["losses"]) == 2 and np.isfinite(report["losses"]).all()
    assert [r["name"] for r in report["rows"]][:1] == ["params.materials.rgb.x[0]"] and len(report["rows"]) == 15
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["invert_000002.npz"]


def test_invert_cli_recovers_the_sdf_geometry_on_cpu(tmp_path, one_torch_thread):
    out = tmp_path / "report.json"
    assert invert.main(["--scene", "sdf", "--device", "cpu", "--width", "16", "--height", "8", "--steps", "2",
                        "--depth", "2", "--ckpt-dir", str(tmp_path / "ck"), "--json-out", str(out)],
                       log=lambda s: None) == 0
    report = json.loads(out.read_text())
    assert len(report["losses"]) == 2 and np.isfinite(report["losses"]).all()
    assert [r["name"] for r in report["rows"]] == [
        "params.sphere_radius[0]", "params.torus_major[0]", "lights.emission.x[0]", "lights.emission.y[0]",
        "lights.emission.z[0]"]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["invert_000002.npz"]


def test_invert_cli_scene_choices():
    assert invert.parse_args(["--scene", "sdf"]).scene == "sdf"
    assert (invert.parse_args([]).scene, invert.parse_args(["--scene", "sdf"]).device) == ("analytical", "cuda")
    with pytest.raises(SystemExit):
        invert.parse_args(["--scene", "teapot"])
    with pytest.raises(SystemExit):  # no mesh demo: the JAX CLI has none (inverse_render trains a mesh)
        invert.parse_args(["--scene", "mesh"])


def test_invert_cli_cuda_without_cuda_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        invert.main(["--steps", "1"])


def test_u8_conversions_match_jax():
    rs = np.random.default_rng(0)
    px = rs.uniform(-0.2, 1.5, (5, 7, 4))
    px[0, 0, 0] = np.nan
    np.testing.assert_array_equal(buffer.to_u8(torch.from_numpy(px)), jax_buffer.to_u8(px))
    # blit_u8 keeps the reference's missing gamma encode
    px = np.nan_to_num(px)
    a = jax_buffer.blit_u8(px, np.zeros((9, 12, 4), np.uint8), (2, 1))
    b = buffer.blit_u8(torch.from_numpy(px), np.zeros((9, 12, 4), np.uint8), (2, 1))
    np.testing.assert_array_equal(a, b)


def test_png_roundtrip(tmp_path):
    u8 = np.random.default_rng(1).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    image.write_png(path, u8)
    np.testing.assert_array_equal(image.read_png(path), u8)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_package_never_imports_jax():
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "pathtracer_tpu"), f"{path.name} imports {mod}"
