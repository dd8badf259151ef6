"""The port's CLI and host utilities, and the package's import rule."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from pathtracer_tpu.utils import buffer as jax_buffer
from pathtracer_tpu_torch.app import render as cli
from pathtracer_tpu_torch.utils import buffer, image

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "pathtracer_tpu_torch"


def test_cli_renders_png_on_cpu(tmp_path):
    out = tmp_path / "frame.png"
    assert cli.main(["--width", "32", "--height", "24", "--frames", "2", "--depth", "2", "-o", str(out)]) == 0
    png = image.read_png(str(out))
    assert png.shape == (24, 32, 4) and png.dtype == np.uint8
    assert (png[..., 3] == 255).all() and png[..., :3].max() > 0


def test_cli_render_accumulates_frames(tmp_path):
    cfg, _ = cli.parse_args(["--width", "16", "--height", "8", "--frames", "3", "--precision", "f64"])
    buf = cli.render(cfg, str(tmp_path / "a.png"), log=lambda s: None)
    assert buf.pixels.dtype == torch.float64 and float(buf.frames) == 3.0
    assert torch.isfinite(buf.pixels).all()


def test_cli_cuda_without_cuda_fails(tmp_path, monkeypatch):
    # --device cuda never falls back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(["--device", "cuda", "--frames", "1", "-o", str(tmp_path / "x.png")])


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
