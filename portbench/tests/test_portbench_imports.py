"""Nothing the benchmark runs imports JAX or the JAX package, and its plain
reference imports nothing of the port. Each import's top-level name, the
part before the first dot, is compared whole: `pathtracer_tpu_torch`
begins with `pathtracer_tpu` and is not it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pathtracer_tpu"}
PORT = "pathtracer_tpu_torch"


def top_level_imports(path: Path) -> set:
    """The top-level names of the absolute imports of a Python file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def modules(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def test_top_level_names_are_compared_whole():
    assert "pathtracer_tpu_torch.ops".split(".")[0] not in FORBIDDEN
    assert "pathtracer_tpu.ops".split(".")[0] in FORBIDDEN
    tree = ast.parse("import pathtracer_tpu_torch.ops\nfrom jax import numpy\nfrom . import x\n")
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    assert found == {"pathtracer_tpu_torch", "jax"}


@pytest.mark.parametrize("path", modules(HERE), ids=lambda p: str(p.relative_to(HERE)))
def test_benchmark_module_imports_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", modules(HERE / "reference"), ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {PORT, "portbench"}), names


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a small size (the harness, the port, the
    reference, a traced window), then sys.modules by top-level name."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "r, _ = harness.run('analytical.frames', 7, 0.3, True, time.perf_counter(), device='cpu', size=(16, 8))\n"
        "assert r['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r), harness.forbidden_modules())\n"
    ) % (str(ROOT), FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_forbidden_modules_reads_whole_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "pathtracer_tpu_torch_extra_for_test", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]
