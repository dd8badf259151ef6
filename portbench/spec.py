"""The benchmark's description, and each cell resolved from it by name.

`BENCHMARK.json` at the root of the checkout names the cells
(`workloads`), their configurations and traffic mixes, and the metrics.
Everything that belongs to one configuration, one traffic mix, one cell
or one per-layer metric is a file of its own under `portbench/`, found by
that name, so a later change adds a cell, a scene, a mix or a metric by
adding files:

- `configs/<config>.json`: the scene description (the port's scene-file
  dict), its precision, its trainer's leaves, start scene and projection;
  its plain reference is `reference/<family>.py`;
- `traffic/<traffic>.json`: the mix's parameters (`kind`, the frame size,
  spp, ...), which `traffic.py` and the kind's driver read;
- `kinds/<kind>.py`: a traffic kind's driver (`DRIVER`, the class that
  drives the program: `drivers.py`'s or one of its own) and the
  comparison its outputs feed (`COMPARES`, "frames" or "train",
  `check.py`); a cell on several cards runs the driver on every rank
  (`ranks.py`);
- `checks/<cell>.json`: how many frames or steps the correctness check
  compares, the limit of each number it reads, and for an SDF trainer
  `grazing`, the |<rd, n>| below which a pixel is left out of
  `grad_gap_masked` (`check.py`);
- `metrics/<metric>.py`: the per-layer metric's reader, `read(run)`.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class Cell(NamedTuple):
    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    checks: dict  # checks/<cell>.json: "sample" frames or "steps", "limits": number -> limit; "grazing"
    end_to_end: list  # BENCHMARK.json's end-to-end entries this cell reports
    per_layer: list  # (entry, reader module) this cell reports with --trace 1
    chips: int
    kind: object  # kinds/<kind>.py of the traffic's kind: DRIVER, COMPARES


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    return load_json(path)


def named_file(root: Path, folder: str, name: str, suffix: str) -> Path:
    """portbench/<folder>/<name><suffix>; a name outside the allowed
    characters, or a file that is not there, raises."""
    if not NAME.fullmatch(name):
        raise ValueError(f"bad name {name!r}")
    path = root / "portbench" / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(root)} for {name!r}")
    return path


def load_module(root: Path, folder: str, name: str):
    """portbench/<folder>/<name>.py, loaded as a module of its own."""
    path = named_file(root, folder, name, ".py")
    module_name = f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(root: Path, name: str):
    """The per-layer metric `name`'s reader module (metrics/<name>.py)."""
    module = load_module(root, "metrics", name)
    if not callable(getattr(module, "read", None)):
        raise ValueError(f"portbench/metrics/{name}.py has no read(run)")
    return module


def kinds(root: Path = ROOT) -> list[str]:
    """The traffic kinds that have a driver (kinds/<kind>.py)."""
    return sorted(p.stem for p in (root / "portbench" / "kinds").glob("*.py"))


def kind(root: Path, name: str):
    """The traffic kind `name`'s module (kinds/<name>.py): its DRIVER and
    what it COMPARES."""
    module = load_module(root, "kinds", name)
    if getattr(module, "COMPARES", None) not in ("frames", "train") or not callable(getattr(module, "DRIVER", None)):
        raise ValueError(f"portbench/kinds/{name}.py has no DRIVER or COMPARES (frames or train)")
    return module


def reports(entry: dict, cell: str) -> bool:
    """Whether a metric entry applies to the cell: every cell, or those its
    `workloads` lists."""
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(cell: str, root: Path = ROOT) -> Cell:
    """The cell named `cell` with its configuration, traffic, checks and
    metrics read from their files."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json (have {sorted(entries)})")
    w = entries[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(named_file(root, "traffic", w["traffic"], ".json"))
    checks = load_json(named_file(root, "checks", cell, ".json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, cell)]
    layers = [(m, reader(root, m["name"])) for m in bench["per_layer"] if reports(m, cell)]
    return Cell(cell, config, traffic, checks, e2e, layers, int(w["chips"]), kind(root, traffic["kind"]))
