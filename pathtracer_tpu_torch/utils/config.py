"""Render configuration of the port's CLI.

Port of `pathtracer_tpu/utils/config.py`, with the fields the port's CLI
uses: the device in place of the TPU execution fields, the host
surface's (checkpoints, metrics, profiler, preview, viewer), and the rank
mesh of a sharded render (`--mesh TILESxSPP`). JSON round trips it for
reproducible runs.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from ..integrator.tracer import FIXED, VERBATIM, Quirks


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800
    height: int = 600
    spp: int = 1
    frames: int = 16
    depth: int = 4
    seed: int = 0
    precision: str = "f32"  # "f32" | "f64"
    quirks: str = "verbatim"  # "verbatim" | "fixed"
    device: str = "cuda"  # as the CLI; the eager integrator on the CPU with "cpu"
    scene: str = "analytical"  # a family of models/families, or file:PATH
    occupancy: bool = False  # print the alive-lane fraction per bounce first
    ckpt_dir: str | None = None  # checkpoint/resume directory
    ckpt_every: int = 8  # frames between checkpoints
    metrics: str | None = None  # per-frame metrics as JSON lines
    profile: str | None = None  # torch.profiler Chrome trace directory
    preview: bool = False  # ANSI repaint of the buffer each frame
    serve: int | None = None  # live viewer's HTTP port (0: a free one)
    mesh_tiles: int = 1  # the rank mesh's tile axis (>1: a sharded render over torch.distributed)
    mesh_spp: int = 1  # its sample axis (the render CLI flattens both into the pixel axis)
    backend: str | None = None  # the collectives' backend (nccl | gloo), None: the layout's choice

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.precision == "f64" else torch.float32

    @property
    def quirk_flags(self) -> Quirks:
        return VERBATIM if self.quirks == "verbatim" else FIXED

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RenderConfig":
        return cls(**json.loads(s))

    @property
    def sharded(self) -> bool:
        return self.mesh_tiles * self.mesh_spp > 1

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
