"""Render configuration of the port's CLI.

Port of `pathtracer_tpu/utils/config.py`, cut to the fields the CLI uses.
"""

from __future__ import annotations

import dataclasses

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
    device: str = "cpu"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.precision == "f64" else torch.float32

    @property
    def quirk_flags(self) -> Quirks:
        return VERBATIM if self.quirks == "verbatim" else FIXED
