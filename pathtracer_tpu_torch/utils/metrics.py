"""Per-frame metrics and the profiler hook of the render CLI.

Port of `pathtracer_tpu/utils/metrics.py`: `FrameMetrics` (primary rays/s,
spp/s, frame ms), `MetricsLog` (its summary leaves the first frame, which
pays the kernels' load, out of the steady state; JSON lines) and `Timer`.
`trace_to` records a Chrome trace with `torch.profiler` in place of
`jax.profiler`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile


@dataclass
class FrameMetrics:
    width: int
    height: int
    spp: int
    depth: int
    frame_ms: float

    @property
    def rays(self) -> int:
        """Primary rays of the frame."""
        return self.width * self.height * self.spp

    @property
    def rays_per_s(self) -> float:
        return self.rays / (self.frame_ms / 1e3) if self.frame_ms > 0 else 0.0

    @property
    def spp_per_s(self) -> float:
        return self.spp / (self.frame_ms / 1e3) if self.frame_ms > 0 else 0.0

    def to_dict(self) -> dict:
        return dict(
            width=self.width,
            height=self.height,
            spp=self.spp,
            depth=self.depth,
            frame_ms=self.frame_ms,
            rays=self.rays,
            rays_per_s=self.rays_per_s,
            spp_per_s=self.spp_per_s,
        )


@dataclass
class MetricsLog:
    """Per-frame metrics in order; one JSON line each."""

    frames: list = field(default_factory=list)

    def record(self, m: FrameMetrics) -> None:
        self.frames.append(m)

    def summary(self) -> dict:
        if not self.frames:
            return {}
        ms = [f.frame_ms for f in self.frames]
        steady = ms[1:] if len(ms) > 1 else ms  # the first frame loads the kernels
        avg_ms = sum(steady) / len(steady)
        last = self.frames[-1]
        return dict(
            frames=len(ms),
            first_frame_ms=ms[0],
            avg_frame_ms=avg_ms,
            rays_per_s=last.rays / (avg_ms / 1e3),
            spp_per_s=last.spp / (avg_ms / 1e3),
        )

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for m in self.frames:
                f.write(json.dumps(m.to_dict()) + "\n")


class Timer:
    """Wall-clock milliseconds; stop() after the device has synchronized."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3


@contextlib.contextmanager
def trace_to(log_dir: str | None, device=None):
    """Record the enclosed work with torch.profiler and write a Chrome trace
    (`render_<pid>_<ns>.pt.trace.json`) into `log_dir`: the CPU and CUDA
    activities for a CUDA `device`, the CPU's alone otherwise. With
    log_dir None, nothing."""
    if log_dir is None:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"render_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
