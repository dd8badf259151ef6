"""Per-frame metrics, the profiler hook of the render CLI, and the
program's spans.

Port of `pathtracer_tpu/utils/metrics.py`: `FrameMetrics` (primary rays/s,
spp/s, frame ms), `MetricsLog` (its summary leaves the first frame, which
pays the kernels' load, out of the steady state; JSON lines) and `Timer`.
`trace_to` records a Chrome trace with `torch.profiler` in place of
`jax.profiler`.

`Span` times one phase of the program on the host clock: a `with` block
adds its nanoseconds to the span's running `seconds` and one to its
`calls`, also when the block raises. Each span is made once, when the
module that records it is imported, and is registered by name in
`SPANS` (`SPANS.k1_pack`), where a reader finds it by a dotted path
(`pathtracer_tpu_torch.utils.metrics:SPANS.k1_pack.seconds`); nothing
resets it, so a reader takes the difference of two readings. The spans:
`k1_keys`, `k1_pack` (`ops/megakernel.prepare_launch`), `k1_enqueue`
(`launch`), `k2_wrapper` (`launch_backward`), `step_forward`,
`step_backward`, `step_adam` (`integrator/inverse.paired_step`).

The program's counters are attributes of the functions that count, read
the same way (`pathtracer_tpu_torch.ops.megakernel:prepare_launch.packs`):
`render_frame_megakernel.launches` and its kin (the kernels' launches,
`record_bytes`), `prepare_launch.packs` and `.pack_reuses` (scenes packed,
and packed vectors used again, `ops/megakernel.packed_scene`),
`bigmesh_tables.builds`, and the reads of the card that make the host wait:
`scene_media.device_reads`, `vecmath.maximum.device_reads` and
`minimum.device_reads`.

While a `torch.profiler` runs, a span also opens a `record_function`
range named `pt.<name>`, on the profiler's clock beside the card's
activity, so a trace shows which phase the host was in while the card
idled: the render CLI's `--profile` trace shows the K1 wrapper's phases
within each frame. Without a profiler it opens none: a range costs more
than a span's whole work, a check and two clock reads, and a frame holds
three spans. A span is not reentrant: one block at a time, from one
thread at a time.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

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


# Every Span by name (Span registers itself)
SPANS = SimpleNamespace()
_profiling = torch._C._autograd._profiler_enabled  # whether a profiler runs, on this thread


class Span:
    """A phase of the program on the host clock: `seconds` and `calls`,
    running totals over the process; registered in SPANS under `name`, an
    identifier."""

    __slots__ = ("name", "label", "seconds", "calls", "_start", "_range")

    def __init__(self, name: str):
        if not name.isidentifier() or hasattr(SPANS, name):
            raise ValueError(f"a span's name is a new identifier, got {name!r}")
        self.name, self.label = name, f"pt.{name}"
        self.seconds, self.calls = 0.0, 0
        self._start, self._range = 0, None
        setattr(SPANS, name, self)

    def __enter__(self) -> "Span":
        if _profiling():
            self._range = torch.profiler.record_function(self.label)
            self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds += (time.perf_counter_ns() - self._start) * 1e-9
        self.calls += 1
        opened, self._range = self._range, None
        if opened is not None:
            opened.__exit__(*exc)
