"""The frozen roofline arithmetic: the H100's peaks, the operations a ray
segment and a march step cost, and the least time a kernel could take.

Copied from `chip_smoke.py`, with the line each constant came from, so a
kernel's roofline reads the same work whatever implements it. The
operation counts were read from the CUDA code for the demo scenes (one
light, three primitives) on the shading path (the comments at
`chip_smoke.py:402-450` say how); the work they multiply (segments, march
steps) is counted by the benchmark's own plain reference on the run's
inputs (`reference/work.py`). Bytes count each input once and each output
once: the scene's leaves (float32; K2 reads them and writes their
gradient) and the frame (K1 writes it, K2 reads its cotangent). Each
family's K1 and K2 arithmetic is a file of its own (`bounds/<family>.py`),
so a family's counts come as a new file; a family without one has no
bound, and its rooflines read nothing.
"""

from __future__ import annotations

from pathlib import Path

from . import spec

# chip_smoke.py:402: float32 and float64 outside the tensor cores, device
# memory (NVIDIA's data sheet for the H100 SXM at 700 W)
PEAK_F32, PEAK_F64, PEAK_BYTES = 67e12, 34e12, 3.35e12
# chip_smoke.py:403: 32-bit integer operations, 64 a clock an SM on 132 SMs
# at the 1,980 MHz boost clock
PEAK_I32 = 64 * 132 * 1.98e9
# chip_smoke.py:420-421: K1's operations a ray segment, and K2's adjoint's
K1_OPS = dict(f32=1430, f64=100)
K2_ADJ_OPS = dict(f32=2560, f64=45)
# chip_smoke.py:422-423: K2's bound counts the forward and the adjoint once;
# the analytical closest hit's share of the adjoint
K2_OPS = dict(f32=K1_OPS["f32"] + K2_ADJ_OPS["f32"], f64=K1_OPS["f64"] + K2_ADJ_OPS["f64"])
ANALYTICAL_HIT_ADJ_F32 = 100
# chip_smoke.py:424: each camera ray's float64 operations, a pixel
CAMERA_F64_OPS = 30
# chip_smoke.py:437-438: the SDF backend's operations a march step and a
# segment (K1's shading without the analytical hit, the normal, the hit
# tests, the argmin and the checker; the light test in float64)
SDF_STEP_OPS = 75
SDF_SEGMENT_OPS = dict(f32=1370 + 130 + 190, f64=20)
# chip_smoke.py:449: the SDF adjoint of one hit
SDF_ADJ_OPS = 130 + 330 + 250 + 110


def bound_of(f32_ops: float, f64_ops: float, nbytes: float, i32_ops: float = 0) -> float:
    """The least time the card could take, ms: the larger of the operations
    over their type's peak and the bytes over the memory rate
    (chip_smoke.py:638)."""
    t_ops = f32_ops / PEAK_F32 + f64_ops / PEAK_F64 + i32_ops / PEAK_I32
    return max(t_ops, nbytes / PEAK_BYTES) * 1e3


def counts_of(family: str, root: Path = spec.ROOT):
    """The family's frozen K1 and K2 counts (`bounds/<family>.py`: `k1` and
    `k2`, each (work, pixels, scene_scalars) -> (float32 operations,
    float64 operations, bytes)), or None where it has none."""
    try:
        return spec.load_module(root, "bounds", family)
    except FileNotFoundError:
        return None


def bound_ms(kernel: str, family: str, work: dict, pixels: int, scene_scalars: int,
             root: Path = spec.ROOT) -> float | None:
    """The bound, ms, of one launch of `kernel` ("k1": a frame; "k2": a
    gradient) on the family's scene; None for a family without frozen
    counts."""
    counts = counts_of(family, root)
    return None if counts is None else bound_of(*getattr(counts, kernel)(work, pixels, scene_scalars))
