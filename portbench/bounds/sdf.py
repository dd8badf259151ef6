"""K1's and K2's work on the SDF scene (chip_smoke.py:2852-2856 and
2960-2963): a march step's and a segment's operations, the SDF adjoint of
a hit in place of the analytical one's; the scene's leaves and the frame's
bytes (`roofline.py`)."""
from portbench.roofline import (ANALYTICAL_HIT_ADJ_F32, CAMERA_F64_OPS, K2_ADJ_OPS, SDF_ADJ_OPS, SDF_SEGMENT_OPS,
                                SDF_STEP_OPS)


def k1(work: dict, pixels: int, scene_scalars: int) -> tuple[float, float, float]:
    """(float32 operations, float64 operations, bytes) of one frame."""
    segs, nbytes = work["segments"], scene_scalars * 4 + pixels * 16
    camera = pixels * CAMERA_F64_OPS
    return (work["march_steps"] * SDF_STEP_OPS + segs * SDF_SEGMENT_OPS["f32"],
            segs * SDF_SEGMENT_OPS["f64"] + camera, nbytes)


def k2(work: dict, pixels: int, scene_scalars: int) -> tuple[float, float, float]:
    """(float32 operations, float64 operations, bytes) of one gradient."""
    segs, nbytes = work["segments"], scene_scalars * 8 + pixels * 16
    camera = pixels * CAMERA_F64_OPS
    f32 = work["march_steps"] * SDF_STEP_OPS + segs * (
        SDF_SEGMENT_OPS["f32"] + K2_ADJ_OPS["f32"] - ANALYTICAL_HIT_ADJ_F32 + SDF_ADJ_OPS)
    return f32, segs * SDF_SEGMENT_OPS["f64"] + camera, nbytes
