"""K1's and K2's work on the analytical scene (chip_smoke.py:2654-2655,
2754 and 2960-2963): a ray segment's operations; the scene's leaves and the
frame's bytes (`roofline.py`)."""
from portbench.roofline import CAMERA_F64_OPS, K1_OPS, K2_OPS


def k1(work: dict, pixels: int, scene_scalars: int) -> tuple[float, float, float]:
    """(float32 operations, float64 operations, bytes) of one frame."""
    segs, nbytes = work["segments"], scene_scalars * 4 + pixels * 16
    camera = pixels * CAMERA_F64_OPS
    return segs * K1_OPS["f32"], segs * K1_OPS["f64"] + camera, nbytes


def k2(work: dict, pixels: int, scene_scalars: int) -> tuple[float, float, float]:
    """(float32 operations, float64 operations, bytes) of one gradient: the
    forward once and its adjoint; the scene read and its gradient
    written, the cotangent read."""
    segs, nbytes = work["segments"], scene_scalars * 8 + pixels * 16
    camera = pixels * CAMERA_F64_OPS
    return segs * K2_OPS["f32"], segs * K2_OPS["f64"] + camera, nbytes
