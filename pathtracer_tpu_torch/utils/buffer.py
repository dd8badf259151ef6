"""ColorBuffer: the progressive accumulation target.

Port of `pathtracer_tpu/utils/buffer.py`. The buffer is an [H, W, 4]
tensor on the render device plus a frame count; `integrator.accumulate`
folds each frame in as a running mean. u8 conversion gamma-encodes RGB
with ^0.4545 and keeps alpha linear.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ColorBuffer(NamedTuple):
    pixels: torch.Tensor  # [H, W, 4] linear RGBA
    frames: torch.Tensor  # 0-d frame count

    @property
    def width(self) -> int:
        return int(self.pixels.shape[1])

    @property
    def height(self) -> int:
        return int(self.pixels.shape[0])

    def at(self, x: int, y: int) -> torch.Tensor:
        """The pixel at column x, row y."""
        return self.pixels[y, x]


def new_buffer(width: int, height: int, dtype=torch.float32, device=None) -> ColorBuffer:
    return ColorBuffer(
        pixels=torch.zeros((height, width, 4), dtype=dtype, device=device),
        frames=torch.zeros((), dtype=dtype, device=device),
    )


def to_numpy(pixels) -> np.ndarray:
    if isinstance(pixels, torch.Tensor):
        pixels = pixels.detach().cpu().numpy()
    return np.asarray(pixels, np.float64)


def to_u8(pixels) -> np.ndarray:
    """rgb^0.4545 * 255 and alpha * 255, truncated and saturated like
    Rust's `as u8` (NaN -> 0)."""
    a = to_numpy(pixels)
    out = np.empty_like(a)
    out[..., :3] = np.power(np.maximum(a[..., :3], 0.0), 0.4545) * 255.0
    out[..., 3] = a[..., 3] * 255.0
    return np.clip(np.nan_to_num(out), 0.0, 255.0).astype(np.uint8)


def blit_u8(src_pixels, frame: np.ndarray, at: tuple[int, int]) -> np.ndarray:
    """Blit a buffer into a larger u8 frame at an offset. Like the
    reference's convert_to_u8_at, it does NOT gamma-encode: linear * 255."""
    a = to_numpy(src_pixels)
    h, w = a.shape[:2]
    x0, y0 = at
    frame[y0 : y0 + h, x0 : x0 + w, : a.shape[-1]] = np.clip(a * 255.0, 0.0, 255.0).astype(np.uint8)
    return frame
