"""PNG write and read for render output, with the standard library only.

Port of `pathtracer_tpu/utils/image.py` (the encoder and reader were numpy
already); `save_render` gamma-encodes through `buffer.to_u8`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .buffer import to_numpy, to_u8


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(rgba_u8: np.ndarray) -> bytes:
    """Encode [H, W, 3|4] uint8 to PNG bytes (RGB/RGBA, 8-bit)."""
    a = np.ascontiguousarray(rgba_u8)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4):
        raise ValueError(f"expected [H,W,3|4] uint8, got {a.shape} {a.dtype}")
    h, w, c = a.shape
    color_type = 2 if c == 3 else 6
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )


def write_png(path: str, rgba_u8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgba_u8))


def save_render(path: str, pixels, gamma: bool = True) -> None:
    """Save a linear [H, W, 4] buffer as PNG: ^0.4545 encode, or with
    gamma=False linear * 255."""
    if gamma:
        u8 = to_u8(pixels)
    else:
        u8 = np.clip(to_numpy(pixels) * 255.0, 0, 255).astype(np.uint8)
    write_png(path, u8)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit RGB/RGBA, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color_type not in (2, 6):
                raise ValueError("unsupported PNG variant")
            c = 3 if color_type == 2 else 4
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.empty((h, w, c), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        filt = raw[y * (stride + 1)]
        line = np.frombuffer(raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8).copy()
        if filt == 0:
            pass
        elif filt == 1:  # Sub
            for i in range(c, stride):
                line[i] = (int(line[i]) + int(line[i - c])) & 0xFF
        elif filt == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif filt == 3:  # Average
            for i in range(stride):
                left = int(line[i - c]) if i >= c else 0
                line[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for i in range(stride):
                left = int(line[i - c]) if i >= c else 0
                up = int(prev[i])
                ul = int(prev[i - c]) if i >= c else 0
                p = left + up - ul
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                pred = left if (pa <= pb and pa <= pc) else (up if pb <= pc else ul)
                line[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {filt}")
        out[y] = line.reshape(w, c)
        prev = line
    return out
