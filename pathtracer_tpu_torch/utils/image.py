"""PNG write and read for render output, and the terminal preview.

Port of `pathtracer_tpu/utils/image.py`. The encoder and reader need the
standard library and numpy only; `save_render` writes through the native
runtime (`utils/native`) where it loads, and through `buffer.to_u8` and
`encode_png` otherwise, and says which. `ansi_preview` draws a buffer as
24-bit-color half blocks.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np
import torch

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


def as_float32(pixels) -> np.ndarray:
    """A host float32 array of a tensor on any device (cast on the device
    before the copy) or of an array."""
    if isinstance(pixels, torch.Tensor):
        return pixels.detach().to(torch.float32).cpu().numpy()
    return np.asarray(pixels, np.float32)


@functools.cache
def native_runtime():
    """(the native runtime module, None), or (None, why it did not load)."""
    try:
        from . import native
    except ImportError as e:
        return None, str(e)
    return native, None


def save_render(path: str, pixels, gamma: bool = True) -> str:
    """Save a linear [H, W, 4] buffer as PNG: ^0.4545 encode, or with
    gamma=False linear * 255. Returns the encoder that wrote it: "native",
    or "numpy" with the reason the native runtime did not load."""
    native, err = native_runtime()
    if native is not None:
        data = native.tonemap_encode_png(as_float32(pixels), gamma)
        with open(path, "wb") as f:
            f.write(data)
        return "native"
    if gamma:
        u8 = to_u8(pixels)
    else:
        u8 = np.clip(to_numpy(pixels) * 255.0, 0, 255).astype(np.uint8)
    write_png(path, u8)
    return f"numpy (native runtime unavailable: {err})"


def ansi_preview(pixels, max_cols: int = 100, gamma: bool = True) -> str:
    """A linear [H, W, 3|4] buffer as a 24-bit-color ANSI string: each
    character cell shows two vertical pixels with the upper-half-block glyph
    (foreground the top pixel, background the bottom one), box-filtered
    down to at most `max_cols` columns."""
    a = to_numpy(pixels)[..., :3]
    if gamma:
        a = np.power(np.maximum(a, 0.0), 0.4545)
    a = np.clip(np.nan_to_num(a) * 255.0, 0.0, 255.0)
    h, w = a.shape[:2]
    cols = min(max_cols, w)
    # a terminal cell is about twice as tall as wide: two pixels a cell
    sx = sy = max(1, w // cols)
    hh, ww = (h // (2 * sy)) * 2 * sy, (w // sx) * sx
    if hh == 0 or ww == 0:
        return ""
    ds = a[:hh, :ww].reshape(hh // sy, sy, ww // sx, sx, 3).mean(axis=(1, 3)).astype(np.int32)
    lines = []
    for y in range(0, ds.shape[0] - 1, 2):
        cells = []
        for x in range(ds.shape[1]):
            tr, tg, tb = ds[y, x]
            br, bg, bb = ds[y + 1, x]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m\u2580")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


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
