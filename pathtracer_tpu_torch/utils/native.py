"""ctypes binding of the native presentation runtime, `native/runtime.cpp`.

Threaded tonemap, blit and PNG encode on the host, with the signatures of
`pathtracer_tpu/utils/native.py`. At first import the source is built with
g++ as `native/Makefile` builds it, into `build/native/<hash of the source
and the flags>/libptruntime.so` under the repository root (nothing is
written beside the source); a later import loads that library. Where it
cannot be built or loaded, importing this module raises ImportError, and
the callers (`utils/image.save_render`, `utils/viewer`) encode with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "runtime.cpp"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-lz", "-lpthread")


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS + LDFLAGS).encode()).hexdigest()[:16]
    return ROOT / "build" / "native" / h / "libptruntime.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise ImportError("native runtime: no g++ on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: a process building at the same time never loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXXFLAGS, str(SOURCE), *LDFLAGS, "-o", tmp], capture_output=True, text=True,
                           timeout=120)
        if r.returncode != 0:
            raise ImportError(f"native runtime: g++ failed: {r.stderr.strip()[-400:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    if not SOURCE.exists():
        raise ImportError(f"native runtime source missing: {SOURCE}")
    path = library_path()
    if not path.exists():
        try:
            _build(path)
        except (OSError, subprocess.SubprocessError) as e:
            raise ImportError(f"native runtime: build failed: {e}") from e
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise ImportError(f"native runtime: cannot load {path}: {e}") from e
    f32, u8, i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
    for name, argtypes, restype in (
        ("pt_tonemap_u8", [f32, i64, ctypes.c_int, u8], None),
        ("pt_blit_u8", [f32, i64, i64, u8, i64, i64, i64, i64], None),
        ("pt_png_bound", [i64, i64, i64], i64),
        ("pt_encode_png", [u8, i64, i64, i64, u8, i64], i64),
        ("pt_tonemap_encode_png", [f32, i64, i64, ctypes.c_int, u8, i64], i64),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


_lib = _load()


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _rgba_f32(pixels) -> np.ndarray:
    a = np.ascontiguousarray(pixels, np.float32)
    if a.ndim != 3 or a.shape[2] != 4:
        raise ValueError(f"expected [H,W,4] f32, got {a.shape}")
    return a


def tonemap_u8(pixels: np.ndarray, gamma: bool = True) -> np.ndarray:
    """Threaded encode of a linear [H, W, 4] f32 buffer to u8: rgb^0.4545
    and linear alpha (buffer.to_u8), or with gamma=False linear * 255."""
    a = _rgba_f32(pixels)
    out = np.empty(a.shape, np.uint8)
    _lib.pt_tonemap_u8(_f32ptr(a), a.shape[0] * a.shape[1], int(gamma), _u8ptr(out))
    return out


def blit_u8(src: np.ndarray, frame: np.ndarray, at: tuple[int, int]) -> np.ndarray:
    """Blit a linear [h, w, 4] f32 buffer into a u8 RGBA frame at (x0, y0),
    linear * 255, clipped at the frame's edges. Mutates and returns
    `frame`."""
    a = _rgba_f32(src)
    if frame.dtype != np.uint8 or not frame.flags.c_contiguous or frame.ndim != 3 or frame.shape[2] != 4:
        raise ValueError("frame must be contiguous uint8 [FH, FW, 4]")
    _lib.pt_blit_u8(_f32ptr(a), a.shape[0], a.shape[1], _u8ptr(frame), frame.shape[0], frame.shape[1],
                    int(at[0]), int(at[1]))
    return frame


def encode_png(rgba_u8: np.ndarray) -> bytes:
    """zlib PNG encode of an [H, W, 3|4] u8 image."""
    a = np.ascontiguousarray(rgba_u8)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4):
        raise ValueError(f"expected [H,W,3|4] uint8, got {a.shape} {a.dtype}")
    h, w, c = a.shape
    cap = int(_lib.pt_png_bound(h, w, c))
    out = np.empty(cap, np.uint8)
    n = int(_lib.pt_encode_png(_u8ptr(a), h, w, c, _u8ptr(out), cap))
    if n < 0:
        raise RuntimeError("pt_encode_png failed")
    return out[:n].tobytes()


def tonemap_encode_png(pixels: np.ndarray, gamma: bool = True) -> bytes:
    """Fused threaded tonemap and PNG encode of a linear [H, W, 4] buffer."""
    a = _rgba_f32(pixels)
    h, w = a.shape[:2]
    cap = int(_lib.pt_png_bound(h, w, 4))
    out = np.empty(cap, np.uint8)
    n = int(_lib.pt_tonemap_encode_png(_f32ptr(a), h, w, int(gamma), _u8ptr(out), cap))
    if n < 0:
        raise RuntimeError("pt_tonemap_encode_png failed")
    return out[:n].tobytes()
