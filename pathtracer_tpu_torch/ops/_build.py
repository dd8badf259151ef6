"""Build and load the CUDA kernels of `csrc/` at first use.

`nvcc` compiles the sources into a shared library with a plain C
interface, which `ctypes` loads; nothing includes PyTorch's headers, so a
build takes seconds. The library goes to `build/torch_kernels/<hash>/` at
the repository root, keyed by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused. A missing `nvcc`
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest(flags: tuple) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(flags: tuple = NVCC_FLAGS) -> Path:
    """Compile csrc/*.cu into one shared library (cached by content)."""
    out_dir = BUILD_ROOT / _digest(flags)
    lib = out_dir / "libpt_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libpt_kernels.so.tmp{os.getpid()}"
    cmd = [find_nvcc(), *flags, "-I", str(CSRC), "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def build_log(flags: tuple = NVCC_FLAGS) -> str:
    """The compiler's output of the last build (registers, spills)."""
    path = BUILD_ROOT / _digest(flags) / "build.log"
    return path.read_text() if path.exists() else ""


@functools.lru_cache(maxsize=None)
def load(flags: tuple = NVCC_FLAGS) -> ctypes.CDLL:
    """Build if needed and load the library, with its C signatures set."""
    lib = ctypes.CDLL(str(build(flags)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pt_render_forward.argtypes = [p, i, p, p, i, i, f, f, i, i, i, i, i, p]
    lib.pt_render_forward.restype = i
    lib.pt_error_string.argtypes = [i]
    lib.pt_error_string.restype = ctypes.c_char_p
    return lib
