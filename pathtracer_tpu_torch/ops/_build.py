"""Build and load the CUDA kernels of `csrc/` at first use.

`nvcc` compiles each `csrc/*.cu` into a shared library of its own with a
plain C interface, which `ctypes` loads; nothing includes PyTorch's
headers, and the compilers run side by side. A kernel may add flags of its
own (KERNEL_FLAGS: K2's media instantiation is built without FMA
contraction). The libraries go to
`build/torch_kernels/<hash>/` at the repository root, keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused. A missing `nvcc` or a failed build raises.
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
# kernel -> the flags it adds to NVCC_FLAGS: K2's MEDIA instantiation (its
# record kernel and its adjoint) rounds each product and sum apart, as its
# plain version does (the glass's grazing refractions amplify a contracted
# rounding; megakernel_bwd_media.cu)
KERNEL_FLAGS = {"megakernel_bwd_media": ("-fmad=false",)}
_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
# kernel -> its entry points' (argtypes, restype)
SIGNATURES = {
    "megakernel_fwd": {
        "pt_render_forward": ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "pt_render_forward_sdf": ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "pt_render_forward_mesh": ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P], _I),
        "pt_render_forward_bigmesh": ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P], _I),
        "pt_render_forward_occupancy": ([_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "pt_render_forward_occupancy_sdf": ([_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "pt_render_forward_occupancy_mesh": ([_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P], _I),
        "pt_render_forward_occupancy_bigmesh": (
            [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P], _I),
    },
    "uniform_stream": {
        "pt_uniform_stream": ([_P, _P, _I, _I, _I, _P], _I),
    },
    "march_steps": {
        "pt_march_steps": ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    },
    # K2's two kernels of each backend: the record kernel (sv, n_sv, keys,
    # the record buffer) and the adjoint kernel (sv, n_sv, keys, ct, the
    # record buffer, partial), then the frame's ints and flags, the
    # backend's, the chunk (p0, pixels, k0, samples), the stream
    "megakernel_bwd": {
        "pt_render_backward_record": ([_P, _I, _P, _P] + [_I] * 11 + [_P], _I),
        "pt_render_backward_adjoint": ([_P, _I, _P, _P, _P, _P] + [_I] * 11 + [_P], _I),
        "pt_render_backward_sdf_record": ([_P, _I, _P, _P] + [_I] * 14 + [_P], _I),
        "pt_render_backward_sdf_adjoint": ([_P, _I, _P, _P, _P, _P] + [_I] * 14 + [_P], _I),
        "pt_render_backward_mesh_record": ([_P, _I, _P, _P] + [_I] * 7 + [_P] + [_I] * 6 + [_P], _I),
        "pt_render_backward_mesh_adjoint": ([_P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P] + [_I] * 6 + [_P], _I),
        "pt_backward_reduce": ([_P, _I, _I, _P, _P], _I),
        "pt_backward_sdf_max_primitives": ([], _I),
        "pt_backward_smem_bytes": ([_I, _I], _S),
        "pt_backward_threads": ([], _I),
        "pt_backward_max_lights": ([], _I),
        "pt_backward_record_cap": ([], _S),
        "pt_backward_record_bytes": ([_I, _I, _I, _I, _S, _P], _S),
        "pt_backward_resources": ([_I, _I, _I, _P], _I),
    },
}

# The media instantiations take the media-free entry points' arguments.
_FWD, _BWD = SIGNATURES["megakernel_fwd"], SIGNATURES["megakernel_bwd"]
_FWD.update({
    "pt_render_forward_media": _FWD["pt_render_forward"],
    "pt_render_forward_media_sdf": _FWD["pt_render_forward_sdf"],
    "pt_render_forward_media_mesh": _FWD["pt_render_forward_mesh"],
    "pt_render_forward_media_bigmesh": _FWD["pt_render_forward_bigmesh"],
    "pt_render_forward_occupancy_media": _FWD["pt_render_forward_occupancy"],
    "pt_render_forward_occupancy_media_sdf": _FWD["pt_render_forward_occupancy_sdf"],
    "pt_render_forward_occupancy_media_mesh": _FWD["pt_render_forward_occupancy_mesh"],
    "pt_render_forward_occupancy_media_bigmesh": _FWD["pt_render_forward_occupancy_bigmesh"],
})
SIGNATURES["megakernel_bwd_media"] = {
    **{f"pt_render_backward_media{backend}_{kernel}": _BWD[f"pt_render_backward{backend}_{kernel}"]
       for backend in ("", "_sdf", "_mesh") for kernel in ("record", "adjoint")},
    "pt_backward_resources": _BWD["pt_backward_resources"],
}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources(csrc: Path) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def kernels(csrc: Path = CSRC) -> list[str]:
    """One shared library per `csrc/*.cu`, named by the file's stem."""
    return [src.stem for src in sorted(csrc.glob("*.cu"))]


def _digest(flags: tuple, csrc: Path) -> str:
    h = hashlib.sha256(" ".join(flags).encode() + repr(sorted(KERNEL_FLAGS.items())).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(flags: tuple = NVCC_FLAGS, csrc: Path = CSRC) -> Path:
    """Compile each *.cu of `csrc` (this checkout's, or another checkout's
    to compare with) into its own shared library, cached by the content of
    every source and header; the nvcc processes run side by side. Returns
    the directory of the libraries."""
    out_dir = BUILD_ROOT / _digest(flags, csrc)
    todo = [stem for stem in kernels(csrc) if not (out_dir / f"lib{stem}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for stem in todo:
        tmp = out_dir / f"lib{stem}.so.tmp{os.getpid()}"
        cmd = [nvcc, *flags, *KERNEL_FLAGS.get(stem, ()), "-I", str(csrc), "-o", str(tmp), str(csrc / f"{stem}.cu")]
        log = open(out_dir / f"build_{stem}.log", "w")
        log.write(" ".join(cmd) + "\n")
        log.flush()
        procs[stem] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for stem, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{stem}.cu ({rc}):\n{(out_dir / f'build_{stem}.log').read_text()[-4000:]}")
        else:
            os.replace(tmp, out_dir / f"lib{stem}.so")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return out_dir


def build_log(flags: tuple = NVCC_FLAGS) -> str:
    """The compiler's output of the last build of each kernel (registers,
    spills)."""
    out_dir = BUILD_ROOT / _digest(flags, CSRC)
    return "".join(
        (out_dir / f"build_{stem}.log").read_text()
        for stem in kernels() if (out_dir / f"build_{stem}.log").exists()
    )


@functools.lru_cache(maxsize=None)
def load(kernel: str = "megakernel_fwd", flags: tuple = NVCC_FLAGS, csrc: Path = CSRC) -> ctypes.CDLL:
    """Build if needed and load one kernel's library, with the C signatures
    of the entry points it exports (another checkout's may lack newer
    ones)."""
    lib = ctypes.CDLL(str(build(flags, csrc) / f"lib{kernel}.so"))
    for name, (argtypes, restype) in {**SIGNATURES[kernel], "pt_error_string": ([_I], ctypes.c_char_p)}.items():
        entry = getattr(lib, name, None)
        if entry is not None:
            entry.argtypes, entry.restype = argtypes, restype
    return lib
