"""Build and load the CUDA kernels of `csrc/` at first use.

`nvcc` compiles each `csrc/*.cu` into a shared library of its own with a
plain C interface, which `ctypes` loads; nothing includes PyTorch's
headers, and the compilers run side by side. A kernel may add flags of its
own (KERNEL_FLAGS: K2's media instantiation is built without FMA
contraction). The SDF backend's sources (PER_COUNT: `megakernel_sdf.cu`,
`megakernel_sdf_bwd_media.cu`) are built once for each scene's primitive
counts (spheres, boxes, tori), which they take as -D definitions, as the
JAX kernel retraces for each new `_sdf_meta`; `load(kernel, counts=...)`
builds that library at first use. The libraries go to
`build/torch_kernels/<hash>/` at the repository root, keyed by a hash of
the sources and flags (a per-count library's name holds its counts), so an
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
import time
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
# rounding; megakernel_bwd_media.cu), and so do the small mesh's K1 and K3,
# whose compacted loop must render the per-thread loop's frames bit for bit,
# and its media-free K2, whose record kernel traces those paths again
# (megakernel_mesh.cu)
KERNEL_FLAGS = {"megakernel_bwd_media": ("-fmad=false",), "megakernel_sdf_bwd_media": ("-fmad=false",),
                "megakernel_mesh": ("-fmad=false",)}
# kernels built for each SDF scene's (spheres, boxes, tori)
PER_COUNT = ("megakernel_sdf", "megakernel_sdf_bwd_media")
_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
# kernel -> its entry points' (argtypes, restype)
SIGNATURES = {
    "megakernel_fwd": {
        "pt_render_forward": ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "pt_render_forward_bigmesh": ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P], _I),
        "pt_render_forward_occupancy": ([_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "pt_render_forward_occupancy_bigmesh": (
            [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P], _I),
        "pt_forward_resources": ([_I, _I, _I, _I, _I, _P], _I),
        "pt_forward_layout": ([_I, _I, _I, _I, _P], _I),
    },
    "uniform_stream": {
        "pt_uniform_stream": ([_P, _P, _I, _I, _I, _P], _I),
    },
    # K2's two kernels of each backend: the record kernel (sv, n_sv, keys,
    # the record buffer) and the adjoint kernel (sv, n_sv, keys, ct, the
    # record buffer, partial), then the frame's ints and flags, the
    # backend's, the chunk (p0, pixels, k0, samples), the stream
    "megakernel_bwd": {
        "pt_render_backward_record": ([_P, _I, _P, _P] + [_I] * 11 + [_P], _I),
        "pt_render_backward_adjoint": ([_P, _I, _P, _P, _P, _P] + [_I] * 11 + [_P], _I),
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

# The SDF scene's library of its counts: K1 and K3 (the counts after the
# flags), K6, and K2's record and adjoint kernels (the counts after the
# flags, then the chunk).
_SDF_FWD = ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I)
_SDF_OCC = ([_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I)
_SDF_REC = ([_P, _I, _P, _P] + [_I] * 14 + [_P], _I)
_SDF_ADJ = ([_P, _I, _P, _P, _P, _P] + [_I] * 14 + [_P], _I)
_SDF_LIB = {"pt_backward_resources": SIGNATURES["megakernel_bwd"]["pt_backward_resources"]}
SIGNATURES["megakernel_sdf"] = {
    "pt_forward_layout": SIGNATURES["megakernel_fwd"]["pt_forward_layout"],
    "pt_render_forward_sdf": _SDF_FWD, "pt_render_forward_media_sdf": _SDF_FWD,
    "pt_render_forward_occupancy_sdf": _SDF_OCC, "pt_render_forward_occupancy_media_sdf": _SDF_OCC,
    "pt_march_steps": ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "pt_render_backward_sdf_record": _SDF_REC, "pt_render_backward_sdf_adjoint": _SDF_ADJ, **_SDF_LIB,
}
SIGNATURES["megakernel_sdf_bwd_media"] = {
    "pt_render_backward_media_sdf_record": _SDF_REC, "pt_render_backward_media_sdf_adjoint": _SDF_ADJ, **_SDF_LIB,
}
# The small mesh's library: K1 and K3 without and with the medium, and
# K2's media-free record and adjoint kernels (the topology, its triangles
# and vertices after the flags; K2's then the chunk).
_MESH_FWD = ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P], _I)
_MESH_OCC = ([_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P], _I)
_MESH_REC = ([_P, _I, _P, _P] + [_I] * 7 + [_P] + [_I] * 6 + [_P], _I)
_MESH_ADJ = ([_P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P] + [_I] * 6 + [_P], _I)
SIGNATURES["megakernel_mesh"] = {
    "pt_render_forward_mesh": _MESH_FWD, "pt_render_forward_media_mesh": _MESH_FWD,
    "pt_render_forward_occupancy_mesh": _MESH_OCC, "pt_render_forward_occupancy_media_mesh": _MESH_OCC,
    "pt_forward_resources": SIGNATURES["megakernel_fwd"]["pt_forward_resources"],
    "pt_forward_layout": SIGNATURES["megakernel_fwd"]["pt_forward_layout"],
    "pt_render_backward_mesh_record": _MESH_REC, "pt_render_backward_mesh_adjoint": _MESH_ADJ,
    "pt_backward_resources": SIGNATURES["megakernel_bwd"]["pt_backward_resources"],
}
# The media instantiations take the media-free entry points' arguments.
_FWD, _BWD = SIGNATURES["megakernel_fwd"], SIGNATURES["megakernel_bwd"]
_FWD.update({
    "pt_render_forward_media": _FWD["pt_render_forward"],
    "pt_render_forward_media_bigmesh": _FWD["pt_render_forward_bigmesh"],
    "pt_render_forward_occupancy_media": _FWD["pt_render_forward_occupancy"],
    "pt_render_forward_occupancy_media_bigmesh": _FWD["pt_render_forward_occupancy_bigmesh"],
})
SIGNATURES["megakernel_bwd_media"] = {
    "pt_render_backward_media_record": _BWD["pt_render_backward_record"],
    "pt_render_backward_media_adjoint": _BWD["pt_render_backward_adjoint"],
    "pt_render_backward_media_mesh_record": _MESH_REC, "pt_render_backward_media_mesh_adjoint": _MESH_ADJ,
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
    """One shared library per `csrc/*.cu`, named by the file's stem; the
    PER_COUNT ones, one per SDF scene's counts, are not among them."""
    return [src.stem for src in sorted(csrc.glob("*.cu")) if src.stem not in PER_COUNT]


def per_count_kernels(csrc: Path = CSRC) -> list[str]:
    """The PER_COUNT sources of `csrc` (none in a tree from before the SDF
    backend was built for each scene's counts)."""
    return [stem for stem in PER_COUNT if (csrc / f"{stem}.cu").exists()]


def library_name(kernel: str, counts: tuple | None = None) -> str:
    """The stem of a kernel's library: `kernel`, or for the counts
    (spheres, boxes, tori) `kernel_S_B_T`."""
    return kernel if counts is None else "_".join([kernel, *map(str, counts)])


def _digest(flags: tuple, csrc: Path) -> str:
    h = hashlib.sha256(" ".join(flags).encode() + repr(sorted(KERNEL_FLAGS.items())).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(flags: tuple = NVCC_FLAGS, csrc: Path = CSRC, sdf_counts=(), stems=None) -> Path:
    """Compile each *.cu of `csrc` (this checkout's, or another checkout's
    to compare with) into its own shared library, and each PER_COUNT one
    for each (spheres, boxes, tori) of `sdf_counts` (only those of `stems`,
    where given), cached by the content of every source and header and the
    flags; the nvcc processes run side by side. Returns the directory of
    the libraries; each library's log ends with the seconds its build
    took."""
    out_dir = BUILD_ROOT / _digest(flags, csrc)
    todo = [(stem, None) for stem in kernels(csrc)]
    todo += [(stem, tuple(c)) for c in sdf_counts for stem in per_count_kernels(csrc)]
    todo = [(stem, c) for stem, c in todo if (stems is None or stem in stems)
            and not (out_dir / f"lib{library_name(stem, c)}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for stem, counts in todo:
        name = library_name(stem, counts)
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        defines = () if counts is None else tuple(f"-DSDF_{k}={v}" for k, v in zip(("SPHERES", "BOXES", "TORI"), counts))
        cmd = [nvcc, *flags, *KERNEL_FLAGS.get(stem, ()), *defines, "-I", str(csrc), "-o", str(tmp),
               str(csrc / f"{stem}.cu")]
        log = open(out_dir / f"build_{name}.log", "w")
        log.write(" ".join(cmd) + "\n")
        log.flush()
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed, start = [], time.perf_counter()
    while procs:
        for name, (proc, tmp, log) in list(procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del procs[name]
            log.write(f"built in {time.perf_counter() - start:.1f} s, the builds beside it started together\n")
            log.close()
            if rc != 0:
                failed.append(f"{name} ({rc}):\n{(out_dir / f'build_{name}.log').read_text()[-4000:]}")
            else:
                os.replace(tmp, out_dir / f"lib{name}.so")
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return out_dir


def build_log(flags: tuple = NVCC_FLAGS) -> str:
    """The compiler's output of the last build of each kernel (registers,
    spills, the seconds it took), the per-count libraries' too, each after
    a line `== <library>`."""
    out_dir = BUILD_ROOT / _digest(flags, CSRC)
    return "".join(f"== {log.stem[len('build_'):]}\n{log.read_text()}" for log in sorted(out_dir.glob("build_*.log")))


@functools.lru_cache(maxsize=None)
def load(kernel: str = "megakernel_fwd", flags: tuple = NVCC_FLAGS, csrc: Path = CSRC,
         counts: tuple | None = None) -> ctypes.CDLL:
    """Build if needed and load one kernel's library (a PER_COUNT kernel's
    for the SDF scene's `counts`), with the C signatures of the entry points
    it exports (another checkout's may lack newer ones). The first load of
    a kernel builds every other one beside it; with counts, only that one."""
    if (counts is None) != (kernel not in PER_COUNT):
        raise ValueError(f"{kernel}: the SDF scene's counts are given for, and only for, {PER_COUNT}")
    counts = None if counts is None else tuple(int(c) for c in counts)
    out_dir = build(flags, csrc, () if counts is None else (counts,), stems=None if counts is None else (kernel,))
    lib = ctypes.CDLL(str(out_dir / f"lib{library_name(kernel, counts)}.so"))
    # every library's signatures: an older checkout's library may export an
    # entry point that another library holds here (its SDF entry points)
    known = {name: sig for table in SIGNATURES.values() for name, sig in table.items()}
    for name, (argtypes, restype) in {**known, "pt_error_string": ([_I], ctypes.c_char_p)}.items():
        entry = getattr(lib, name, None)
        if entry is not None:
            entry.argtypes, entry.restype = argtypes, restype
    return lib
