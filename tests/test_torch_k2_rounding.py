"""Rehearse on the CPU how far K2 can sit from its plain version on the card.

The card's compiler contracts a * b + c into one FMA wherever it may; the
plain version's separate tensor ops round each step. This module builds
the per-thread headers of K1 and K2 with g++ and the same freedom
(`-mfma -ffp-contract=fast`; `--contract off` for none), runs them over a
whole frame on the host, and compares the gradient with the plain
version's as chip_smoke.py phase 6 does: the cotangent is zeroed at
knife-edge pixels (host and plain frames differ by more than 1e-3), and
max|d|/max|g| and the largest relative error among entries above 1e-2
max|g| must stay within phase 6's 1e-2 and 2e-2. At a silhouette the
gradient grows as 1/sqrt(r^2 - d^2), so a float32 sphere test or camera
ray, rounded one way under contraction and another in torch, fails this.

The test runs at 320x240; the full size takes about 1.5 minutes with 4
threads:

    python tests/test_torch_k2_rounding.py --width 1920 --height 1080

`--scene sdf` rehearses K2 with the SDF backend (the Newton step's
1/<rd, n> grows at silhouettes as the sphere test's 1/sqrt(r^2 - d^2)
does); its plain version is about 30 times slower, so 320x240 is the
size to rehearse at. `--pixel P` differentiates the one pixel P of the
frame instead, with both contraction modes, and prints its gap (a pixel
that chip_smoke.py finds at any size):

    python tests/test_torch_k2_rounding.py --scene sdf --width 1920 --height 1080 --seed 45 --pixel 1898726

`--scene mesh` rehearses K2 with the mesh backend (chip_smoke.py phase
21), masking beside the knife-edge pixels those whose plain path passes
near an edge (`ops/megakernel_mesh.hit_margins`: the winner's
min(u, v, 1 - u - v) below 3e-5, or |det| below 1e-5), where the last bits
of the ray can pick the other triangle of a shared edge.

`--grazing BELOW` takes every pixel whose plain path meets a hit that the
last bits of the ray can move: on the SDF scene a hit at |<rd, n>| < BELOW
(phase 13 masks them at 1e-3), on the analytical scene likewise a grazing
sphere or plane hit (at a silhouette the sphere test's 1/sqrt(r^2 - d^2)),
on the mesh a hit whose barycentric margin is below BELOW (phase 21 masks
them at 3e-5, with |det| below 1e-5). It differentiates each pixel alone
with both contraction modes, and prints what the set adds to the phase's
two numbers in each mode. The set and the frame's plain gradient come from
`--device`, a card at 1080p, and `--seeds` runs several frames:

    python tests/test_torch_k2_rounding.py --scene sdf --width 1920 --height 1080 --seed 45 --grazing 1e-3 --device cuda
    python tests/test_torch_k2_rounding.py --scene mesh --width 320 --height 240 --seeds 81 82 83 --grazing 3e-5 --device cuda

`--media NAME` rehearses K2's MEDIA instantiation (chip_smoke.py phase
30) on the analytical glass demo filled with Absorb, Emissive or Scatter
g 0.4 (`lit`: the Scatter with the light inside it), depth 6, at `--spp`
(`--fixed` for the FIXED quirks), in both contraction modes: the gap over
all pixels, with the knife-edge pixels masked, and with them and each
`--below` set of grazing pixels (a hit at |<rd, n>| < BELOW on the plain
path) masked too. Inside the glass sphere a
path that meets its wall near grazing or near the critical angle
refracts or reflects with a derivative that grows as 1/|<rd, n>|, so such
a pixel's gradient hangs on the last bits of its ray, and a few such
pixels carry most of an entry that the others' cancel. With contraction
the gap exceeds phase 30's rtol and no grazing mask settles it; without,
it vanishes over every pixel. So the card builds K2 MEDIA without
contraction (`csrc/megakernel_bwd_media.cu`, `ops/_build.KERNEL_FLAGS`):

    python tests/test_torch_k2_rounding.py --media absorb --spp 2 --seed 405 --below 1e-3 1e-2

`--trainer STEPS` runs the SDF `recover_demo` with the host build in the
place of K1 and K2, in both modes, against the eager trainer, as phase 15
does on the card:

    python tests/test_torch_k2_rounding.py --scene sdf --width 64 --height 48 --trainer 3
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pathtracer_tpu_torch.integrator import inverse  # noqa: E402
from pathtracer_tpu_torch.integrator import tracer as T  # noqa: E402
from pathtracer_tpu_torch.models.camera import gen_ray, pixel_coords  # noqa: E402
from pathtracer_tpu_torch.models.families import family_of, make_family_scene  # noqa: E402
from pathtracer_tpu_torch.ops import _build, rng  # noqa: E402
from pathtracer_tpu_torch.ops import megakernel as mk  # noqa: E402
from pathtracer_tpu_torch.ops import megakernel_mesh as mkm  # noqa: E402
from pathtracer_tpu_torch.ops import megakernel_sdf as mks  # noqa: E402
from pathtracer_tpu_torch.ops.vecmath import V2, dot  # noqa: E402
from test_torch_kernel_bwd_host import HOST_BACKWARD, SHIM as BWD_SHIM  # noqa: E402
from test_torch_kernel_host import PRELUDE, SHIM as FWD_SHIM, launch_keys  # noqa: E402
from test_torch_mesh_kernel_bwd_host import SHIM as MESH_BWD_SHIM  # noqa: E402
from test_torch_sdf_kernel_bwd_host import SHIM as SDF_BWD_SHIM  # noqa: E402
from test_torch_kernel_host import one_torch_thread  # noqa: E402, F401
from test_torch_media_kernel_host import DEMO, lit_scene, media_scene  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# K1 with the SDF backend beside the SDF adjoint's shim (which has `view`).
SDF_RENDER = r"""
extern "C" void host_grad_pixel_sdf(const float* sv, const int* counts, const uint32_t* keys, const float* ct,
                                    float* grad, int p, int width, int height, int depth, int n_lights,
                                    int n_materials, int flags) {
  host_backward_pixel<pt::SdfAdj, false>(view(sv, counts, n_lights, n_materials), keys, pt::v3(ct[0], ct[1], ct[2]),
                                         grad, p, width, height, depth, flags);
}

extern "C" void host_render_sdf(const float* sv, const int* counts, const uint32_t* keys, float* out, int width,
                                int height, int spp, int depth, int n_lights, int n_materials, int flags) {
  const int n = width * height;
  const pt::SceneView s = view(sv, counts, n_lights, n_materials);
  for (int p = 0; p < n; ++p) {
    const pt::V3 r = pt::trace_sample<pt::Sdf>(s, p, n, width, height, depth, flags, keys[0], keys[1], keys[2],
                                               keys[3]);
    out[4 * p + 0] = r.x;
    out[4 * p + 1] = r.y;
    out[4 * p + 2] = r.z;
    out[4 * p + 3] = 1.0f;
  }
}
"""

# One pixel of the analytical scene's K2, beside its shims' host_grad and
# host_render.
ANALYTICAL_PIXEL = r"""
extern "C" void host_grad_pixel(const float* sv, const uint32_t* keys, const float* ct, float* grad, int p, int width,
                                int height, int depth, int n_lights, int n_materials, int flags) {
  host_backward_pixel<pt::AnalyticalAdj, false>(
      pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0), keys,
      pt::v3(ct[0], ct[1], ct[2]), grad, p, width, height, depth, flags);
}
"""

# K1 with the mesh backend and one pixel of K2, beside the mesh adjoint's
# shim (which has host_grad_mesh).
MESH_RENDER = r"""
extern "C" void host_grad_pixel_mesh(const float* sv, const int* topo, int n_tris, int n_verts, const uint32_t* keys,
                                     const float* ct, float* grad, int p, int width, int height, int depth,
                                     int n_lights, int n_materials, int flags) {
  host_backward_pixel<pt::MeshAdj, false>(pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts), keys,
                                          pt::v3(ct[0], ct[1], ct[2]), grad, p, width, height, depth, flags);
}

extern "C" void host_render_mesh(const float* sv, const int* topo, int n_tris, int n_verts, const uint32_t* keys,
                                 float* out, int width, int height, int spp, int depth, int n_lights, int n_materials,
                                 int flags) {
  const int n = width * height;
  const pt::SceneView s = pt::mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts);
  for (int p = 0; p < n; ++p) {
    const pt::V3 r = pt::trace_sample<pt::Mesh>(s, p, n, width, height, depth, flags, keys[0], keys[1], keys[2],
                                                keys[3]);
    out[4 * p + 0] = r.x;
    out[4 * p + 1] = r.y;
    out[4 * p + 2] = r.z;
    out[4 * p + 3] = 1.0f;
  }
}
"""

# K1's and K2's MEDIA instantiations of the analytical backend (--media).
MEDIA_SHIM = PRELUDE + r"""
#include "analytical_adj.cuh"
#include "tracer_adj.cuh"
""" + HOST_BACKWARD + r"""

extern "C" void host_grad_media(const float* sv, const uint32_t* keys, const float* ct, float* grad, int width,
                                int height, int spp, int depth, int n_lights, int n_materials, int flags) {
  host_backward<pt::AnalyticalAdj, true>(
      pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0), keys, ct, grad, width,
      height, spp, depth, flags);
}

extern "C" void host_render_media(const float* sv, const uint32_t* keys, float* out, int width, int height, int spp,
                                  int depth, int n_lights, int n_materials, int flags) {
  const int n = width * height;
  const pt::SceneView s = pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0);
  for (int p = 0; p < n; ++p) {
    pt::V3 sum = pt::splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      const pt::V3 r = pt::trace_sample<pt::Analytical, false, true>(s, p, n, width, height, depth, flags, kk[0],
                                                                     kk[1], kk[2], kk[3]);
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    out[4 * p + 0] = sum.x;
    out[4 * p + 1] = sum.y;
    out[4 * p + 2] = sum.z;
    out[4 * p + 3] = 1.0f;
  }
}
"""
# --media's scenes: the analytical glass demo filled with each medium
MEDIA_CASES = {
    "absorb": lambda: media_scene("analytical", 1, **DEMO),
    "emissive": lambda: media_scene("analytical", 3, density=0.5, color=(0.2, 0.8, 0.3)),
    "scatter": lambda: media_scene("analytical", 2, anisotropy=0.4, **DEMO),
    "lit": lambda: lit_scene(2, anisotropy=0.4, **DEMO),
}

EDGE_TOL, GRAD_MAX_TOL, GRAD_RTOL = 1e-3, 1e-2, 2e-2
# Phase 21's mask of the mesh's near-edge hits (ops/megakernel_mesh.hit_margins).
MESH_MARGIN, MESH_DET = 3e-5, 1e-5
CONTRACT = {"fast": ["-mfma", "-ffp-contract=fast"], "off": ["-ffp-contract=off"]}
# family -> (its K2 frame, K1 frame and one-pixel K2 entry points); each
# takes head(family) first (the packed vector, then the SDF counts or the
# mesh's topology and sizes)
ENTRIES = {
    "analytical": ("host_grad", "host_render", "host_grad_pixel"),
    "sdf": ("host_grad_sdf", "host_render_sdf", "host_grad_pixel_sdf"),
    "mesh": ("host_grad_mesh", "host_render_mesh", "host_grad_pixel_mesh"),
}


def build(flags: list[str], directory: Path, scene: str = "analytical") -> ctypes.CDLL:
    """The scene family's K2 and K1 host shims in one library (ENTRIES);
    the unfused intrinsics stay out of line, so contraction cannot merge
    them."""
    source = {
        "analytical": BWD_SHIM + FWD_SHIM[len(PRELUDE):] + ANALYTICAL_PIXEL,
        "sdf": SDF_BWD_SHIM + SDF_RENDER,
        "mesh": MESH_BWD_SHIM + MESH_RENDER,
    }[scene]
    source = source.replace("static inline float __f", "__attribute__((noinline)) static float __f")
    (directory / "shim.cpp").write_text(source)
    so = directory / "libshim.so"
    subprocess.run(["g++", "-O2", "-std=c++17", *flags, "-shared", "-fPIC", "-I", str(_build.CSRC),
                    "-o", str(so), str(directory / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    head = {"analytical": [p], "sdf": [p, p], "mesh": [p, p, i, i]}[scene]
    grad, render, pixel = (getattr(lib, name) for name in ENTRIES[scene])
    grad.argtypes = head + [p, p, p, i, i, i, i, i, i, i]
    render.argtypes = head + [p, p, i, i, i, i, i, i, i]
    pixel.argtypes = head + [p, p, p, i, i, i, i, i, i, i]
    return lib


def head(scene, sv: torch.Tensor) -> tuple[tuple, tuple]:
    """The entry points' leading arguments for the scene's family, and the
    tensors they point into (to hold until the call returns)."""
    family = family_of(scene)
    if family == "analytical":
        return (sv.data_ptr(),), ()
    if family == "sdf":
        counts = torch.tensor(mks.sdf_counts(scene), dtype=torch.int32)
        return (sv.data_ptr(), counts.data_ptr()), (counts,)
    (topo,) = mkm.mesh_topology(scene)
    return (sv.data_ptr(), topo.data_ptr(), *mkm.mesh_counts(scene)), (topo,)


def hit_cosines(scene, key, width: int, height: int, spp: int = 1, quirks=T.VERBATIM) -> torch.Tensor:
    """|<rd, n>| where each bounce of the plain version's path meets the
    analytical scene, [spp * depth, n] (sample by sample), +inf where the
    path is dead or misses."""
    p, dev = scene.params.unpack(), scene.device
    out = []
    with torch.no_grad():
        step = T.make_bounce_step(scene, quirks, detach=True)
        for k in [key] if spp == 1 else list(rng.split(key, spp)):
            cam_u, bounce_u = T.draw_uniforms(k, width * height, scene.recursion_depth, torch.float32, dev)
            ro, rd = gen_ray(scene.camera.unpack(), pixel_coords(width, height, torch.float64, dev),
                             V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height))
            state = T.init_state(ro, rd, quirks)
            for u in bounce_u:
                hit = scene.closest_hit_fn(p, state.ro, state.rd)
                cos = dot(state.rd, hit.normal).abs()
                out.append(torch.where(state.alive & torch.isfinite(hit.t), cos, torch.inf))
                state = step(state, u)
    return torch.stack(out)


def moved_pixels(scene, key, width: int, height: int, below: float) -> torch.Tensor:
    """The pixels whose plain path (spp 1, VERBATIM) meets a hit that the
    last bits of the incoming ray can move, by `--grazing BELOW`: an SDF or
    analytical hit at |<rd, n>| < below, a mesh hit at a barycentric margin
    below `below` or |det| < MESH_DET."""
    family = family_of(scene)
    if family == "sdf":
        near = mks.hit_cosines(scene, key, width, height)[0] < below
    elif family == "mesh":
        margin, det = mkm.hit_margins(scene, key, width, height)
        near = (margin[0] < below) | (det[0] < MESH_DET)
    else:
        near = hit_cosines(scene, key, width, height) < below
    return near.any(0).nonzero()[:, 0].cpu()


def plain(scene, key, sv, ct, width: int, height: int, pixels: torch.Tensor | None = None, chunk: int = 65536):
    """The plain version's radiance and d(<ct, radiance>)/d(sv) over the
    `pixels` of the frame ([n, 3]; all of them by default, as [H, W, 3]),
    in pixel chunks (its autograd holds every intermediate)."""
    n = width * height
    idx = torch.arange(n) if pixels is None else pixels
    cam_u, bounce_u = T.draw_uniforms(key, n, scene.recursion_depth, torch.float32)
    coords = pixel_coords(width, height, torch.float64)
    leaf = sv.detach().clone().requires_grad_(True)
    grad = torch.zeros(sv.shape[1], dtype=torch.float64)
    frame, ct = [], ct.reshape(-1, 4)
    for a in range(0, idx.numel(), chunk):
        i = idx[a:a + chunk]
        s, basis = mk.BACKENDS[family_of(scene)].unpack(leaf, scene)
        ro, rd = gen_ray(None, V2(coords.x[i], coords.y[i]), V2(cam_u[i, 0], cam_u[i, 1]),
                         float(width), float(height), basis)
        rad = T.trace(s, ro, rd, bounce_u[:, i], T.VERBATIM, detach=True)
        frame.append(torch.stack([rad.x, rad.y, rad.z], -1).detach())
        loss = sum((rad[c] * ct[i, c]).sum() for c in range(3))
        grad += torch.autograd.grad(loss, leaf)[0][0].double()
    frame = torch.cat(frame)
    return (frame.reshape(height, width, 3) if pixels is None else frame), grad


def grad_gap(g: torch.Tensor, r: torch.Tensor) -> tuple[float, float]:
    """(max|d|/max|g|, the largest relative error among entries above 1e-2
    max|g|)."""
    scale = r.abs().max()
    big = r.abs() > 1e-2 * scale
    d = (g - r).abs()
    return float(d.max() / scale), float((d[big] / r.abs()[big]).max())


def rehearse(lib, width: int, height: int, seed: int, family: str = "analytical") -> dict:
    """Phase 6's (phase 13's for the SDF family, 21's for the mesh)
    comparison on the host: the knife-edge pixel count and the gap over all
    pixels and with the knife-edge pixels masked; on the mesh the pixels
    near an edge (MESH_MARGIN, MESH_DET) are masked too and counted."""
    scene, key = make_family_scene(family), rng.prng_key(seed)
    sv, keys = mk.BACKENDS[family].pack(scene, width, height).contiguous(), launch_keys(key, 1)
    lead, held = head(scene, sv)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((height, width, 4)).astype(np.float32))
    shape = (width, height, 1, scene.recursion_depth, scene.num_lights,
             int(scene.params.materials.roughness.shape[0]), mk.kernel_flags(scene, T.VERBATIM))
    grad_fn, render_fn, _ = (getattr(lib, name) for name in ENTRIES[family])

    def host_grad(c):
        c, g = c.contiguous(), torch.zeros(sv.shape[1])  # held: the library reads their memory
        grad_fn(*lead, keys.data_ptr(), c.data_ptr(), g.data_ptr(), *shape)
        return g.double()

    img = torch.empty((height, width, 4))
    render_fn(*lead, keys.data_ptr(), img.data_ptr(), *shape)
    frame, ref = plain(scene, key, sv, ct, width, height)
    edge = (img[..., :3] - frame).abs().amax(-1) > EDGE_TOL
    out = dict(edge=int(edge.sum()), all=grad_gap(host_grad(ct), ref))
    if family == "mesh":
        near = torch.zeros(width * height, dtype=torch.bool)
        near[moved_pixels(scene, key, width, height, MESH_MARGIN)] = True
        out["near_edge"] = int((near.reshape(height, width) & ~edge).sum())
        edge = edge | near.reshape(height, width)
    if edge.any():
        masked = ct * (~edge)[..., None]
        out["masked"] = grad_gap(host_grad(masked), plain(scene, key, sv, masked, width, height)[1])
    else:
        out["masked"] = out["all"]
    return out


def test_contracted_backward_matches_plain(tmp_path):
    """320x240, depth 4, seed 24, contraction as on the card: within phase
    6's tolerance with only knife-edge pixels masked, and those few (the
    mask must not hide a frame-wide fault)."""
    out = rehearse(build(CONTRACT["fast"], tmp_path), 320, 240, 24)
    max_rel, big_rel = out["masked"]
    assert out["edge"] <= 5, out
    assert max_rel <= GRAD_MAX_TOL and big_rel <= GRAD_RTOL, out


def build_media(flags: list[str], directory: Path) -> ctypes.CDLL:
    """MEDIA_SHIM with `flags`, the unfused intrinsics out of line."""
    source = MEDIA_SHIM.replace("static inline float __f", "__attribute__((noinline)) static float __f")
    (directory / "shim.cpp").write_text(source)
    so = directory / "libshim.so"
    subprocess.run(["g++", "-O2", "-std=c++17", *flags, "-shared", "-fPIC", "-I", str(_build.CSRC),
                    "-o", str(so), str(directory / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_grad_media.argtypes = [p, p, p, p, i, i, i, i, i, i, i]
    lib.host_render_media.argtypes = [p, p, p, i, i, i, i, i, i, i]
    return lib


def media_rehearse(libs: dict, media: str, width: int, height: int, seed: int, spp: int = 1, quirks=T.VERBATIM,
                   below: tuple = ()) -> dict:
    """Phase 30's comparison of K2 MEDIA on the host, for each contraction
    mode of `libs`: (max|d|/max|g|, the largest relative error among
    entries above 1e-2 max|g|) over all pixels ("all"), with the knife-edge
    pixels masked ("edge"), and with them and the pixels whose plain path
    has a hit at |<rd, n>| < b masked too (b of `below`); with the pixel
    counts ("edge pixels", "grazing b")."""
    scene, key = MEDIA_CASES[media](), rng.prng_key(seed)
    sv, keys = mk.pack_scene(scene, width, height, True).contiguous(), launch_keys(key, spp)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((height, width, 4)).astype(np.float32))
    shape = (width, height, spp, scene.recursion_depth, scene.num_lights,
             int(scene.params.materials.roughness.shape[0]), mk.kernel_flags(scene, quirks))
    frame = mk.render_frame_reference(scene, key, width, height, spp, quirks)[..., :3]
    cos = hit_cosines(scene, key, width, height, spp, quirks).amin(0).reshape(height, width)
    plain_grads = {}

    def plain_grad(mask):
        k = mask.numpy().tobytes()
        if k not in plain_grads:
            plain_grads[k] = mk.render_grad_reference(sv, scene, key, ct * (~mask)[..., None], width, height, spp,
                                                      quirks)[0].double()
        return plain_grads[k]

    out = {}
    for contract, lib in libs.items():
        img = torch.empty((height, width, 4))
        lib.host_render_media(sv.data_ptr(), keys.data_ptr(), img.data_ptr(), *shape)
        edge = (img[..., :3] - frame).abs().amax(-1) > EDGE_TOL
        masks = {"all": torch.zeros_like(edge), "edge": edge}
        masks.update({f"grazing {b}": edge | (cos < b) for b in below})
        res = {"edge pixels": int(edge.sum())}
        res.update({f"pixels grazing {b}": int(((cos < b) & ~edge).sum()) for b in below})
        for name, mask in masks.items():
            c, g = (ct * (~mask)[..., None]).contiguous(), torch.zeros(sv.shape[1])  # held: the library reads them
            lib.host_grad_media(sv.data_ptr(), keys.data_ptr(), c.data_ptr(), g.data_ptr(), *shape)
            res[name] = grad_gap(g.double(), plain_grad(mask))
        out[contract] = res
    return out


@pytest.mark.parametrize("media,spp", [("absorb", 2), ("lit", 1)])
def test_uncontracted_media_backward_matches_plain(tmp_path, media, spp):
    """64x48 at depth 6: K2 MEDIA built as the card builds it, without
    contraction, agrees with the plain version over every pixel, no pixel
    masked, far inside phase 30's tolerance."""
    out = media_rehearse({"off": build_media(CONTRACT["off"], tmp_path)}, media, 64, 48, 405, spp)
    assert out["off"]["edge pixels"] == 0, out
    max_rel, big_rel = out["off"]["all"]
    assert max_rel < 1e-4 and big_rel < 1e-3, out


def pixel_grads(lib, scene, key, sv, ct, width: int, height: int, pixels) -> torch.Tensor:
    """The scene's host K2 on each of `pixels` alone (spp 1, VERBATIM),
    [n, P] float64."""
    keys = launch_keys(key, 1)
    lead, held = head(scene, sv)
    entry = getattr(lib, ENTRIES[family_of(scene)][2])
    ct = ct.reshape(-1, 4)
    out = torch.zeros((len(pixels), sv.shape[1]), dtype=torch.float64)
    for j, p in enumerate(pixels.tolist()):
        c, g = ct[p].contiguous(), torch.zeros(sv.shape[1])  # held: the library reads their memory
        entry(*lead, keys.data_ptr(), c.data_ptr(), g.data_ptr(), p, width, height, scene.recursion_depth,
              scene.num_lights, int(scene.params.materials.roughness.shape[0]), mk.kernel_flags(scene, T.VERBATIM))
        out[j] = g.double()
    return out


def frame_case(width: int, height: int, seed: int, family: str = "sdf"):
    """A phase's case on the CPU: the family's demo scene, its key, its
    packed vector and the numpy-seeded cotangent."""
    scene, key = make_family_scene(family), rng.prng_key(seed)
    sv = mk.BACKENDS[family].pack(scene, width, height).contiguous()
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((height, width, 4)).astype(np.float32))
    return scene, key, sv, ct


def grazing_witness(width: int, height: int, seed: int, below: float, device: str, family: str = "sdf",
                    libs: dict | None = None) -> dict:
    """The pixels a phase masks beside the knife-edge ones (moved_pixels:
    phase 13's grazing SDF hits, phase 21's near-edge mesh hits, the
    analytical scene's grazing hits; found on `device`), each
    differentiated alone by the host build under both contraction modes
    and, summed, by the plain version on the CPU: for each mode, what the
    set adds to the phase's two numbers (max|d| over max|g| of the whole
    frame's plain gradient, which runs on `device`, and the largest
    relative error among the frame's entries above 1e-2 max|g|), and the
    largest per-pixel gap between the two modes over that max|g|. `libs`
    holds the family's host build of each mode (built here if None)."""
    scene, key, sv, ct = frame_case(width, height, seed, family)
    dev_scene = make_family_scene(family, device=device)
    pixels = moved_pixels(dev_scene, key, width, height, below)
    frame = mk.render_grad_reference(sv.to(device), dev_scene, key, ct.to(device), width, height)[0].double().cpu()
    scale = frame.abs().max()
    big = frame.abs() > 1e-2 * scale
    out, per_pixel = dict(pixels=len(pixels)), {}
    if not len(pixels):
        return {**out, **{contract: (0.0, 0.0) for contract in CONTRACT}, "modes": 0.0}
    ref = plain(scene, key, sv, ct, width, height, pixels)[1]
    libs = libs or {contract: build(flags, Path(tempfile.mkdtemp(prefix="k2_rounding_")), family)
                    for contract, flags in CONTRACT.items()}
    for contract in CONTRACT:
        per_pixel[contract] = pixel_grads(libs[contract], scene, key, sv, ct, width, height, pixels)
        d = (per_pixel[contract].sum(0) - ref).abs()
        out[contract] = (float(d.max() / scale), float((d[big] / frame.abs()[big]).max()))
    out["modes"] = float((per_pixel["fast"] - per_pixel["off"]).abs().max() / scale)
    return out


def host_trainer(lib, width: int, height: int, steps: int):
    """recover_demo(scene="sdf") on the CPU with the SDF host build in the
    place of K1 and K2 (its frames and its gradients), as chip_smoke.py
    phase 15 runs the kernel path on the card."""

    class HostFrame(torch.autograd.Function):
        @staticmethod
        def forward(ctx, sv, scene, key):
            sv, keys = sv.detach().contiguous(), launch_keys(key, 1)
            counts = torch.tensor(mks.sdf_counts(scene), dtype=torch.int32)
            shape = (width, height, 1, scene.recursion_depth, scene.num_lights,
                     int(scene.params.materials.roughness.shape[0]), mk.kernel_flags(scene, T.VERBATIM))
            img = torch.empty((height, width, 4))
            lib.host_render_sdf(sv.data_ptr(), counts.data_ptr(), keys.data_ptr(), img.data_ptr(), *shape)
            ctx.held = (sv, counts, keys, shape)
            return img

        @staticmethod
        def backward(ctx, ct):
            sv, counts, keys, shape = ctx.held
            ct, g = ct.contiguous(), torch.zeros(sv.shape[1])
            lib.host_grad_sdf(sv.data_ptr(), counts.data_ptr(), keys.data_ptr(), ct.data_ptr(), g.data_ptr(), *shape)
            return g[None], None, None

    real = inverse.render_frame_megakernel
    inverse.render_frame_megakernel = lambda scene, key, w, h, spp, quirks: HostFrame.apply(
        mks.pack_sdf_scene(scene, w, h), scene, key)
    try:
        return inverse.recover_demo(key=rng.prng_key(0), scene="sdf", width=width, height=height, steps=steps,
                                    kernel="megakernel", device="cpu", verbose=False)
    finally:
        inverse.render_frame_megakernel = real


def one_pixel(lib, width: int, height: int, seed: int, pixel: int) -> tuple[float, list]:
    """max|d|/max|g| of the SDF scene's host K2 and the plain version on one
    pixel (spp 1, VERBATIM, phase 13's cotangent), and |<rd, n>| at the
    plain path's hits, bounce by bounce (None where the lane is dead or
    misses)."""
    scene, key, sv, ct = frame_case(width, height, seed)
    idx = torch.tensor([pixel])
    g = pixel_grads(lib, scene, key, sv, ct, width, height, idx)[0]
    ref = plain(scene, key, sv, ct, width, height, idx)[1]
    cos = mks.hit_cosines(scene, key, width, height, pixels=idx)[0, :, 0].tolist()
    return float((g - ref).abs().max() / ref.abs().max()), [None if c == float("inf") else c for c in cos]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--seed", type=int, default=24)
    ap.add_argument("--seeds", type=int, nargs="+", default=None, help="(--grazing) several frames, one per seed")
    ap.add_argument("--contract", choices=tuple(CONTRACT), default="fast")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--scene", choices=tuple(ENTRIES), default="analytical")
    ap.add_argument("--pixel", type=int, default=None, help="(--scene sdf) differentiate this pixel alone")
    ap.add_argument("--grazing", type=float, default=None, metavar="BELOW",
                    help="the pixels with a hit the ray's last bits can move (|<rd, n>| < BELOW; on the mesh a "
                    "barycentric margin < BELOW), alone, in both modes")
    ap.add_argument("--device", default="cpu", help="(--grazing) where to find the pixels and the frame's gradient")
    ap.add_argument("--media", choices=tuple(MEDIA_CASES), default=None,
                    help="K2's MEDIA instantiation on the analytical glass filled with this medium")
    ap.add_argument("--spp", type=int, default=1, help="(--media) samples a pixel")
    ap.add_argument("--fixed", action="store_true", help="(--media) the FIXED quirks")
    ap.add_argument("--below", type=float, nargs="*", default=(), help="(--media) grazing thresholds to mask")
    ap.add_argument("--trainer", type=int, default=None, metavar="STEPS",
                    help="(--scene sdf) the SDF trainer through the host build against the eager one")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    if args.media is not None:
        libs = {contract: build_media(flags, Path(tempfile.mkdtemp(prefix="k2_rounding_")))
                for contract, flags in CONTRACT.items()}
        for seed in args.seeds or [args.seed]:
            out = media_rehearse(libs, args.media, args.width, args.height, seed, args.spp,
                                 T.FIXED if args.fixed else T.VERBATIM, tuple(args.below))
            print(f"media {args.media} {args.width}x{args.height}, spp {args.spp}, "
                  f"{'FIXED' if args.fixed else 'VERBATIM'}, seed {seed}:")
            for contract, res in out.items():
                print(f"  -ffp-contract={contract}: " + "; ".join(
                    f"{k} {v}" if isinstance(v, int) else f"{k}: max|d|/max|g| {v[0]:.3e}, entries > 1e-2 max rel "
                    f"{v[1]:.3e}" for k, v in res.items()))
        return 0
    if args.pixel is not None:
        for contract in CONTRACT:
            lib = build(CONTRACT[contract], Path(tempfile.mkdtemp(prefix="k2_rounding_")), "sdf")
            gap, denoms = one_pixel(lib, args.width, args.height, args.seed, args.pixel)
            print(f"sdf pixel {args.pixel} of {args.width}x{args.height}, seed {args.seed}, "
                  f"-ffp-contract={contract}: max|d|/max|g| {gap:.3e}")
        print(f"|<rd, n>| at the plain path's hits, bounce by bounce: {denoms}")
        return 0
    if args.trainer is not None:
        want = inverse.recover_demo(key=rng.prng_key(0), scene="sdf", width=args.width, height=args.height,
                                    steps=args.trainer, kernel="eager", device="cpu", verbose=False)
        for contract in CONTRACT:
            got = host_trainer(build(CONTRACT[contract], Path(tempfile.mkdtemp(prefix="k2_rounding_")), "sdf"),
                               args.width, args.height, args.trainer)
            loss_rel = np.abs(got.losses.numpy() / want.losses.numpy() - 1.0).max()
            leaf_rel = [abs(a.recovered / b.recovered - 1.0) for a, b in zip(got.rows, want.rows)]
            print(f"sdf trainer {args.width}x{args.height}, {args.trainer} steps, host K1 and K2 with "
                  f"-ffp-contract={contract} against the eager one: losses max rel {loss_rel:.3e}; leaves rel "
                  + ", ".join(f"{r.name} {x:.3e}" for r, x in zip(want.rows, leaf_rel)))
        return 0
    if args.grazing is not None:
        what = (f"a barycentric margin < {args.grazing} or |det| < {MESH_DET}" if args.scene == "mesh"
                else f"|<rd, n>| < {args.grazing}")
        libs = {contract: build(flags, Path(tempfile.mkdtemp(prefix="k2_rounding_")), args.scene)
                for contract, flags in CONTRACT.items()}
        for seed in args.seeds or [args.seed]:
            out = grazing_witness(args.width, args.height, seed, args.grazing, args.device, args.scene, libs)
            print(f"{args.scene} {args.width}x{args.height}, seed {seed}: {out['pixels']} pixels with a hit at {what}")
            for contract in CONTRACT:
                print(f"  their host K2 against the plain version, -ffp-contract={contract}: max|d|/max|g| "
                      f"{out[contract][0]:.3e}, entries > 1e-2 max rel {out[contract][1]:.3e}")
            print(f"  largest per-pixel gap between the modes: {out['modes']:.3e} of max|g|")
        return 0
    lib = build(CONTRACT[args.contract], Path(tempfile.mkdtemp(prefix="k2_rounding_")), args.scene)
    out = rehearse(lib, args.width, args.height, args.seed, args.scene)
    print(f"{args.scene} {args.width}x{args.height}, depth 4, -ffp-contract={args.contract}: {out['edge']} "
          "knife-edge pixels" + (f", {out['near_edge']} more near an edge" if "near_edge" in out else ""))
    for label, key in (("all pixels", "all"), ("knife-edge pixels masked", "masked")):
        print(f"{label}: max|d|/max|g| {out[key][0]:.3e}, entries > 1e-2 max rel {out[key][1]:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
