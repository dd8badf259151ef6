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
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pathtracer_tpu_torch.integrator import tracer as T  # noqa: E402
from pathtracer_tpu_torch.models.analytical import make_scene  # noqa: E402
from pathtracer_tpu_torch.models.camera import gen_ray, pixel_coords  # noqa: E402
from pathtracer_tpu_torch.ops import _build, rng  # noqa: E402
from pathtracer_tpu_torch.ops import megakernel as mk  # noqa: E402
from pathtracer_tpu_torch.ops.vecmath import V2  # noqa: E402
from test_torch_kernel_bwd_host import SHIM as BWD_SHIM  # noqa: E402
from test_torch_kernel_host import PRELUDE, SHIM as FWD_SHIM, launch_keys  # noqa: E402

EDGE_TOL, GRAD_MAX_TOL, GRAD_RTOL = 1e-3, 1e-2, 2e-2
CONTRACT = {"fast": ["-mfma", "-ffp-contract=fast"], "off": ["-ffp-contract=off"]}


def build(flags: list[str], directory: Path) -> ctypes.CDLL:
    """Both host shims in one library; the unfused intrinsics stay out of
    line, so contraction cannot merge them."""
    source = (BWD_SHIM + FWD_SHIM[len(PRELUDE):]).replace(
        "static inline float __f", "__attribute__((noinline)) static float __f")
    (directory / "shim.cpp").write_text(source)
    so = directory / "libshim.so"
    subprocess.run(["g++", "-O2", "-std=c++17", *flags, "-shared", "-fPIC", "-I", str(_build.CSRC),
                    "-o", str(so), str(directory / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_grad.argtypes = [p, p, p, p, i, i, i, i, i, i, i]
    lib.host_render.argtypes = [p, p, p, i, i, i, i, i, i, i]
    return lib


def plain(scene, key, sv, ct, width: int, height: int, chunk: int = 65536):
    """The plain version's frame and d(<ct, frame>)/d(sv), in pixel chunks
    (its autograd holds every intermediate)."""
    n = width * height
    cam_u, bounce_u = T.draw_uniforms(key, n, scene.recursion_depth, torch.float32)
    coords = pixel_coords(width, height, torch.float64)
    leaf = sv.detach().clone().requires_grad_(True)
    grad = torch.zeros(sv.shape[1], dtype=torch.float64)
    frame, ct = [], ct.reshape(-1, 4)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        s, basis = mk.unpack_scene(leaf, scene)
        ro, rd = gen_ray(None, V2(coords.x[a:b], coords.y[a:b]), V2(cam_u[a:b, 0], cam_u[a:b, 1]),
                         float(width), float(height), basis)
        rad = T.trace(s, ro, rd, bounce_u[:, a:b], T.VERBATIM, detach=True)
        frame.append(torch.stack([rad.x, rad.y, rad.z], -1).detach())
        loss = sum((rad[c] * ct[a:b, c]).sum() for c in range(3))
        grad += torch.autograd.grad(loss, leaf)[0][0].double()
    return torch.cat(frame).reshape(height, width, 3), grad


def grad_gap(g: torch.Tensor, r: torch.Tensor) -> tuple[float, float]:
    """(max|d|/max|g|, the largest relative error among entries above 1e-2
    max|g|)."""
    scale = r.abs().max()
    big = r.abs() > 1e-2 * scale
    d = (g - r).abs()
    return float(d.max() / scale), float((d[big] / r.abs()[big]).max())


def rehearse(lib, width: int, height: int, seed: int) -> dict:
    """Phase 6's comparison on the host: the knife-edge pixel count and the
    gap over all pixels and with the knife-edge pixels masked."""
    scene, key = make_scene(), rng.prng_key(seed)
    sv, keys = mk.pack_scene(scene, width, height).contiguous(), launch_keys(key, 1)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((height, width, 4)).astype(np.float32))
    shape = (width, height, 1, scene.recursion_depth, scene.num_lights, 3, mk.kernel_flags(scene, T.VERBATIM))

    def host_grad(c):
        c, g = c.contiguous(), torch.zeros(sv.shape[1])  # held: the library reads their memory
        lib.host_grad(sv.data_ptr(), keys.data_ptr(), c.data_ptr(), g.data_ptr(), *shape)
        return g.double()

    img = torch.empty((height, width, 4))
    lib.host_render(sv.data_ptr(), keys.data_ptr(), img.data_ptr(), *shape)
    frame, ref = plain(scene, key, sv, ct, width, height)
    edge = (img[..., :3] - frame).abs().amax(-1) > EDGE_TOL
    out = dict(edge=int(edge.sum()), all=grad_gap(host_grad(ct), ref))
    if out["edge"]:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--seed", type=int, default=24)
    ap.add_argument("--contract", choices=tuple(CONTRACT), default="fast")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    lib = build(CONTRACT[args.contract], Path(tempfile.mkdtemp(prefix="k2_rounding_")))
    out = rehearse(lib, args.width, args.height, args.seed)
    print(f"{args.width}x{args.height}, depth 4, -ffp-contract={args.contract}: {out['edge']} knife-edge pixels")
    for label, key in (("all pixels", "all"), ("knife-edge pixels masked", "masked")):
        print(f"{label}: max|d|/max|g| {out[key][0]:.3e}, entries > 1e-2 max rel {out[key][1]:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
