# Frozen copy of hit_cosines from pathtracer_tpu_torch/ops/megakernel_sdf.py,
# over this package's eager tier.
"""Where a frame's gradient hangs on the last bits of a ray: |<rd, n>| at
each SDF hit of the plain path. The march stops where |sdf| < HIT_EPS
(1e-3), so a hit at |<rd, n>| = c lies anywhere within HIT_EPS / c along
the ray, and the Newton step's dt/dtheta = -(df/dtheta)/<rd, n>, carried
through the bounces before it, takes its value from that point. Where c
is small the program's march and the reference's stop at points far
enough apart that one pixel's share of a geometry leaf's gradient
differs between them by tens of percent. The training check leaves those
pixels out on both sides for one of its numbers (`check.FirstStep`)."""

from __future__ import annotations

import torch

from . import sdf
from . import tracer as T
from .camera import gen_ray, pixel_coords
from .scene import Scene
from .vecmath import V2, dot


def hit_cosines(scene: Scene, key, width: int, height: int) -> torch.Tensor:
    """|<rd, n>| where each bounce of the plain path of one spp-1 frame
    meets an SDF hit, [depth, H*W], +inf where the path is dead or
    misses."""
    p, dev = scene.params.unpack(), scene.device
    coords = pixel_coords(width, height, torch.float64, dev)
    out = []
    with torch.no_grad():
        step = T.make_bounce_step(scene, T.VERBATIM, detach=True)
        cam_u, bounce_u = T.draw_uniforms(key, width * height, scene.recursion_depth, torch.float32, dev)
        ro, rd = gen_ray(scene.camera.unpack(), coords, V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height))
        state = T.init_state(ro, rd, T.VERBATIM)
        for u in bounce_u:
            t, _ = sdf.march(p, state.ro, state.rd)
            hit = sdf.converged(p, state.ro, state.rd, t)
            cos = dot(state.rd, sdf.sdf_normal(p, state.ro + state.rd * torch.where(hit, t, 0.0))).abs()
            out.append(torch.where(state.alive & hit, cos, torch.inf))
            state = step(state, u)
    return torch.stack(out)
