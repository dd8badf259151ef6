# Frozen copy of count_segments, count_sdf_work and what they use from
# pathtracer_tpu_torch/tools/work.py, over this package's eager tier.
"""What one frame asks of K1 and K2, counted from the plain reference on
the same threefry numbers: the ray segments (bounces entered by a live
path) and, for the SDF scene, the steps of every march. The rooflines
(`portbench/roofline.py`) multiply these counts by the frozen operation
counts.

A shadow ray is counted where K1 casts one (`csrc/tracer.cuh` bounce and
direct_light): on a live path that hits the geometry and not an emitter,
with the light sample's surface facing the scatter point. The SDF
closest hit marches uncapped, each shadow ray capped at its max_dist, as
`csrc/sdf.cuh` caps it. The lanes' own work is counted, each input's
work once.
"""

from __future__ import annotations

from unittest import mock

import torch

from . import sdf
from . import tracer as T
from .camera import gen_ray, pixel_coords
from .scene import Scene
from .vecmath import V2, dot


def count_segments(scene: Scene, key, width: int, height: int, per_bounce=None) -> int:
    """Ray segments of one spp-1 frame; per_bounce(alive) is called after
    each bounce with the lanes that entered it."""
    with torch.no_grad():
        cam_u, bounce_u = T.draw_uniforms(key, width * height, scene.recursion_depth, scene.dtype, scene.device)
        coords = pixel_coords(width, height, torch.float64, scene.device)
        ro, rd = gen_ray(scene.camera.unpack(), coords, V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height))
        state = T.init_state(ro, rd, T.VERBATIM)
        step = T.make_bounce_step(scene, T.VERBATIM, detach=True)
        alive = []
        for u in bounce_u:
            alive.append(state.alive)
            state = step(state, u)
            if per_bounce is not None:
                per_bounce(alive[-1])
        return int(torch.stack(alive).sum())


def _count_walks(scene: Scene, key, width: int, height: int, closest, shadow, tally) -> int:
    """count_segments with the closest hit and the shadow ray replaced by
    closest(seen, p, ro, rd) and shadow(seen, p, ro, rd, max_dist), which
    return the plain results and put what they count in `seen`; after each
    bounce tally(alive, cast, seen) gets the lanes that entered it and
    those that cast a shadow ray."""
    seen = {}
    sample_light, sample_lights_emitter = T.sample_light, T.sample_lights_emitter

    def emitter(*args, **kw):
        em = sample_lights_emitter(*args, **kw)
        seen["em_hit"] = em.hit
        return em

    def light(*args, **kw):
        ls = sample_light(*args, **kw)
        seen["facing"] = dot(ls.direction, ls.normal) < 0.0
        return ls

    def on_bounce(alive):
        cast = alive & seen["geo_hit"] & ~seen["em_hit"] & seen.pop("facing", torch.zeros_like(alive))
        tally(alive, cast, seen)
        seen.pop("shadow", None)

    counting = scene.replace(closest_hit_fn=lambda p, ro, rd: closest(seen, p, ro, rd),
                             any_hit_fn=lambda p, ro, rd, max_dist: shadow(seen, p, ro, rd, max_dist))
    with mock.patch.object(T, "sample_light", light), mock.patch.object(T, "sample_lights_emitter", emitter):
        return count_segments(counting, key, width, height, on_bounce)


def count_sdf_work(scene: Scene, key, width: int, height: int) -> dict:
    """Every march of one spp-1 frame of an SDF scene: `segments`,
    `shadow_rays` (those K1 casts), and the steps of the closest hits'
    marches (`closest_trips`) and of the shadow rays' (`shadow_trips`),
    summed over the lanes."""
    total = dict(closest_trips=0, shadow_trips=0, shadow_rays=0)
    march = sdf.march

    def closest(seen, p, ro, rd):
        steps = []

        def recording(*args, **kw):
            t, s = march(*args, **kw)
            steps.append(s)
            return t, s

        with mock.patch.object(sdf, "march", recording):
            hit = sdf.closest_hit(p, ro, rd)
        seen["geo_hit"], seen["closest"] = torch.isfinite(hit.t), steps[0].reshape(-1)
        return hit

    def shadow(seen, p, ro, rd, max_dist):
        seen["shadow"] = march(p, ro, rd, t_cap=torch.as_tensor(max_dist))[1].reshape(-1)
        return sdf.any_hit(p, ro, rd, max_dist)

    def tally(alive, cast, seen):
        total["shadow_rays"] += int(cast.sum())
        for name, mask in (("closest", alive), ("shadow", cast)):
            if name in seen:
                total[f"{name}_trips"] += int(seen[name].to(torch.int64)[mask.reshape(-1)].sum())

    total["segments"] = _count_walks(scene, key, width, height, closest, shadow, tally)
    return total


def count_work(scene: Scene, family: str, key, width: int, height: int) -> dict:
    """The counts the family's bounds take: `segments`, and for the SDF
    scene `march_steps` (every march's steps) too."""
    if family == "sdf":
        w = count_sdf_work(scene, key, width, height)
        return {"segments": w["segments"], "march_steps": w["closest_trips"] + w["shadow_trips"]}
    return {"segments": count_segments(scene, key, width, height)}
