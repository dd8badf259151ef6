"""The path-tracing integrator: progressive Monte Carlo with NEE and MIS.

Port of `pathtracer_tpu/integrator/tracer.py` in eager PyTorch. The whole
frame is one flat ray batch walked bounce by bounce with an `alive` mask:
every lane runs every bounce, and a dead lane's state is frozen. Random
numbers are the threefry stream of `ops/rng`, bit-equal to the JAX
package's, so this tier is held to JAX and to the float64 CPU oracle
image for image. It is also the plain version of the CUDA megakernel
(`ops/megakernel.py`).

Kept from the reference, behind `Quirks`:
- `stale_emitter_gate`: the emitter pass is gated by the hit distance
  carried from the previous bounce when this bounce misses geometry
  (-1 on the primary ray, so camera-visible lights render as background);
- `primary_mis`: an emitter hit is always MIS-weighted with the previous
  scatter pdf, which is 0 on the primary ray.

This slice implements the `mis` estimator on media-free scenes; media and
the `bsdf`/`nee` estimators raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..models.camera import gen_ray, pixel_coords
from ..models.light import Lights, gather_light
from ..models.material import Material, finalize_material
from ..models.scene import Scene
from ..ops import rng
from ..ops.bsdf import disney_eval, disney_sample
from ..ops.intersect import ray_rect, ray_sphere
from ..ops.sampling import power_heuristic, uniform_sample_hemisphere
from ..ops.vecmath import (
    V2,
    V3,
    dot,
    mask3,
    onb,
    safe_normalize,
    splat3,
    to_world,
    where3,
    zeros3,
)

EPS = 0.005

# Uniforms per bounce: [light pick, light r1, light r2, bsdf r1, bsdf r2,
# reflect/refract coin, alpha coin, scatter distance].
U_PER_BOUNCE = 8


@dataclasses.dataclass(frozen=True)
class Quirks:
    """Keep (True) or fix (False) the reference's integrator bugs."""

    stale_emitter_gate: bool = True
    primary_mis: bool = True


VERBATIM = Quirks()
FIXED = Quirks(stale_emitter_gate=False, primary_mis=False)


class EmitterHit(NamedTuple):
    hit: torch.Tensor
    dist: torch.Tensor
    pdf: torch.Tensor
    emission: V3


def _light(lights: Lights, i: int) -> dict:
    """Light i's fields as 0-d tensors (no host sync)."""
    at = lambda w: V3(w.x[i], w.y[i], w.z[i])
    return dict(
        light_type=lights.light_type[i],
        position=at(lights.position),
        emission=at(lights.emission),
        u=at(lights.u),
        v=at(lights.v),
        radius=lights.radius[i],
        area=lights.area[i],
    )


def sample_lights_emitter(lights: Lights, ro: V3, rd: V3, gate_dist) -> EmitterHit:
    """Ray vs every light, in light order with strict `d < dist`:
    spherical (pdf d^2 / (0.5 area cos)), rectangular (d^2 / (area cos));
    distant lights are never hit."""
    dtype = rd.x.dtype
    dist = torch.broadcast_to(torch.as_tensor(gate_dist, dtype=dtype, device=rd.x.device), rd.x.shape)
    hit = torch.zeros(rd.x.shape, dtype=torch.bool, device=rd.x.device)
    pdf = torch.zeros_like(rd.x)
    emission = zeros3(rd.x.shape, dtype, rd.x.device)

    for i in range(lights.count):
        lt = _light(lights, i)
        is_spherical = lt["light_type"] == 1
        is_rect = lt["light_type"] == 0
        d_s = ray_sphere(ro, rd, lt["position"], lt["radius"])
        d_r = ray_rect(ro, rd, lt["position"], lt["u"], lt["v"])
        d = torch.where(is_spherical, d_s, torch.where(is_rect, d_r, math.inf))
        take = torch.isfinite(d) & (d < dist) & (is_spherical | is_rect)
        d_safe = torch.where(take, d, 1.0)
        hit_point = ro + rd * torch.where(take, d_safe, 0.0)
        sph_normal = safe_normalize(hit_point - lt["position"])
        rect_normal = safe_normalize(lt["u"].cross(lt["v"]))
        normal = where3(is_spherical, sph_normal, rect_normal)
        cos_theta = dot(-rd, normal)
        half = torch.where(is_spherical, 0.5, 1.0).to(dtype)
        denom = lt["area"] * cos_theta * half
        pdf_i = (d_safe * d_safe) / torch.where(denom != 0.0, denom, 1.0)
        dist = torch.where(take, d_safe, dist)
        pdf = torch.where(take, pdf_i, pdf)
        emission = where3(take, emission * 0.0 + lt["emission"], emission)
        hit = hit | take

    return EmitterHit(hit=hit, dist=dist, pdf=pdf, emission=emission)


class LightSample(NamedTuple):
    normal: V3
    emission: V3
    direction: V3
    dist: torch.Tensor
    pdf: torch.Tensor


def _detach_sample(ls: LightSample, detach: bool) -> LightSample:
    if not detach:
        return ls
    d3 = lambda w: V3(w.x.detach(), w.y.detach(), w.z.detach())
    return ls._replace(
        normal=d3(ls.normal), direction=d3(ls.direction),
        dist=ls.dist.detach(), pdf=ls.pdf.detach(),
    )


def sample_light_spherical(
    lights: Lights, idx, scatter_pos: V3, r1, r2, detach: bool = False
) -> LightSample:
    """Uniform hemisphere about the center-to-point axis; emission times
    the light count; pdf d^2 / (0.5 area |n.l|)."""
    lt = gather_light(lights, idx)
    center_to_surf = scatter_pos - lt.position
    dist_to_center = center_to_surf.length()
    axis = center_to_surf / splat3(torch.where(dist_to_center > 0.0, dist_to_center, 1.0))

    sampled = uniform_sample_hemisphere(r1, r2)
    t, b = onb(axis)
    sampled_dir = to_world(t, b, axis, sampled)

    light_surface = lt.position + sampled_dir * splat3(lt.radius)
    direction = light_surface - scatter_pos
    dist = direction.length()
    dist_sq = dist * dist
    direction = direction / splat3(torch.where(dist > 0.0, dist, 1.0))
    normal = safe_normalize(light_surface - lt.position)

    emission = lt.emission * float(lights.count)
    denom = lt.area * 0.5 * torch.abs(dot(normal, direction))
    pdf = dist_sq / torch.where(denom != 0.0, denom, 1.0)
    return _detach_sample(LightSample(normal, emission, direction, dist, pdf), detach)


def sample_light_rect(
    lights: Lights, idx, scatter_pos: V3, r1, r2, detach: bool = False
) -> LightSample:
    """Uniform point on the quad; pdf d^2 / (area |n.l|)."""
    lt = gather_light(lights, idx)
    light_surface = lt.position + lt.u * splat3(r1) + lt.v * splat3(r2)
    direction = light_surface - scatter_pos
    dist = direction.length()
    dist_sq = dist * dist
    direction = direction / splat3(torch.where(dist > 0.0, dist, 1.0))
    normal = safe_normalize(lt.u.cross(lt.v))

    emission = lt.emission * float(lights.count)
    denom = lt.area * torch.abs(dot(normal, direction))
    pdf = dist_sq / torch.where(denom != 0.0, denom, 1.0)
    return _detach_sample(LightSample(normal, emission, direction, dist, pdf), detach)


def sample_light_distant(
    lights: Lights, idx, scatter_pos: V3, detach: bool = False
) -> LightSample:
    """Fixed direction (stored in `position`), dist = inf, pdf = 1."""
    lt = gather_light(lights, idx)
    direction = safe_normalize(lt.position)
    normal = safe_normalize(scatter_pos - lt.position)
    emission = lt.emission * float(lights.count)
    return _detach_sample(
        LightSample(
            normal, emission, direction,
            torch.full_like(lt.area, math.inf), torch.ones_like(lt.area),
        ),
        detach,
    )


def sample_light(
    lights: Lights, idx, scatter_pos: V3, r1, r2, detach: bool = False
) -> LightSample:
    """Type-dispatched light sampling, selected per lane by light type."""
    t = gather_light(lights, idx).light_type
    sph = sample_light_spherical(lights, idx, scatter_pos, r1, r2, detach)
    rect = sample_light_rect(lights, idx, scatter_pos, r1, r2, detach)
    dst = sample_light_distant(lights, idx, scatter_pos, detach)

    def pick(a, b, c):  # rect=0, spherical=1, distant=2
        return torch.where(t == 1, b, torch.where(t == 0, a, c))

    def pick3(a, b, c):
        return V3(pick(a.x, b.x, c.x), pick(a.y, b.y, c.y), pick(a.z, b.z, c.z))

    return LightSample(
        normal=pick3(rect.normal, sph.normal, dst.normal),
        emission=pick3(rect.emission, sph.emission, dst.emission),
        direction=pick3(rect.direction, sph.direction, dst.direction),
        dist=pick(rect.dist, sph.dist, dst.dist),
        pdf=pick(rect.pdf, sph.pdf, dst.pdf),
    )


def direct_light(
    scene: Scene, rd: V3, fhp: V3, ffnormal: V3, material: Material, eta, u,
    detach: bool = False,
) -> V3:
    """Next-event estimation: pick one light uniformly, sample it, test the
    shadow ray, MIS-weight against the BSDF pdf. u = [..., 3]
    (pick, r1, r2)."""
    u_pick, r1, r2 = u[..., 0], u[..., 1], u[..., 2]
    n_lights = scene.num_lights
    if n_lights == 0:
        return zeros3(rd.x.shape, rd.x.dtype, rd.x.device)
    lights = scene.lights.unpack()

    scatter_pos = fhp + ffnormal * EPS
    # Truncation toward zero, as the reference's int cast.
    idx = torch.clamp((u_pick * n_lights).to(torch.int64), 0, n_lights - 1)
    ls = sample_light(lights, idx, scatter_pos, r1, r2, detach)

    facing = dot(ls.direction, ls.normal) < 0.0
    in_shadow = scene.any_hit(scatter_pos, ls.direction, ls.dist - EPS)
    f, bsdf_pdf = disney_eval(material, eta, -rd, ffnormal, ls.direction)

    area = gather_light(lights, idx).area
    mis_w = torch.where(area > 0.0, power_heuristic(ls.pdf, bsdf_pdf), 1.0)
    ok = facing & (~in_shadow) & (bsdf_pdf > 0.0) & (ls.pdf > 0.0)
    scale = torch.where(ok, mis_w / torch.where(ls.pdf != 0.0, ls.pdf, 1.0), 0.0)
    return ls.emission * f * scale


class PathState(NamedTuple):
    """Per-lane bounce-loop state."""

    ro: V3
    rd: V3
    radiance: V3
    throughput: V3
    alive: torch.Tensor
    prev_pdf: torch.Tensor  # scatter pdf of the previous bounce
    prev_l: V3  # scatter direction of the previous bounce (stale-l quirk)
    prev_hit_dist: torch.Tensor  # hit distance carry (stale-gate quirk)


def has_media(scene: Scene) -> bool:
    return bool((scene.params.materials.medium.medium_type != 0).any())


def make_bounce_step(
    scene: Scene, quirks: Quirks = VERBATIM, detach: bool = False,
    estimator: str = "mis",
):
    """One bounce of the per-pixel loop, batched: closest hit, emitter
    pass with MIS, background, emission, alpha pass-through, NEE and the
    Disney sample that sets the next ray."""
    if estimator not in ("mis", "bsdf", "nee"):
        raise ValueError(f"unknown estimator {estimator!r}")
    if estimator != "mis":
        raise NotImplementedError(f"estimator {estimator!r} is not ported yet")
    if has_media(scene):
        raise NotImplementedError("participating media are not ported yet")

    def bounce(state: PathState, u: torch.Tensor) -> PathState:
        ro, rd = state.ro, state.rd
        radiance, throughput = state.radiance, state.throughput
        alive = state.alive

        geo = scene.closest_hit(ro, rd)
        geo_hit = torch.isfinite(geo.t)
        if quirks.stale_emitter_gate:
            gate_dist = torch.where(geo_hit, geo.t, state.prev_hit_dist)
        else:
            gate_dist = torch.where(geo_hit, geo.t, math.inf)
        em = sample_lights_emitter(scene.lights.unpack(), ro, rd, gate_dist)

        hit = geo_hit | em.hit
        hit_dist = torch.where(em.hit, em.dist, gate_dist)

        # Miss: background times throughput, and the path dies.
        bg = scene.background(rd)
        radiance = radiance + mask3(alive & ~hit, bg * throughput)

        material = finalize_material(geo.material)
        fhp = ro + rd * torch.where(hit, hit_dist, 0.0)
        entering = dot(geo.normal, rd) <= 0.0
        ffnormal = where3(entering, geo.normal, -geo.normal)
        eta = torch.where(dot(rd, geo.normal) < 0.0, 1.0 / material.ior, material.ior)

        # Alpha pass-through: Blend skips the surface when the alpha coin
        # exceeds opacity, Mask when opacity < cutoff. Emitters never do.
        am = material.alpha_mode
        alpha_fail = ((am == 1) & (u[..., 6] > material.opacity)) | (
            (am == 2) & (material.opacity < material.alpha_cutoff)
        )
        passthru = alive & hit & ~em.hit & alpha_fail

        radiance = radiance + mask3(alive & hit & ~passthru, material.emission * throughput)

        # Emitter hit, MIS-weighted with the previous bounce's scatter pdf.
        mis_w = power_heuristic(torch.clamp_min(state.prev_pdf, 0.0), em.pdf)
        if not quirks.primary_mis:
            mis_w = torch.where(state.prev_pdf < 0.0, 1.0, mis_w)
        radiance = radiance + mask3(alive & em.hit, em.emission * (mis_w * 1.0) * throughput)

        shade = alive & hit & ~em.hit & ~passthru

        ld = direct_light(scene, rd, fhp, ffnormal, material, eta, u[..., 0:3], detach)
        radiance = radiance + mask3(shade, ld * throughput)

        bs = disney_sample(material, eta, -rd, ffnormal, state.prev_l, u[..., 3:6], detach)
        cont = shade & (bs.pdf > 0.0)
        safe_pdf = torch.where(bs.pdf > 0.0, bs.pdf, 1.0)
        throughput = where3(cont, throughput * bs.f / splat3(safe_pdf), throughput)

        ro_next = where3(cont, fhp + bs.l * EPS, ro)
        rd_next = where3(cont, bs.l, rd)
        ro_next = where3(passthru, fhp + rd * EPS, ro_next)
        rd_next = where3(passthru, rd, rd_next)

        return PathState(
            ro=ro_next,
            rd=rd_next,
            radiance=radiance,
            throughput=throughput,
            alive=cont | passthru,
            prev_pdf=torch.where(shade, bs.pdf, state.prev_pdf),
            prev_l=where3(shade, bs.l, state.prev_l),
            prev_hit_dist=torch.where(alive & hit, hit_dist, state.prev_hit_dist),
        )

    return bounce


def init_state(ro: V3, rd: V3, quirks: Quirks = VERBATIM) -> PathState:
    """Fresh path state for a batch of primary rays."""
    n, dtype, device = rd.x.shape, rd.x.dtype, rd.x.device
    full = lambda c: torch.full(n, c, dtype=dtype, device=device)
    return PathState(
        ro=ro,
        rd=rd,
        radiance=zeros3(n, dtype, device),
        throughput=splat3(full(1.0)),
        alive=torch.ones(n, dtype=torch.bool, device=device),
        # -1: "no previous bounce", which gives primaries weight 1 (FIXED).
        prev_pdf=full(0.0 if quirks.primary_mis else -1.0),
        prev_l=zeros3(n, dtype, device),
        prev_hit_dist=full(-1.0),
    )


def trace(
    scene: Scene, ro: V3, rd: V3, uniforms: torch.Tensor,
    quirks: Quirks = VERBATIM, detach: bool = False, estimator: str = "mis",
) -> V3:
    """Trace primary rays to radiance; uniforms [depth, N, U_PER_BOUNCE]."""
    state = init_state(ro, rd, quirks)
    bounce = make_bounce_step(scene, quirks, detach, estimator)
    for u in uniforms:
        state = bounce(state, u)
    return state.radiance


def draw_uniforms(key, n: int, depth: int, dtype=torch.float32, device=None):
    """Per-frame randomness (cam jitter [N, 2], bounce uniforms
    [depth, N, 8]), bit-equal to the JAX package's `draw_uniforms`."""
    kc, kb = rng.split(key)
    cam = rng.uniform(kc, (n, 2), dtype, device)
    bounce = rng.uniform(kb, (depth, n, U_PER_BOUNCE), dtype, device)
    return cam, bounce


def render_frame(
    scene: Scene,
    key,
    width: int,
    height: int,
    spp: int = 1,
    quirks: Quirks = VERBATIM,
    detach: bool = False,
    estimator: str = "mis",
    uniforms: tuple | None = None,
) -> torch.Tensor:
    """Render one progressive frame -> [H, W, 4] linear RGBA (alpha 1) on
    the scene's device. `uniforms=(cam [N, 2], bounce [depth, N, 8])`
    replaces the key's stream (spp 1 only), so tests can feed JAX's
    float64 stream."""
    dtype, device = scene.dtype, scene.device
    n = width * height
    coords = pixel_coords(width, height, dtype, device)
    depth = scene.recursion_depth
    cam = scene.camera.unpack()

    def one_sample(u):
        cam_u, bounce_u = u
        offset = V2(cam_u[:, 0], cam_u[:, 1])
        ro, rd = gen_ray(cam, coords, offset, float(width), float(height))
        return trace(scene, ro, rd, bounce_u, quirks, detach, estimator)

    if uniforms is not None:
        if spp != 1:
            raise ValueError("explicit uniforms need spp == 1")
        radiance = one_sample(uniforms)
    elif spp == 1:
        radiance = one_sample(draw_uniforms(key, n, depth, dtype, device))
    else:
        acc = [
            one_sample(draw_uniforms(k, n, depth, dtype, device))
            for k in rng.split(key, spp)
        ]
        radiance = V3(*[torch.stack([a[c] for a in acc]).mean(dim=0) for c in range(3)])

    return torch.stack(
        [
            radiance.x.reshape(height, width),
            radiance.y.reshape(height, width),
            radiance.z.reshape(height, width),
            torch.ones((height, width), dtype=dtype, device=device),
        ],
        dim=-1,
    )


def accumulate(pixels: torch.Tensor, frame: torch.Tensor, frames):
    """Progressive running mean with weight 1/(frames+1); returns
    (new_pixels, frames + 1)."""
    w = 1.0 / (frames + 1.0)
    return pixels * (1.0 - w) + frame * w, frames + 1
