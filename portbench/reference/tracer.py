# Frozen copy of pathtracer_tpu_torch/integrator/tracer.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
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

Participating media (the material's `medium`: Absorb, Emissive, HG
single Scatter) and the three direct-lighting estimators (`mis`, `bsdf`,
`nee`) are the JAX package's. A media-free scene skips the media segment,
whose every term is masked off there, as the kernel's media-free
instantiation compiles none of it.

A render may take a range of the frame's flat pixels (`pixels=(p_begin,
p_count)`): it traces only those rays, each from the uniforms at its
global counters, so the range's pixels are the whole frame's bit for bit
(the rank's share of a sharded render, `parallel/mesh`), and the frame is
zero elsewhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .camera import gen_ray, pixel_coords
from .light import Lights, gather_light
from .material import Material, finalize_material
from .scene import Scene
from . import rng
from .bsdf import disney_eval, disney_sample
from .intersect import ray_rect, ray_sphere
from .sampling import hg_phase, power_heuristic, sample_hg, uniform_sample_hemisphere
from .vecmath import (
    V2,
    V3,
    dot,
    mask3,
    maximum,
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
    detach: bool = False, mis: bool = True,
) -> V3:
    """Next-event estimation: pick one light uniformly, sample it, test the
    shadow ray, MIS-weight against the BSDF pdf. u = [..., 3]
    (pick, r1, r2). mis=False weighs the light sample 1 (the NEE-only
    estimator)."""
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
    if mis:
        mis_w = torch.where(area > 0.0, power_heuristic(ls.pdf, bsdf_pdf), 1.0)
    else:
        mis_w = torch.ones_like(ls.pdf)
    ok = facing & (~in_shadow) & (bsdf_pdf > 0.0) & (ls.pdf > 0.0)
    scale = torch.where(ok, mis_w / torch.where(ls.pdf != 0.0, ls.pdf, 1.0), 0.0)
    return ls.emission * f * scale


def scatter_direct_light(
    scene: Scene, rd: V3, scatter_pos: V3, g, u, detach: bool = False, mis: bool = True,
) -> V3:
    """Next-event estimation from a volumetric scatter point: direct_light
    with the HG phase p(cos; g) in place of the BSDF, as value and as pdf
    (HG sampling is exact)."""
    u_pick, r1, r2 = u[..., 0], u[..., 1], u[..., 2]
    n_lights = scene.num_lights
    if n_lights == 0:
        return zeros3(rd.x.shape, rd.x.dtype, rd.x.device)
    lights = scene.lights.unpack()

    idx = torch.clamp((u_pick * n_lights).to(torch.int64), 0, n_lights - 1)
    ls = sample_light(lights, idx, scatter_pos, r1, r2, detach)

    facing = dot(ls.direction, ls.normal) < 0.0
    in_shadow = scene.any_hit(scatter_pos, ls.direction, ls.dist - EPS)
    p = hg_phase(dot(rd, ls.direction), g)
    area = gather_light(lights, idx).area
    if mis:
        mis_w = torch.where(area > 0.0, power_heuristic(ls.pdf, p), 1.0)
    else:
        mis_w = torch.ones_like(ls.pdf)
    ok = facing & (~in_shadow) & (p > 0.0) & (ls.pdf > 0.0)
    scale = torch.where(ok, mis_w * p / torch.where(ls.pdf != 0.0, ls.pdf, 1.0), 0.0)
    return ls.emission * splat3(scale)


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
    # The medium the ray travels in (type 0: vacuum): Absorb attenuates by
    # exp(-(1 - color) density t) a segment, Emissive adds color density t,
    # Scatter samples an exponential free flight and scatters by HG.
    med_type: torch.Tensor  # int32
    med_density: torch.Tensor
    med_color: V3
    med_aniso: torch.Tensor  # HG g, clamped to +-0.9 by finalize_material


def has_media(scene: Scene) -> bool:
    return bool((scene.params.materials.medium.medium_type != 0).any())


def make_bounce_step(
    scene: Scene, quirks: Quirks = VERBATIM, detach: bool = False,
    estimator: str = "mis",
):
    """One bounce of the per-pixel loop, batched: closest hit, emitter
    pass with MIS, the medium's segment and scatter event, background,
    emission, alpha pass-through, NEE and the Disney sample that sets the
    next ray.

    estimator: "mis" (NEE and BSDF sampling, power-heuristic weighted),
    "bsdf" (no NEE, emitter hits weigh 1) or "nee" (emitter hits weigh 0,
    light samples 1); the three agree in expectation."""
    if estimator not in ("mis", "bsdf", "nee"):
        raise ValueError(f"unknown estimator {estimator!r}")
    media = has_media(scene)
    sg_ = (lambda x: x.detach()) if detach else (lambda x: x)

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

        if media:
            # The segment just travelled inside the medium: Absorb
            # attenuates, Emissive adds.
            seg = torch.where(hit, hit_dist, 0.0)
            seg_on = alive & hit & (state.med_type != 0)
            absorbing = seg_on & (state.med_type == 1)
            emitting = seg_on & (state.med_type == 3)
            ext = state.med_density * seg
            c = state.med_color
            att = V3(torch.exp(-(1.0 - c.x) * ext), torch.exp(-(1.0 - c.y) * ext), torch.exp(-(1.0 - c.z) * ext))
            radiance = radiance + mask3(emitting, c * splat3(state.med_density * seg) * throughput)
            throughput = where3(absorbing, throughput * att, throughput)

            # Scatter: a free flight s ~ Exp(density) that ends inside the
            # segment scatters there (the pdf cancels the transmittance, so
            # the throughput takes the albedo only), with its own NEE by
            # the HG phase and an HG-sampled continuation.
            sigma = maximum(state.med_density, 1e-12)
            s_free = -torch.log(maximum(1.0 - u[..., 7], 1e-12)) / sigma
            scat = alive & hit & (state.med_type == 2) & (state.med_density > 0.0) & (s_free < hit_dist)
            scatter_pos = ro + rd * sg_(torch.where(scat, s_free, 0.0))
            throughput = where3(scat, throughput * c, throughput)
            if estimator != "bsdf":
                ld_s = scatter_direct_light(
                    scene, rd, scatter_pos, state.med_aniso, u[..., 0:3], detach, mis=(estimator == "mis")
                )
                radiance = radiance + mask3(scat, ld_s * throughput)
            l_hg = sample_hg(rd, state.med_aniso, u[..., 3], u[..., 4])
            l_hg = V3(sg_(l_hg.x), sg_(l_hg.y), sg_(l_hg.z))
            pdf_hg = hg_phase(dot(rd, l_hg), state.med_aniso)
        else:
            scat = torch.zeros_like(alive)

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
        passthru = alive & hit & ~em.hit & alpha_fail & ~scat

        radiance = radiance + mask3(alive & hit & ~passthru & ~scat, material.emission * throughput)

        # Emitter hit, MIS-weighted with the previous bounce's scatter pdf.
        mis_w = power_heuristic(maximum(state.prev_pdf, 0.0), em.pdf)
        if not quirks.primary_mis:
            mis_w = torch.where(state.prev_pdf < 0.0, 1.0, mis_w)
        if estimator == "bsdf":
            mis_w = torch.ones_like(mis_w)
        elif estimator == "nee":
            mis_w = torch.zeros_like(mis_w)
        radiance = radiance + mask3(alive & em.hit & ~scat, em.emission * (mis_w * 1.0) * throughput)

        shade = alive & hit & ~em.hit & ~scat & ~passthru

        if estimator != "bsdf":
            ld = direct_light(scene, rd, fhp, ffnormal, material, eta, u[..., 0:3], detach, mis=(estimator == "mis"))
            radiance = radiance + mask3(shade, ld * throughput)

        bs = disney_sample(material, eta, -rd, ffnormal, state.prev_l, u[..., 3:6], detach)
        cont = shade & (bs.pdf > 0.0)
        safe_pdf = torch.where(bs.pdf > 0.0, bs.pdf, 1.0)
        throughput = where3(cont, throughput * bs.f / splat3(safe_pdf), throughput)

        ro_next = where3(cont, fhp + bs.l * EPS, ro)
        rd_next = where3(cont, bs.l, rd)
        ro_next = where3(passthru, fhp + rd * EPS, ro_next)
        rd_next = where3(passthru, rd, rd_next)
        prev_pdf = torch.where(shade, bs.pdf, state.prev_pdf)
        prev_l = where3(shade, bs.l, state.prev_l)
        med = (state.med_type, state.med_density, state.med_color, state.med_aniso)

        if media:
            # Scatter: on from the scatter point along the HG sample, still
            # inside the medium, whose pdf the next emitter hit weighs.
            ro_next = where3(scat, scatter_pos, ro_next)
            rd_next = where3(scat, l_hg, rd_next)
            prev_pdf = torch.where(scat, sg_(pdf_hg), prev_pdf)
            prev_l = where3(scat, l_hg, prev_l)
            # A transmission into a front face takes the surface's medium,
            # one out of a back face returns to vacuum.
            transmitted = cont & (dot(bs.l, ffnormal) < 0.0)
            enter_m, exit_m = transmitted & entering, transmitted & ~entering
            mm = material.medium
            zero = torch.zeros_like(state.med_density)
            med = (
                torch.where(enter_m, mm.medium_type, torch.where(exit_m, 0, state.med_type)),
                torch.where(enter_m, mm.density, torch.where(exit_m, 0.0, state.med_density)),
                where3(enter_m, mm.color, where3(exit_m, splat3(zero), state.med_color)),
                torch.where(enter_m, mm.anisotropy, torch.where(exit_m, 0.0, state.med_aniso)),
            )

        return PathState(
            ro=ro_next,
            rd=rd_next,
            radiance=radiance,
            throughput=throughput,
            alive=cont | passthru | scat,
            prev_pdf=prev_pdf,
            prev_l=prev_l,
            prev_hit_dist=torch.where(alive & hit, hit_dist, state.prev_hit_dist),
            med_type=med[0],
            med_density=med[1],
            med_color=med[2],
            med_aniso=med[3],
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
        med_type=torch.zeros(n, dtype=torch.int32, device=device),  # vacuum
        med_density=full(0.0),
        med_color=zeros3(n, dtype, device),
        med_aniso=full(0.0),
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


def _alive_entering(scene: Scene, coords: V2, cam_u, bounce_u, quirks: Quirks, width: int, height: int):
    """Yield the lanes' alive mask entering each bounce of the paths from
    these camera and bounce uniforms."""
    ro, rd = gen_ray(scene.camera.unpack(), coords, V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height))
    state = init_state(ro, rd, quirks)
    bounce = make_bounce_step(scene, quirks)
    for u in bounce_u:
        yield state.alive
        state = bounce(state, u)


def measure_occupancy(
    scene: Scene, key, width: int, height: int, spp: int = 1, quirks: Quirks = VERBATIM
) -> torch.Tensor:
    """The eager occupancy probe: the fraction of lanes alive entering
    each bounce, [depth] on the CPU (the first entry is 1), as the JAX
    package's `measure_occupancy` computes it. 1 - the fraction is what
    compaction could recover at that bounce.

    At spp > 1 this draws, as the JAX probe does, ONE stream over the
    W*H*spp lanes (lane i is pixel i // spp), where render_frame and the
    kernels draw split(key, spp)[s] for sample s over the W*H pixels, so
    the two agree at spp 1 only (`bounces_entered` follows the kernels)."""
    coords = pixel_coords(width, height, torch.float64, scene.device)
    if spp > 1:
        coords = V2(coords.x.repeat_interleave(spp), coords.y.repeat_interleave(spp))
    cam_u, bounce_u = draw_uniforms(key, width * height * spp, scene.recursion_depth, scene.dtype, scene.device)
    with torch.no_grad():
        alive = _alive_entering(scene, coords, cam_u, bounce_u, quirks, width, height)
        fracs = torch.stack([a.to(torch.float64).mean() for a in alive])
    return fracs.cpu()


def bounces_entered(
    scene: Scene, key, width: int, height: int, spp: int = 1, quirks: Quirks = VERBATIM, pixels=None
) -> torch.Tensor:
    """How many bounces each sample's path entered alive, [spp, H, W] int32
    on the scene's device: the plain version of the occupancy kernel K3
    (`ops/megakernel.measure_occupancy_megakernel`). Sample s draws the
    stream of render_frame and the kernels, split(key, spp)[s] (key itself
    at spp 1), so at spp 1 the alive fraction entering bounce b, the mean
    of (counts > b), is `measure_occupancy`'s, and at spp > 1 it is not
    (that probe draws one stream over all W*H*spp lanes). Over the pixel
    range `pixels`, the range's counts and zeros elsewhere."""
    n = width * height
    begin, count = check_pixels(n, pixels)
    coords = range_coords(width, height, scene.device, begin, count)
    out = torch.zeros((spp, n), dtype=torch.int32, device=scene.device)
    if count == 0:
        return out.reshape(spp, height, width)
    with torch.no_grad():
        for s, k in enumerate([key] if spp == 1 else list(rng.split(key, spp))):
            cam_u, bounce_u = draw_uniforms(k, n, scene.recursion_depth, scene.dtype, scene.device, (begin, count))
            for alive in _alive_entering(scene, coords, cam_u, bounce_u, quirks, width, height):
                out[s, begin:begin + count] += alive.to(torch.int32)
    return out.reshape(spp, height, width)


def check_pixels(n: int, pixels) -> tuple[int, int]:
    """(p_begin, p_count) of a frame of n flat pixels: `pixels`, or the
    whole frame for None; a range outside the frame raises."""
    if pixels is None:
        return 0, n
    begin, count = (int(x) for x in pixels)
    if begin < 0 or count < 0 or begin + count > n:
        raise ValueError(f"pixel range ({begin}, {count}) is outside a frame of {n} pixels")
    return begin, count


def range_coords(width: int, height: int, device, begin: int, count: int) -> V2:
    """pixel_coords (float64) of the flat pixels [begin, begin + count)."""
    coords = pixel_coords(width, height, torch.float64, device)
    if count == width * height:
        return coords
    return V2(coords.x[begin:begin + count], coords.y[begin:begin + count])


def draw_uniforms(key, n: int, depth: int, dtype=torch.float32, device=None, pixels=None):
    """Per-frame randomness (cam jitter [N, 2], bounce uniforms
    [depth, N, 8]), bit-equal to the JAX package's `draw_uniforms`; with
    `pixels` (p_begin, p_count) those of the range's pixels only ([count,
    2], [depth, count, 8]), drawn at their counters in the frame's draw."""
    kc, kb = rng.split(key)
    begin, count = check_pixels(n, pixels)
    if dtype not in (torch.float32, torch.float64):  # a narrower type takes the float32 stream, rounded
        cam, bounce = draw_uniforms(key, n, depth, torch.float32, device, pixels)
        return cam.to(dtype), bounce.to(dtype)
    if count == n:
        cam = rng.uniform(kc, (n, 2), dtype, device)
        bounce = rng.uniform(kb, (depth, n, U_PER_BOUNCE), dtype, device)
        return cam, bounce
    p = torch.arange(begin, begin + count, dtype=torch.int64, device=device)
    lanes = lambda m: torch.arange(m, dtype=torch.int64, device=device)
    cam = rng.uniform_at(kc, p[:, None] * 2 + lanes(2), dtype)
    d = lanes(depth)[:, None, None]
    bounce = rng.uniform_at(kb, ((d * n + p[None, :, None]) * U_PER_BOUNCE) + lanes(U_PER_BOUNCE), dtype)
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
    basis: tuple | None = None,
    pixels: tuple | None = None,
) -> torch.Tensor:
    """Render one progressive frame -> [H, W, 4] linear RGBA (alpha 1) on
    the scene's device. `uniforms=(cam [N, 2], bounce [depth, N, 8])`
    replaces the key's stream (spp 1, the whole frame only), so tests can
    feed JAX's float64 stream. `basis` (lower_left, horizontal, vertical,
    origin) replaces the camera's, as the packed scene vector holds it.
    `pixels` (p_begin, p_count) renders that range of the flat pixels: the
    whole frame's there, zeros (alpha too) elsewhere.

    detach=True is the detached-sampling gradient estimator: autograd
    through the frame differentiates everything but the sampled BSDF and
    light directions and pdfs; forward values are those of detach=False."""
    n = width * height
    if uniforms is not None:
        if spp != 1 or check_pixels(n, pixels)[1] != n:
            raise ValueError("explicit uniforms need spp == 1 and the whole frame")
        radiance = sample_radiance(scene, None, width, height, quirks, detach, estimator, uniforms, basis)
    elif spp == 1:
        radiance = sample_radiance(scene, key, width, height, quirks, detach, estimator, None, basis, pixels)
    else:
        acc = [sample_radiance(scene, k, width, height, quirks, detach, estimator, None, basis, pixels)
               for k in rng.split(key, spp)]
        radiance = V3(*[torch.stack([a[c] for a in acc]).mean(dim=0) for c in range(3)])
    return frame_of(radiance, width, height, pixels)


def sample_radiance(
    scene: Scene, key, width: int, height: int, quirks: Quirks = VERBATIM, detach: bool = False,
    estimator: str = "mis", uniforms: tuple | None = None, basis: tuple | None = None, pixels: tuple | None = None,
) -> V3:
    """One sample's radiance, V3 of [count], of the flat pixels
    [p_begin, p_begin + p_count) (`pixels`; None: the whole frame), from
    the uniforms render_frame draws from `key` (or `uniforms`)."""
    n = width * height
    begin, count = check_pixels(n, pixels)
    if count == 0:  # a rank past the frame's last pixel traces nothing
        none = torch.zeros(0, dtype=scene.dtype, device=scene.device)
        return V3(none, none, none)
    if uniforms is None:
        uniforms = draw_uniforms(key, n, scene.recursion_depth, scene.dtype, scene.device, (begin, count))
    cam_u, bounce_u = uniforms
    coords = range_coords(width, height, scene.device, begin, count)
    ro, rd = gen_ray(scene.camera.unpack(), coords, V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height), basis)
    return trace(scene, ro, rd, bounce_u, quirks, detach, estimator)


def frame_of(radiance: V3, width: int, height: int, pixels: tuple | None = None) -> torch.Tensor:
    """The [H, W, 4] frame of the radiance of the pixel range `pixels`
    (None: the whole frame), alpha 1 there; the other pixels are 0."""
    n = width * height
    begin, count = check_pixels(n, pixels)
    ref = radiance.x
    if count == n:
        return torch.stack(
            [
                radiance.x.reshape(height, width),
                radiance.y.reshape(height, width),
                radiance.z.reshape(height, width),
                torch.ones((height, width), dtype=ref.dtype, device=ref.device),
            ],
            dim=-1,
        )
    rows = torch.stack([radiance.x, radiance.y, radiance.z, torch.ones_like(ref)], dim=-1)
    return torch.cat([rows.new_zeros((begin, 4)), rows, rows.new_zeros((n - begin - count, 4))]).reshape(
        height, width, 4)


def accumulate(pixels: torch.Tensor, frame: torch.Tensor, frames):
    """Progressive running mean with weight 1/(frames+1); returns
    (new_pixels, frames + 1)."""
    w = 1.0 / (frames + 1.0)
    return pixels * (1.0 - w) + frame * w, frames + 1
