# Frozen copy of pathtracer_tpu_torch/ops/sampling.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""Monte-Carlo sampling primitives and microfacet terms, batched.

Port of `pathtracer_tpu/ops/sampling.py`: elementwise over the ray batch
and division-guarded, so masked lanes never produce NaN. GTR1 keeps the
reference's log2 (natural log in the GLSL original) behind `use_log2`.
"""

from __future__ import annotations

import torch

from .vecmath import (
    INV_PI,
    PI,
    TWO_PI,
    V3,
    clip,
    cross,
    maximum,
    onb,
    safe_normalize,
    safe_sqrt,
    to_world,
)


def power_heuristic(a, b):
    """MIS power heuristic a^2/(a^2+b^2)."""
    t = a * a
    denom = b * b + t
    ok = denom > 0.0
    return torch.where(ok, t / torch.where(ok, denom, 1.0), 0.0)


def schlick_fresnel(u):
    """(1-u)^5 with clamp."""
    m = clip(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def dielectric_fresnel(cos_theta_i, eta):
    """Exact dielectric Fresnel with total internal reflection."""
    sin_theta_tsq = eta * eta * (1.0 - cos_theta_i * cos_theta_i)
    cos_theta_t = safe_sqrt(1.0 - sin_theta_tsq)
    denom_s = eta * cos_theta_t + cos_theta_i
    denom_p = eta * cos_theta_i + cos_theta_t
    rs = (eta * cos_theta_t - cos_theta_i) / torch.where(denom_s != 0.0, denom_s, 1.0)
    rp = (eta * cos_theta_i - cos_theta_t) / torch.where(denom_p != 0.0, denom_p, 1.0)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(sin_theta_tsq > 1.0, 1.0, f)


def gtr1(ndoth, a, use_log2: bool = True):
    """Clearcoat GTR1 NDF; use_log2 keeps the reference's log2."""
    a = torch.as_tensor(a, dtype=ndoth.dtype, device=ndoth.device)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    log_a2 = torch.log2(a2) if use_log2 else torch.log(a2)
    denom = PI * log_a2 * t
    val = (a2 - 1.0) / torch.where(denom != 0.0, denom, 1.0)
    return torch.where(a >= 1.0, INV_PI, val)


def sample_gtr1(rgh, r1, r2) -> V3:
    """GTR1 half-vector sampling; phi is driven by r1 and r2 is unused,
    as in the reference."""
    del r2
    a = maximum(rgh, 0.001)
    a2 = a * a
    phi = r1 * TWO_PI
    cos_theta = safe_sqrt((1.0 - torch.pow(a2, 1.0 - r1)) / (1.0 - a2))
    sin_theta = clip(safe_sqrt(1.0 - cos_theta * cos_theta), 0.0, 1.0)
    return V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)


def sample_ggxvndf(v: V3, ax, ay, r1, r2) -> V3:
    """Visible-normal GGX sampling (Heitz 2018)."""
    vh = safe_normalize(V3(ax * v.x, ay * v.y, v.z))

    lensq = vh.x * vh.x + vh.y * vh.y
    pos = lensq > 0.0
    inv_len = 1.0 / torch.sqrt(torch.where(pos, lensq, 1.0))
    t1v = V3(
        torch.where(pos, -vh.y * inv_len, 1.0),
        torch.where(pos, vh.x * inv_len, 0.0),
        torch.zeros_like(vh.z),
    )
    t2v = cross(vh, t1v)

    r = torch.sqrt(r1)
    phi = 2.0 * PI * r2
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    t2 = (1.0 - s) * safe_sqrt(1.0 - t1 * t1) + s * t2

    nh = t1v * t1 + t2v * t2 + vh * safe_sqrt(1.0 - t1 * t1 - t2 * t2)
    return safe_normalize(V3(ax * nh.x, ay * nh.y, maximum(nh.z, 0.0)))


def smithg(ndotv, alphag):
    """Smith G1, isotropic."""
    a = alphag * alphag
    b = ndotv * ndotv
    denom = ndotv + safe_sqrt(a + b - a * b)
    return (2.0 * ndotv) / torch.where(denom != 0.0, denom, 1.0)


def gtr2_aniso(ndoth, hdotx, hdoty, ax, ay):
    """Anisotropic GTR2/GGX NDF."""
    a = hdotx / ax
    b = hdoty / ay
    c = a * a + b * b + ndoth * ndoth
    denom = PI * ax * ay * c * c
    return 1.0 / torch.where(denom != 0.0, denom, 1.0)


def smithg_aniso(ndotv, vdotx, vdoty, ax, ay):
    """Anisotropic Smith G1."""
    a = vdotx * ax
    b = vdoty * ay
    c = ndotv
    denom = ndotv + safe_sqrt(a * a + b * b + c * c)
    return (2.0 * ndotv) / torch.where(denom != 0.0, denom, 1.0)


def cosine_sample_hemisphere(r1, r2) -> V3:
    """Cosine-weighted hemisphere about +z."""
    r = torch.sqrt(r1)
    phi = TWO_PI * r2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = safe_sqrt(1.0 - x * x - y * y)
    return V3(x, y, z)


def uniform_sample_hemisphere(r1, r2) -> V3:
    """Uniform hemisphere about +z; r1 is cos(theta)."""
    r = safe_sqrt(1.0 - r1 * r1)
    phi = TWO_PI * r2
    return V3(r * torch.cos(phi), r * torch.sin(phi), r1)


def hg_phase(cos_theta, g):
    """Henyey-Greenstein phase function, normalized over the sphere."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta
    return INV_PI * 0.25 * (1.0 - g2) / (denom * safe_sqrt(denom))


def sample_hg(d: V3, g, r1, r2) -> V3:
    """Importance-sample the HG phase about the unit direction `d`; the
    |g| ~ 0 limit falls back to the uniform sphere."""
    iso = torch.abs(g) < 1e-3
    g_safe = torch.where(iso, 0.5, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * r2)
    cos_aniso = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_theta = torch.where(iso, 1.0 - 2.0 * r2, cos_aniso)
    cos_theta = clip(cos_theta, -1.0, 1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = TWO_PI * r1
    local = V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)
    t, b = onb(d)
    return to_world(t, b, d, local)
