# Frozen copy of pathtracer_tpu_torch/ops/bsdf.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""Four-lobe Disney/principled BSDF: sample and eval, batched.

Port of `pathtracer_tpu/ops/bsdf.py`: diffuse (Burley + fake subsurface +
sheen), anisotropic GGX reflection (VNDF-sampled), GGX refraction and GTR1
clearcoat, picked by luminance-weighted lobe probabilities. Every lane
computes every lobe and keeps its own by masked selects.

Kept verbatim: `disney_sample` computes the specular Fresnel with the
PREVIOUS bounce's world-space direction dotted with the local-frame half
vector (`prev_l`), and `_guard_div` returns 0 where the denominator is 0
(exactly grazing incidence), where the raw 0/0 would leak NaN.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .material import Material
from .sampling import (
    cosine_sample_hemisphere,
    dielectric_fresnel,
    gtr1,
    gtr2_aniso,
    sample_ggxvndf,
    sample_gtr1,
    schlick_fresnel,
    smithg,
    smithg_aniso,
)
from .vecmath import (
    INV_PI,
    V3,
    clip,
    dot,
    luminance,
    mask3,
    maximum,
    mix,
    mix_f,
    onb,
    reflect,
    refract,
    safe_normalize,
    safe_sqrt,
    splat3,
    to_local,
    to_world,
    where3,
    zeros3,
)


def _guard_div(a, b, mask):
    """a / b where mask and b != 0, else 0."""
    m = mask & (b != 0.0)
    safe_b = torch.where(m, b, 1.0)
    safe_a = torch.where(m, a, 0.0)
    return torch.where(m, safe_a / safe_b, 0.0)


def get_spec_color(mat: Material, eta) -> tuple[V3, V3]:
    """F0 specular and sheen tint colors."""
    lum = luminance(mat.rgb)
    white = splat3(torch.ones_like(lum))
    pos = lum > 0.0
    ctint = where3(pos, mat.rgb / splat3(torch.where(pos, lum, 1.0)), white)
    f0 = (1.0 - eta) / (1.0 + eta)
    spec_col = mix((f0 * f0) * mix(white, ctint, mat.specular_tint), mat.rgb, mat.metallic)
    sheen_col = mix(white, ctint, mat.sheen_tint)
    return spec_col, sheen_col


def disney_fresnel(mat: Material, eta, ldoth, vdoth):
    """Metallic/dielectric Fresnel blend."""
    metallic_f = schlick_fresnel(ldoth)
    dielectric_f = dielectric_fresnel(torch.abs(vdoth), eta)
    return mix_f(dielectric_f, metallic_f, mat.metallic)


def get_lobe_probabilities(mat: Material, spec_col: V3, approx_fresnel):
    """Normalized (diffuse, spec_reflect, spec_refract, clearcoat) weights."""
    white = splat3(torch.ones_like(approx_fresnel))
    diffuse_wt = luminance(mat.rgb) * (1.0 - mat.metallic) * (1.0 - mat.spec_trans)
    spec_reflect_wt = luminance(mix(spec_col, white, approx_fresnel))
    spec_refract_wt = (
        (1.0 - approx_fresnel) * (1.0 - mat.metallic) * mat.spec_trans * luminance(mat.rgb)
    )
    clearcoat_wt = 0.25 * mat.clearcoat * (1.0 - mat.metallic)
    total = diffuse_wt + spec_reflect_wt + spec_refract_wt + clearcoat_wt
    inv = _guard_div(torch.ones_like(total), total, total > 0.0)
    return diffuse_wt * inv, spec_reflect_wt * inv, spec_refract_wt * inv, clearcoat_wt * inv


def eval_diffuse(mat: Material, c_sheen: V3, v: V3, l: V3, h: V3):
    """Burley diffuse + fake subsurface + sheen; pdf = cos/pi. Local
    frame (n = +z)."""
    active = l.z > 0.0
    ldoth = dot(l, h)
    fl = schlick_fresnel(l.z)
    fv = schlick_fresnel(v.z)
    fh = schlick_fresnel(ldoth)
    fd90 = 0.5 + 2.0 * ldoth * ldoth * mat.roughness
    fd = mix_f(1.0, fd90, fl) * mix_f(1.0, fd90, fv)

    fss90 = ldoth * ldoth * mat.roughness
    fss = mix_f(1.0, fss90, fl) * mix_f(1.0, fss90, fv)
    inv_lzvz = _guard_div(torch.ones_like(l.z), l.z + v.z, active)
    ss = 1.25 * (fss * (inv_lzvz - 0.5) + 0.5)

    fsheen = c_sheen * (fh * mat.sheen)

    pdf = torch.where(active, l.z * INV_PI, 0.0)
    f = (mat.rgb * (INV_PI * mix_f(fd, ss, mat.subsurface)) + fsheen) * (
        (1.0 - mat.metallic) * (1.0 - mat.spec_trans)
    )
    return mask3(active, f), pdf


def eval_spec_reflection(mat: Material, eta, spec_col: V3, v: V3, l: V3, h: V3):
    """Anisotropic GGX reflection; VNDF pdf G1*D/(4 v.z)."""
    active = l.z > 0.0
    fm = disney_fresnel(mat, eta, dot(l, h), dot(v, h))
    f_col = mix(spec_col, splat3(torch.ones_like(fm)), fm)
    d = gtr2_aniso(h.z, h.x, h.y, mat.ax, mat.ay)
    g1 = smithg_aniso(torch.abs(v.z), v.x, v.y, mat.ax, mat.ay)
    g2 = g1 * smithg_aniso(torch.abs(l.z), l.x, l.y, mat.ax, mat.ay)
    pdf = _guard_div(g1 * d, 4.0 * v.z, active)
    scale = _guard_div(d * g2, 4.0 * l.z * v.z, active)
    return mask3(active, f_col * scale), pdf


def eval_spec_refraction(mat: Material, eta, v: V3, l: V3, h: V3):
    """GGX refraction with the change-of-measure Jacobian; active in the
    lower hemisphere."""
    active = l.z < 0.0
    vdoth = dot(v, h)
    ldoth = dot(l, h)
    f = dielectric_fresnel(torch.abs(vdoth), eta)
    d = gtr2_aniso(h.z, h.x, h.y, mat.ax, mat.ay)
    g1 = smithg_aniso(torch.abs(v.z), v.x, v.y, mat.ax, mat.ay)
    g2 = g1 * smithg_aniso(torch.abs(l.z), l.x, l.y, mat.ax, mat.ay)
    denom = ldoth + vdoth * eta
    denom = denom * denom
    eta2 = eta * eta
    jacobian = _guard_div(torch.abs(ldoth), denom, active)

    pdf = _guard_div(g1 * maximum(vdoth, 0.0) * d * jacobian, v.z, active)

    scale = (
        (1.0 - mat.metallic) * mat.spec_trans * (1.0 - f) * d * g2
        * torch.abs(vdoth) * jacobian * eta2
    )
    scale = _guard_div(scale, torch.abs(l.z * v.z), active)
    sqrt_rgb = V3(safe_sqrt(mat.rgb.x), safe_sqrt(mat.rgb.y), safe_sqrt(mat.rgb.z))
    return mask3(active, sqrt_rgb * scale), pdf


def eval_clearcoat(mat: Material, v: V3, l: V3, h: V3):
    """GTR1 clearcoat with a fixed 0.25 Smith roughness."""
    active = l.z > 0.0
    vdoth = dot(v, h)
    fh = dielectric_fresnel(vdoth, 1.0 / 1.5)
    f_scalar = mix_f(0.04, 1.0, fh)
    d = gtr1(h.z, mat.clearcoat_roughness)
    g = smithg(l.z, 0.25) * smithg(v.z, 0.25)
    jacobian = _guard_div(torch.ones_like(vdoth), 4.0 * vdoth, active)
    pdf = torch.where(active, d * h.z * jacobian, 0.0)
    scale = _guard_div(mat.clearcoat * f_scalar * d * g, 4.0 * l.z * v.z, active)
    return mask3(active, splat3(scale * 0.25)), pdf


class BsdfSample(NamedTuple):
    """Sampled world direction, f = |n.l| * bsdf, and pdf."""

    l: V3
    f: V3
    pdf: torch.Tensor


def disney_sample(
    mat: Material, eta, v_world: V3, n_world: V3, prev_l_world: V3, u,
    detach: bool = False,
) -> BsdfSample:
    """Importance-sample the Disney BSDF.

    v_world = -ray direction, n_world the front-facing shading normal,
    prev_l_world the previous bounce's sampled direction (stale-l Fresnel
    quirk), u = (r1, r2, reflect/refract coin) as a tuple or a [..., 3]
    tensor. detach=True detaches the sampled directions and the pdf (the
    detached-sampling gradient estimator); forward values are identical.
    """
    if isinstance(u, (tuple, list)):
        r1, r2, u_coin = u
    else:
        r1, r2, u_coin = u[..., 0], u[..., 1], u[..., 2]
    sg = (lambda x: x.detach()) if detach else (lambda x: x)
    sg3 = lambda w: V3(sg(w.x), sg(w.y), sg(w.z))

    t, b = onb(n_world)
    v = to_local(t, b, n_world, v_world)

    spec_col, sheen_col = get_spec_color(mat, eta)
    approx_fresnel = disney_fresnel(mat, eta, v.z, v.z)
    diffuse_wt, spec_reflect_wt, spec_refract_wt, clearcoat_wt = get_lobe_probabilities(
        mat, spec_col, approx_fresnel
    )

    # Lobe CDF order [diffuse, +clearcoat, +spec_reflect, +spec_refract].
    cdf0 = diffuse_wt
    cdf1 = cdf0 + clearcoat_wt
    sel_diffuse = r1 < cdf0
    sel_clear = (~sel_diffuse) & (r1 < cdf1)

    # Diffuse lobe. Re-conditioned uniforms are clipped to [0, 1] because
    # lanes that picked another lobe would drive sqrt/pow to NaN.
    r1_d = clip(_guard_div(r1, cdf0, cdf0 > 0.0), 0.0, 1.0)
    l_diff = sg3(cosine_sample_hemisphere(r1_d, r2))
    h_diff = sg3(safe_normalize(l_diff + v))
    f_diff, pdf_diff = eval_diffuse(mat, sheen_col, v, l_diff, h_diff)
    pdf_diff = pdf_diff * diffuse_wt

    # Clearcoat lobe.
    span_c = cdf1 - cdf0
    r1_c = clip(_guard_div(r1 - cdf0, span_c, span_c > 0.0), 0.0, 1.0)
    h_cc = sample_gtr1(mat.clearcoat_roughness, r1_c, r2)
    h_cc = sg3(where3(h_cc.z < 0.0, -h_cc, h_cc))
    l_cc = sg3(safe_normalize(reflect(-v, h_cc)))
    f_cc, pdf_cc = eval_clearcoat(mat, v, l_cc, h_cc)
    pdf_cc = pdf_cc * clearcoat_wt

    # Specular reflection / refraction lobes.
    span_s = 1.0 - cdf1
    r1_s = clip(_guard_div(r1 - cdf1, span_s, span_s > 0.0), 0.0, 1.0)
    h_s = sample_ggxvndf(v, mat.ax, mat.ay, r1_s, r2)
    h_s = sg3(where3(h_s.z < 0.0, -h_s, h_s))

    # Stale-l Fresnel: world-space prev_l against the local half vector.
    fresnel = disney_fresnel(mat, eta, dot(prev_l_world, h_s), dot(v, h_s))
    ff = 1.0 - ((1.0 - fresnel) * mat.spec_trans * (1.0 - mat.metallic))
    take_reflect = u_coin < ff

    l_refl = sg3(safe_normalize(reflect(-v, h_s)))
    f_refl, pdf_refl = eval_spec_reflection(mat, eta, spec_col, v, l_refl, h_s)
    pdf_refl = pdf_refl * ff

    l_refr = sg3(safe_normalize(refract(-v, h_s, eta)))
    f_refr, pdf_refr = eval_spec_refraction(mat, eta, v, l_refr, h_s)
    pdf_refr = pdf_refr * (1.0 - ff)

    l_spec = where3(take_reflect, l_refl, l_refr)
    f_spec = where3(take_reflect, f_refl, f_refr)
    pdf_spec = torch.where(take_reflect, pdf_refl, pdf_refr)
    pdf_spec = pdf_spec * (spec_reflect_wt + spec_refract_wt)

    l_local = where3(sel_diffuse, l_diff, where3(sel_clear, l_cc, l_spec))
    f = where3(sel_diffuse, f_diff, where3(sel_clear, f_cc, f_spec))
    pdf = torch.where(sel_diffuse, pdf_diff, torch.where(sel_clear, pdf_cc, pdf_spec))

    l_world = to_world(t, b, n_world, l_local)
    f_out = f * torch.abs(dot(n_world, l_world))
    return BsdfSample(l=l_world, f=f_out, pdf=sg(pdf))


def disney_eval(mat: Material, eta, v_world: V3, n_world: V3, l_world: V3):
    """Full BSDF value and pdf for a given direction (the NEE side).
    Returns (f = |l.z| * bsdf, pdf)."""
    t, b = onb(n_world)
    v = to_local(t, b, n_world, v_world)
    l = to_local(t, b, n_world, l_world)

    upper = l.z > 0.0
    h = where3(upper, safe_normalize(l + v), safe_normalize(l + v * eta))
    h = where3(h.z < 0.0, -h, h)

    spec_col, sheen_col = get_spec_color(mat, eta)
    fresnel = disney_fresnel(mat, eta, dot(l, h), dot(v, h))
    diffuse_wt, spec_reflect_wt, spec_refract_wt, clearcoat_wt = get_lobe_probabilities(
        mat, spec_col, fresnel
    )

    f = zeros3(l.z.shape, l.z.dtype, l.z.device)
    bsdf_pdf = torch.zeros_like(l.z)

    g = (diffuse_wt > 0.0) & (l.z > 0.0)
    fd, pd = eval_diffuse(mat, sheen_col, v, l, h)
    f = f + mask3(g, fd)
    bsdf_pdf = bsdf_pdf + torch.where(g, pd * diffuse_wt, 0.0)

    g = (spec_reflect_wt > 0.0) & (l.z > 0.0) & (v.z > 0.0)
    fr, pr = eval_spec_reflection(mat, eta, spec_col, v, l, h)
    f = f + mask3(g, fr)
    bsdf_pdf = bsdf_pdf + torch.where(g, pr * spec_reflect_wt, 0.0)

    g = (spec_refract_wt > 0.0) & (l.z < 0.0)
    ft, pt = eval_spec_refraction(mat, eta, v, l, h)
    f = f + mask3(g, ft)
    bsdf_pdf = bsdf_pdf + torch.where(g, pt * spec_refract_wt, 0.0)

    g = (clearcoat_wt > 0.0) & (l.z > 0.0) & (v.z > 0.0)
    fc, pc = eval_clearcoat(mat, v, l, h)
    f = f + mask3(g, fc)
    bsdf_pdf = bsdf_pdf + torch.where(g, pc * clearcoat_wt, 0.0)

    return f * torch.abs(l.z), bsdf_pdf
