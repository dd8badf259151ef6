"""Shading math of the port held elementwise to the JAX package: vecmath,
sampling, intersect, finalize_material and the Disney BSDF, on the same
numpy-seeded inputs: float64 at rtol 1e-12 (atol 1e-12 for values that
cancel to ~0), float32 at rtol 1e-5, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.models import material as JM
from pathtracer_tpu.ops import bsdf as JB
from pathtracer_tpu.ops import intersect as JI
from pathtracer_tpu.ops import sampling as JS
from pathtracer_tpu.ops import vecmath as JV
from pathtracer_tpu_torch.models import material as TM
from pathtracer_tpu_torch.ops import bsdf as TB
from pathtracer_tpu_torch.ops import intersect as TI
from pathtracer_tpu_torch.ops import sampling as TS
from pathtracer_tpu_torch.ops import vecmath as TV
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 512
TOL = {"float64": dict(rtol=1e-12, atol=1e-12), "float32": dict(rtol=1e-5, atol=1e-6)}


class Inputs:
    """The same numpy arrays, handed to JAX and to torch."""

    def __init__(self, dtype: str, seed: int = 0):
        self.dtype = dtype
        self.rng = np.random.default_rng(seed)

    def arr(self, lo=0.0, hi=1.0):
        return self.rng.uniform(lo, hi, N).astype(self.dtype)

    def unit(self):
        v = self.rng.normal(size=(3, N))
        return tuple((v / np.linalg.norm(v, axis=0)).astype(self.dtype))

    def vec(self, lo=-2.0, hi=2.0):
        return tuple(self.arr(lo, hi) for _ in range(3))


def _convert(x, arr, vec):
    """Map numpy leaves of an argument (array, 3-tuple = vector, dict)."""
    if isinstance(x, dict):
        return {k: _convert(v, arr, vec) for k, v in x.items()}
    if isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], np.ndarray):
        return vec(*[arr(c) for c in x])
    return arr(x) if isinstance(x, np.ndarray) else x


def to_jax(x):
    return _convert(x, jnp.asarray, JV.V3)


def to_torch(x):
    return _convert(x, torch.from_numpy, TV.V3)


def leaves(out) -> list[np.ndarray]:
    if isinstance(out, tuple):
        return [a for o in out for a in leaves(o)]
    return [np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)]


def check(jfn, tfn, args, dtype):
    ref = leaves(jfn(*[to_jax(a) for a in args]))
    got = leaves(tfn(*[to_torch(a) for a in args]))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype, (g.dtype, r.dtype)
        np.testing.assert_allclose(g, r, **TOL[dtype])


@pytest.fixture(params=["float64", "float32"])
def dtype(request):
    return request.param


def test_vecmath(dtype):
    x = Inputs(dtype, 1)
    a, b, n, t = x.vec(), x.vec(), x.unit(), x.arr()
    check(JV.dot, TV.dot, (a, b), dtype)
    check(JV.cross, TV.cross, (a, b), dtype)
    check(JV.normalize, TV.normalize, (a,), dtype)
    check(JV.safe_normalize, TV.safe_normalize, (a,), dtype)
    z = tuple(np.zeros(N, dtype) for _ in range(3))
    check(JV.safe_normalize, TV.safe_normalize, (z,), dtype)
    check(JV.onb, TV.onb, (n,), dtype)
    # onb's |n.z| >= 0.999 switch
    norm = np.hypot(0.01, 1.0)
    pole = (np.zeros(N, dtype), np.full(N, 0.01 / norm, dtype), np.full(N, 1.0 / norm, dtype))
    check(JV.onb, TV.onb, (pole,), dtype)
    check(lambda n, v: JV.to_world(*JV.onb(n), n, v), lambda n, v: TV.to_world(*TV.onb(n), n, v), (n, a), dtype)
    check(lambda n, v: JV.to_local(*JV.onb(n), n, v), lambda n, v: TV.to_local(*TV.onb(n), n, v), (n, a), dtype)
    check(JV.reflect, TV.reflect, (x.unit(), n), dtype)
    eta = x.arr(0.5, 2.0)  # includes total internal reflection
    check(JV.refract, TV.refract, (x.unit(), n, eta), dtype)
    check(JV.mix, TV.mix, (a, b, t), dtype)
    check(JV.luminance, TV.luminance, (a,), dtype)
    check(lambda c: c.to_linear(), lambda c: c.to_linear(), (x.vec(0.0, 1.0),), dtype)


def test_sampling(dtype):
    x = Inputs(dtype, 2)
    u1, u2 = x.arr(), x.arr()
    cos = x.arr(-1.0, 1.0)
    a = x.arr(0.001, 1.2)  # GTR1 alpha, including a >= 1
    check(JS.power_heuristic, TS.power_heuristic, (x.arr(0, 3), x.arr(0, 3)), dtype)
    check(JS.power_heuristic, TS.power_heuristic, (np.zeros(N, dtype), np.zeros(N, dtype)), dtype)
    check(JS.schlick_fresnel, TS.schlick_fresnel, (cos,), dtype)
    check(JS.dielectric_fresnel, TS.dielectric_fresnel, (cos, x.arr(0.5, 2.0)), dtype)
    check(JS.gtr1, TS.gtr1, (cos, a), dtype)
    check(lambda h, a: JS.gtr1(h, a, use_log2=False), lambda h, a: TS.gtr1(h, a, use_log2=False), (cos, a), dtype)
    check(JS.sample_gtr1, TS.sample_gtr1, (a, u1, u2), dtype)
    ax, ay = x.arr(0.001, 1.0), x.arr(0.001, 1.0)
    check(JS.sample_ggxvndf, TS.sample_ggxvndf, (x.unit(), ax, ay, u1, u2), dtype)
    check(JS.smithg, TS.smithg, (x.arr(), x.arr()), dtype)
    h = x.unit()
    check(JS.gtr2_aniso, TS.gtr2_aniso, (h[2], h[0], h[1], ax, ay), dtype)
    check(JS.smithg_aniso, TS.smithg_aniso, (h[2], h[0], h[1], ax, ay), dtype)
    check(JS.cosine_sample_hemisphere, TS.cosine_sample_hemisphere, (u1, u2), dtype)
    check(JS.uniform_sample_hemisphere, TS.uniform_sample_hemisphere, (u1, u2), dtype)
    g = x.arr(-0.9, 0.9)
    g[:8] = 0.0  # the isotropic branch
    check(JS.hg_phase, TS.hg_phase, (cos, g), dtype)
    check(JS.sample_hg, TS.sample_hg, (x.unit(), g, u1, u2), dtype)


def test_intersect(dtype):
    x = Inputs(dtype, 3)
    ro, rd = x.vec(-3.0, 3.0), x.unit()
    check(JI.ray_sphere, TI.ray_sphere, (ro, rd, x.vec(-1.0, 1.0), x.arr(0.2, 2.0)), dtype)
    check(JI.ray_plane, TI.ray_plane, (ro, rd, x.unit(), x.vec(-1.0, 1.0)), dtype)
    check(JI.ray_rect, TI.ray_rect, (ro, rd, x.vec(-1.0, 1.0), x.vec(), x.vec()), dtype)
    # a parallel ray misses the plane (denominator under eps)
    flat = (np.ones(N, dtype), np.zeros(N, dtype), np.zeros(N, dtype))
    up = (np.zeros(N, dtype), np.ones(N, dtype), np.zeros(N, dtype))
    check(JI.ray_plane, TI.ray_plane, (ro, flat, up, x.vec()), dtype)


def _materials(x: Inputs) -> dict:
    """Random material parameters spanning all four lobes."""
    return dict(
        rgb=x.vec(0.0, 1.0),
        metallic=x.arr(), roughness=x.arr(), subsurface=x.arr(), specular_tint=x.arr(),
        sheen=x.arr(), sheen_tint=x.arr(), clearcoat=x.arr(), clearcoat_gloss=x.arr(),
        spec_trans=x.arr(), anisotropic=x.arr(), ior=x.arr(1.0, 2.0),
    )


def jmat(vals: dict):
    """Finalized JAX material batch from to_jax(_materials(...))."""
    dtype = vals["metallic"].dtype
    return JM.finalize_material(JM.default_material((N,), dtype)._replace(**vals))


def tmat(vals: dict):
    dtype = vals["metallic"].dtype
    return TM.finalize_material(TM.default_material((N,), dtype)._replace(**vals))


def test_finalize_material(dtype):
    mv = _materials(Inputs(dtype, 4))
    check(jmat, tmat, (mv,), dtype)


def _bsdf_case(dtype, seed, grazing: bool):
    x = Inputs(dtype, seed)
    mv = _materials(x)
    n, v, l, prev_l = x.unit(), x.unit(), x.unit(), x.unit()
    if grazing:
        # v and l exactly in the tangent plane of n = +z: dot(n, v) == 0.
        zero, one = np.zeros(N, dtype), np.ones(N, dtype)
        n = (zero, zero, one)
        v = tuple(c.astype(dtype) for c in (v[0] / np.hypot(v[0], v[1]), v[1] / np.hypot(v[0], v[1]), zero))
        l = tuple(c.astype(dtype) for c in (l[0] / np.hypot(l[0], l[1]), l[1] / np.hypot(l[0], l[1]), zero))
    eta = x.arr(0.5, 1.5)
    # In float32, r1 stays below 0.99: as r1 -> 1 the VNDF sample takes the
    # sqrt of 1 - t1^2 - t2^2 -> 0, where one ulp of difference (XLA on the
    # CPU contracts a*b+c into FMA, torch does not) moves the sample by
    # ~1e-5. float64 covers the whole range.
    r1_hi = 0.99 if dtype == "float32" else 1.0
    u = np.stack([x.arr(0.0, r1_hi), x.arr(), x.arr()], axis=-1)
    return mv, eta, n, v, l, prev_l, u


@pytest.mark.parametrize("grazing", [False, True])
def test_disney_eval(dtype, grazing):
    mv, eta, n, v, l, _, _ = _bsdf_case(dtype, 5, grazing)
    check(
        lambda m, *a: JB.disney_eval(jmat(m), *a), lambda m, *a: TB.disney_eval(tmat(m), *a),
        (mv, eta, v, n, l), dtype,
    )


@pytest.mark.parametrize("grazing", [False, True])
def test_disney_sample(dtype, grazing):
    mv, eta, n, v, _, prev_l, u = _bsdf_case(dtype, 6, grazing)
    check(
        lambda m, *a: JB.disney_sample(jmat(m), *a), lambda m, *a: TB.disney_sample(tmat(m), *a),
        (mv, eta, v, n, prev_l, u), dtype,
    )
    args = [to_torch(a) for a in (eta, v, n)]
    base = TB.disney_sample(tmat(to_torch(mv)), *args, to_torch(prev_l), torch.from_numpy(u))
    assert torch.isfinite(base.pdf).all() and all(torch.isfinite(c).all() for c in base.f)
    if not grazing:
        # The stale-l quirk is live: the previous bounce's direction
        # changes the specular lobe's Fresnel, hence its pdf.
        other = Inputs(dtype, 7).unit()
        alt = TB.disney_sample(tmat(to_torch(mv)), *args, to_torch(other), torch.from_numpy(u))
        assert not torch.equal(alt.pdf, base.pdf)
