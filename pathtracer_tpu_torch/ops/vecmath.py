"""Vector math over structure-of-arrays batches, in PyTorch.

Port of `pathtracer_tpu/ops/vecmath.py`. A `V3` is a NamedTuple of three
tensors (one per component) of any broadcastable shape, so every op is an
elementwise tensor op on the whole ray batch. Functions are dtype-generic:
float32 for the device path, float64 for the oracle comparisons.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PI = 3.14159265358979323846264338327950288
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI


class V2(NamedTuple):
    """2-vector over SoA batches (pixel coordinates, jitter)."""

    x: torch.Tensor
    y: torch.Tensor


class V3(NamedTuple):
    """3-vector over SoA batches; componentwise GLSL-style operators."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)


    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))

    def normalize(self) -> "V3":
        return self / self.length()

    def to_linear(self) -> "V3":
        """Gamma 2.2 decode."""
        return V3(self.x ** 2.2, self.y ** 2.2, self.z ** 2.2)


def v3(x, y, z, dtype=torch.float32, device=None) -> V3:
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return V3(t(x), t(y), t(z))


def splat3(a) -> V3:
    return V3(a, a, a)


def zeros3(shape=(), dtype=torch.float32, device=None) -> V3:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return V3(z, z, z)


def safe_sqrt(x):
    """sqrt clamped at zero (the double-where form of the JAX package)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.dot(b)


def cross(a: V3, b: V3) -> V3:
    return a.cross(b)


def normalize(a: V3) -> V3:
    return a.normalize()


def safe_normalize(a: V3) -> V3:
    """Normalize, mapping zero-length vectors to zero instead of NaN."""
    l2 = a.dot(a)
    ok = l2 > 0.0
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, l2, 1.0)), 0.0)
    return a * inv


def mix(a: V3, b: V3, t) -> V3:
    return a * (1.0 - t) + b * t


def mix_f(a, b, t):
    return (1.0 - t) * a + b * t


def reflect(i: V3, n: V3) -> V3:
    return i - 2.0 * n * splat3(dot(n, i))


def refract(i: V3, n: V3, eta) -> V3:
    """GLSL refract; zeros on total internal reflection."""
    ndoti = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    out = i * eta - n * (eta * ndoti + safe_sqrt(k))
    tir = k < 0.0
    return V3(
        torch.where(tir, 0.0, out.x),
        torch.where(tir, 0.0, out.y),
        torch.where(tir, 0.0, out.z),
    )


def onb(n: V3) -> tuple[V3, V3]:
    """Orthonormal basis around n: up = +z unless |n.z| >= 0.999, then +x."""
    cond = torch.abs(n.z) < 0.999
    zero = torch.zeros_like(n.z)
    one = torch.ones_like(n.z)
    up = V3(torch.where(cond, zero, one), zero, torch.where(cond, one, zero))
    t = safe_normalize(cross(up, n))
    b = cross(n, t)
    return t, b


def to_local(t: V3, b: V3, n: V3, v: V3) -> V3:
    return V3(dot(v, t), dot(v, b), dot(v, n))


def to_world(t: V3, b: V3, n: V3, v: V3) -> V3:
    return t * v.x + b * v.y + n * v.z


def where3(cond, a: V3, b: V3) -> V3:
    return V3(
        torch.where(cond, a.x, b.x),
        torch.where(cond, a.y, b.y),
        torch.where(cond, a.z, b.z),
    )


def mask3(mask, v: V3) -> V3:
    """Zero the lanes where `mask` is false."""
    return V3(
        torch.where(mask, v.x, 0.0),
        torch.where(mask, v.y, 0.0),
        torch.where(mask, v.z, 0.0),
    )


def luminance(c: V3) -> torch.Tensor:
    """Rec.709 luminance."""
    return 0.212671 * c.x + 0.715160 * c.y + 0.072169 * c.z
