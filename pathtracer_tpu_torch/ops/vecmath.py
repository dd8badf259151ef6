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

    def abs(self) -> "V3":
        """|v| componentwise with jnp.abs's gradient: +1 at 0, where
        torch.abs has 0 (the two differ only in the sign of a zero)."""
        a = lambda c: torch.where(c >= 0.0, c, -c) if c.requires_grad else torch.abs(c)
        return V3(a(self.x), a(self.y), a(self.z))

    def normalize(self) -> "V3":
        return self / self.length()

    def to_linear(self) -> "V3":
        """Gamma 2.2 decode."""
        return V3(self.x ** 2.2, self.y ** 2.2, self.z ** 2.2)

    def to(self, dtype: torch.dtype) -> "V3":
        return V3(self.x.to(dtype), self.y.to(dtype), self.z.to(dtype))


class B3(NamedTuple):
    """3-vector of booleans over SoA batches."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __and__(self, o: "B3") -> "B3":
        return B3(self.x & o.x, self.y & o.y, self.z & o.z)

    def __or__(self, o: "B3") -> "B3":
        return B3(self.x | o.x, self.y | o.y, self.z | o.z)

    def __invert__(self) -> "B3":
        return B3(~self.x, ~self.y, ~self.z)

    def any(self) -> torch.Tensor:
        return self.x | self.y | self.z

    def all(self) -> torch.Tensor:
        return self.x & self.y & self.z

    def select(self, a: V3, b: V3) -> V3:
        """Componentwise where: self ? a : b."""
        return V3(torch.where(self.x, a.x, b.x), torch.where(self.y, a.y, b.y), torch.where(self.z, a.z, b.z))


def less_than(a: V3, b: V3) -> B3:
    """GLSL lessThan."""
    return B3(a.x < b.x, a.y < b.y, a.z < b.z)


def v3(x, y, z, dtype=torch.float32, device=None) -> V3:
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return V3(t(x), t(y), t(z))


def splat3(a) -> V3:
    return V3(a, a, a)


def zeros3(shape=(), dtype=torch.float32, device=None) -> V3:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return V3(z, z, z)


def ones3(shape=(), dtype=torch.float32, device=None) -> V3:
    o = torch.ones(shape, dtype=dtype, device=device)
    return V3(o, o, o)


def from_array(a: torch.Tensor) -> V3:
    """Unpack a dense [..., 3] tensor into SoA."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def hex_color(hex_str: str, dtype=torch.float32, device=None) -> V3:
    """An "#rrggbb" color, each channel / 255."""
    s = hex_str.lstrip("#")
    return v3(*(int(s[i : i + 2], 16) / 255.0 for i in (0, 2, 4)), dtype=dtype, device=device)


def safe_sqrt(x):
    """sqrt clamped at zero (the double-where form of the JAX package)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _uploads(x, c) -> bool:
    """Whether torch.as_tensor(c) on x's device is a blocking copy from the
    host to the card, which waits for the card's queue to drain."""
    return x.is_cuda and not (isinstance(c, torch.Tensor) and c.is_cuda)


def maximum(x, c):
    """jnp.maximum against a constant: a tie sends half the gradient to
    each side, where torch.clamp_min would send all of it to x. A host
    constant against a tensor on the card is uploaded with a blocking copy,
    counted in `maximum.device_reads`."""
    if _uploads(x, c):
        maximum.device_reads += 1
    return torch.maximum(x, torch.as_tensor(c, dtype=x.dtype, device=x.device))


def minimum(x, c):
    """jnp.minimum against a constant, with its half-and-half tie gradient;
    its blocking uploads counted in `minimum.device_reads`."""
    if _uploads(x, c):
        minimum.device_reads += 1
    return torch.minimum(x, torch.as_tensor(c, dtype=x.dtype, device=x.device))


maximum.device_reads = 0
minimum.device_reads = 0


def clip(x, lo, hi):
    """jnp.clip: maximum, then minimum, with their tie gradients."""
    return minimum(maximum(x, lo), hi)


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.dot(b)


def cross(a: V3, b: V3) -> V3:
    return a.cross(b)


def length(a: V3) -> torch.Tensor:
    return a.length()


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


def smoothstep(e0, e1, x):
    """Hermite step of a tensor x between e0 and e1."""
    t = clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def pow3(a: V3, b: V3) -> V3:
    """Componentwise pow."""
    return V3(a.x ** b.x, a.y ** b.y, a.z ** b.z)


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
