"""Counter-based threefry2x32 random numbers, bit-equal to `jax.random`.

A key is a CPU int64 tensor of shape [2] holding two uint32 words, built
like `jax.random.PRNGKey` and split like `jax.random.split` under JAX's
partitionable threefry layout:

- `split(key, n)[i] == threefry2x32(key, (hi(i), lo(i)))`;
- the float32 uniform at flat index i of a draw of any shape is
  `((x0 ^ x1) >> 9) * 2**-23` with `(x0, x1) = threefry2x32(key, (hi(i), lo(i)))`;
- the float64 uniform takes the top 52 bits of `(x0 << 32) | x1`.

This plain version works in int64 with explicit 32-bit masks because CPU
torch has patchy uint32 support. The CUDA megakernel draws the same
numbers in-kernel (`csrc/threefry.cuh`).
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key, c0, c1):
    """Threefry-2x32 with 20 rounds on uint32 values held in int64 tensors
    or in Python ints."""
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the 64-bit seed as (high, low) words."""
    s = int(seed) % (1 << 64)
    return torch.tensor([s >> 32, s & MASK32], dtype=torch.int64)


def fold_in(key, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: threefry2x32 of the key at the
    counter (0, data) -> a new [2] int64 key."""
    return torch.tensor(threefry2x32(key, 0, int(data) & MASK32), dtype=torch.int64)


def split(key, n: int = 2) -> torch.Tensor:
    """`jax.random.split(key, n)` -> [n, 2] int64 keys (on the CPU). Keys
    are few, so this runs on Python ints: no tensor op per round."""
    return torch.tensor(
        [threefry2x32(key, i >> 32, i & MASK32) for i in range(n)], dtype=torch.int64
    ).reshape(n, 2)


def uniform(key, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype)` on [0, 1)."""
    n = math.prod(shape)
    return uniform_at(key, torch.arange(n, dtype=torch.int64, device=device), dtype).reshape(shape)


def uniform_at(key, index: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The uniforms at flat indices `index` (int64, any shape) of a draw
    from `key`: `uniform(key, shape, dtype).reshape(-1)[index]`, without
    drawing the rest."""
    x0, x1 = threefry2x32(key, index >> 32, index & MASK32)
    if dtype == torch.float32:
        out = ((x0 ^ x1) >> 9).to(torch.float32) * 2.0 ** -23
    elif dtype == torch.float64:
        out = ((x0 << 20) | (x1 >> 12)).to(torch.float64) * 2.0 ** -52
    else:
        raise ValueError(f"uniform: unsupported dtype {dtype}")
    return out


def uniform_f32(key, n: int, device=None) -> torch.Tensor:
    """Flat float32 uniforms [n]; what the megakernel draws per counter."""
    return uniform(key, (n,), torch.float32, device)
