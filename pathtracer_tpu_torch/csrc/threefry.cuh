// Scalar per-thread twin of ops/rng.py: threefry2x32 (20 rounds) and the
// float32 uniform at a 64-bit flat counter, bit-equal to jax.random.uniform
// under JAX's partitionable threefry layout.
#pragma once

#include <stdint.h>

namespace pt {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// Uniform in [0, 1) at flat index i of a draw under key (k0, k1).
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1, uint64_t i) {
  uint32_t x0 = (uint32_t)(i >> 32);
  uint32_t x1 = (uint32_t)(i & 0xFFFFFFFFull);
  threefry2x32(k0, k1, x0, x1);
  return (float)((x0 ^ x1) >> 9) * (1.0f / 8388608.0f);
}

}  // namespace pt
