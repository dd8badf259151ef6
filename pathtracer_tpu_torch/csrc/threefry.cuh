// Scalar per-thread twin of ops/rng.py: threefry2x32 (20 rounds) and the
// float32 uniform at a 64-bit flat counter, bit-equal to jax.random.uniform
// under JAX's partitionable threefry layout; and where a frame's stream puts
// each pixel's draws (integrator/tracer.draw_uniforms), which the kernels
// (K1, K2) and the stream's witness K4 (uniform_stream.cu) share.
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

// Uniforms per bounce: light pick, light r1, r2, bsdf r1, r2, lobe coin,
// alpha coin, scatter distance.
constexpr int U_PER_BOUNCE = 8;

// Flat counter of camera draw j (0 or 1) of pixel p under the key kc.
__device__ __forceinline__ uint64_t camera_counter(int p, int j) { return (uint64_t)p * 2u + (uint64_t)j; }

// Flat counter of the first draw of bounce d of pixel p under the key kb, in
// a frame of n pixels; draw j is at this + j.
__device__ __forceinline__ uint64_t bounce_counter(int n, int p, int d) {
  return ((uint64_t)d * (uint64_t)n + (uint64_t)p) * U_PER_BOUNCE;
}

// Draw k of pixel p's stream in a frame of n pixels, one sample, keys (kc,
// kb): 0 and 1 its camera draws, k >= 2 draw (k - 2) % 8 of bounce
// (k - 2) / 8, as K1's thread draws them (K4, uniform_stream.cu).
__device__ __forceinline__ float stream_draw(uint32_t kc0, uint32_t kc1, uint32_t kb0, uint32_t kb1, int n, int p,
                                             int k) {
  return k < 2 ? uniform_at(kc0, kc1, camera_counter(p, k))
               : uniform_at(kb0, kb1, bounce_counter(n, p, (k - 2) / U_PER_BOUNCE) + (k - 2) % U_PER_BOUNCE);
}

}  // namespace pt
