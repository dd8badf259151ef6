// The megakernels' in-kernel uniform stream, exposed for validation (K4).
//
// Replaces the TPU kernel pathtracer_tpu/ops/megakernel.py::
// debug_uniform_stream, which returns the first n_uniforms draws of every
// lane of the TPU kernel's own stream (the core PRNG seeded per frame seed
// and tile). The kernels here draw threefry2x32 at JAX's counters instead
// (threefry.cuh), so this kernel witnesses that stream: out[t, k, r, l] is
// draw k of the thread K1 runs for pixel p = (t * tile_rows + r) * 128 + l of
// a frame of N = num_tiles * tile_rows * 128 pixels, one sample, keys (kc,
// kb) = split(key): draws 0 and 1 are its camera draws, draw k >= 2 is draw
// (k - 2) % 8 of bounce (k - 2) / 8 (threefry.cuh stream_draw, over the
// camera_counter, bounce_counter and uniform_at that K1 draws with).
//
// What bounds it: integer operations, ~90 a draw (threefry's 20 rounds and
// key injections, the counter, the output bits), against 4 bytes written. A
// block writes one (tile, draw) row of tile_rows x 128 floats, neighbouring
// threads neighbouring floats, so the stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace pt {

constexpr int STREAM_THREADS = 256;
constexpr int STREAM_LANES = 128;

// One block per (tile t, draw k): its tile_rows x 128 outputs, contiguous.
__global__ void __launch_bounds__(STREAM_THREADS)
    uniform_stream_kernel(const uint32_t* __restrict__ keys, float* __restrict__ out, int n_uniforms,
                          int tile_rows, int n) {
  const uint32_t kc0 = keys[0], kc1 = keys[1], kb0 = keys[2], kb1 = keys[3];
  const int t = blockIdx.x / n_uniforms, k = blockIdx.x % n_uniforms;
  const int per_tile = tile_rows * STREAM_LANES;
  float* o = out + (int64_t)blockIdx.x * per_tile;
  for (int e = threadIdx.x; e < per_tile; e += blockDim.x) {
    const int p = t * per_tile + e;  // (t * tile_rows + r) * 128 + l
    o[e] = stream_draw(kc0, kc1, kb0, kb1, n, p, k);
  }
}

}  // namespace pt

// Writes out [num_tiles, n_uniforms, tile_rows, 128] float32 for the keys
// (kc0, kc1, kb0, kb1) on the card, on `stream`; returns cudaGetLastError()
// (0 = success).
extern "C" int pt_uniform_stream(const uint32_t* keys, float* out, int num_tiles, int n_uniforms, int tile_rows,
                                 void* stream) {
  const int n = num_tiles * tile_rows * pt::STREAM_LANES;
  pt::uniform_stream_kernel<<<num_tiles * n_uniforms, pt::STREAM_THREADS, 0, (cudaStream_t)stream>>>(
      keys, out, n_uniforms, tile_rows, n);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
