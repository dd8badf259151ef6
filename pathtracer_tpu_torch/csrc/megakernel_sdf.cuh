// The SDF backend of one scene's primitive counts, as megakernel_sdf.cu and
// megakernel_sdf_bwd_media.cu build it: ops/_build compiles each once for
// each count triple a scene brings, with -DSDF_SPHERES=S -DSDF_BOXES=B
// -DSDF_TORI=T, as the JAX kernel retraces for each new _sdf_meta. Every
// entry point takes the counts as it did when they were read at run time,
// and returns cudaErrorInvalidValue for counts the library was not built
// for.

#pragma once

#include "megakernel_bwd.cuh"
#include "sdf_adj.cuh"

#if !defined(SDF_SPHERES) || !defined(SDF_BOXES) || !defined(SDF_TORI)
#error "build with -DSDF_SPHERES=S -DSDF_BOXES=B -DSDF_TORI=T (ops/_build.py)"
#endif

namespace pt {

// The counts this library was built for.
using SceneCounts = SdfCounts<SDF_SPHERES, SDF_BOXES, SDF_TORI>;
using SdfScene = Sdf<SceneCounts>;
using SdfSceneAdj = SdfAdj<SceneCounts>;

// One launch of the SDF scene's kernels: cudaErrorInvalidValue for counts
// other than the build's, else `launch()` (a cudaError_t).
template <class F>
int sdf_launch(int n_spheres, int n_boxes, int n_tori, F launch) {
  return SceneCounts::matches(n_spheres, n_boxes, n_tori) ? launch() : (int)cudaErrorInvalidValue;
}

}  // namespace pt

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
