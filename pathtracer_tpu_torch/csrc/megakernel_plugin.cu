// K1's and K3's entry points, and K2's record and adjoint kernels, for one
// scene-backend plugin: a scene family that code outside the package
// registers (ops/megakernel.KernelBackend, register_backend), the port of
// the JAX package's KernelBackend and register_backend
// (pathtracer_tpu/ops/megakernel.py:696-799), whose generic kernel body
// takes any backend. ops/_build.py compiles this one file for each plugin
// into a library of its own (libplugin_<name>.so), with
//   -include <the plugin's header>   its backend structs, in CUDA C++
//   -DPT_PLUGIN=<struct>             tracer.cuh's forward hooks
//   -DPT_PLUGIN_ADJ=<struct>         tracer_adj.cuh's hooks as well (K2);
//                                    absent for a forward-only plugin
// and without FMA contraction (-fmad=false), so that K2's record kernel
// retraces K1's paths bit for bit: nvcc contracts the inlined BSDF apart
// in two kernels' copies otherwise (megakernel_mesh.cu).
//
// The plugin's packed vector holds the camera (12 scalars), the plugin's
// own records, then L light records of 15 and M material records of 20
// (26 with the medium: the MEDIA instantiations), the layout of
// ops/pack.py's helpers; the entry points find where the lights start from
// the vector's length (tracer.cuh plugin_view). Beside the vector come the
// plugin's extra tensors: a table of n_extras float32 device pointers
// (scene.cuh SceneView::extras); K2 takes none. The launches run the
// per-thread loop (megakernel_fwd.cuh Tiling's default), one thread a
// pixel; a plugin struct adds no kernel of its own: its hooks inline into
// K1's, K3's and K2's templates as the built-in backends' do, and what
// bounds a launch is what bounds theirs (instruction throughput: the
// plugin's intersection and the shading). The frame's pixel range and the stream come last, as
// in every K1 entry point.

#include "megakernel_bwd.cuh"
#include "megakernel_fwd.cuh"

#ifndef PT_PLUGIN
#error "PT_PLUGIN names the plugin's forward backend struct (ops/_build.py sets it)"
#endif

namespace {

using Plugin = PT_PLUGIN;
// The plugins' number in the layout and resource entry points (0-3 are the
// built-in backends'); in pt_backward_resources PLUGIN + 1 is K2's MEDIA
// instantiation.
constexpr int PLUGIN = 4;

// The plugin's view, or an invalid one (lights_at < 12) where the vector
// cannot hold the camera, the lights and the materials.
template <bool MEDIA>
bool view_of(pt::SceneView& s, int n_sv, int n_lights, int n_materials, int flags, const float* const* extras,
             int n_extras) {
  s = pt::plugin_view(nullptr, n_sv, n_lights, n_materials, MEDIA, flags, extras, n_extras);
  return s.lights_at >= pt::SV_CAM_ORIGIN + 3 && n_extras >= 0 && (n_extras == 0 || extras != nullptr);
}

template <bool MEDIA>
int forward(const float* sv, int n_sv, const uint32_t* keys, float* out, int* entered, int width, int height, int spp,
            int depth, int n_lights, int n_materials, int flags, const float* const* extras, int n_extras,
            int p_begin, int p_count, void* stream) {
  pt::SceneView s;
  if (!view_of<MEDIA>(s, n_sv, n_lights, n_materials, flags, extras, n_extras)) return (int)cudaErrorInvalidValue;
  return pt::launch_forward<Plugin, MEDIA>(sv, n_sv, keys, out, entered, width, height, spp, depth, flags, p_begin,
                                           p_count, s, stream);
}

}  // namespace

// K3's entry point: one frame's pixel range [p_begin, p_begin + p_count) of
// the plugin's scene, and the bounces each sample's path entered alive
// written to `entered` (int32 [spp, H, W]); with a null `entered` the
// launch is K1's. 0 = success, else a cudaError_t.
extern "C" int pt_render_forward_occupancy_plugin(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                  int* entered, int width, int height, int spp, int depth,
                                                  int n_lights, int n_materials, int flags,
                                                  const float* const* extras, int n_extras, int p_begin, int p_count,
                                                  void* stream) {
  return forward<false>(sv, n_sv, keys, out, entered, width, height, spp, depth, n_lights, n_materials, flags,
                        extras, n_extras, p_begin, p_count, stream);
}

// K1's: K3's arguments without `entered`.
extern "C" int pt_render_forward_plugin(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                        int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                        const float* const* extras, int n_extras, int p_begin, int p_count,
                                        void* stream) {
  return forward<false>(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights, n_materials, flags, extras,
                        n_extras, p_begin, p_count, stream);
}

// The media instantiation's: the same arguments over a packed vector whose
// material records hold 26 scalars.
extern "C" int pt_render_forward_occupancy_media_plugin(const float* sv, int n_sv, const uint32_t* keys, float* out,
                                                        int* entered, int width, int height, int spp, int depth,
                                                        int n_lights, int n_materials, int flags,
                                                        const float* const* extras, int n_extras, int p_begin,
                                                        int p_count, void* stream) {
  return forward<true>(sv, n_sv, keys, out, entered, width, height, spp, depth, n_lights, n_materials, flags, extras,
                       n_extras, p_begin, p_count, stream);
}

extern "C" int pt_render_forward_media_plugin(const float* sv, int n_sv, const uint32_t* keys, float* out, int width,
                                              int height, int spp, int depth, int n_lights, int n_materials, int flags,
                                              const float* const* extras, int n_extras, int p_begin, int p_count,
                                              void* stream) {
  return forward<true>(sv, n_sv, keys, out, nullptr, width, height, spp, depth, n_lights, n_materials, flags, extras,
                       n_extras, p_begin, p_count, stream);
}

extern "C" int pt_forward_takes_range() { return 1; }

// K1's and K3's resources and layout (megakernel_fwd.cu's
// pt_forward_resources and pt_forward_layout) for backend PLUGIN.
extern "C" int pt_forward_resources(int backend, int media, int count, int n_sv, int n_tris, int* out) {
  if (backend != PLUGIN) return (int)cudaErrorInvalidValue;
  switch (2 * (media != 0) + (count != 0)) {
    case 0: return pt::forward_resources<Plugin, false, false>(n_sv, n_tris, out);
    case 1: return pt::forward_resources<Plugin, false, true>(n_sv, n_tris, out);
    case 2: return pt::forward_resources<Plugin, true, false>(n_sv, n_tris, out);
    default: return pt::forward_resources<Plugin, true, true>(n_sv, n_tris, out);
  }
}

extern "C" int pt_forward_layout(int backend, int media, int n_sv, int n_tris, long long* out) {
  if (backend != PLUGIN) return (int)cudaErrorInvalidValue;
  media ? pt::forward_layout<Plugin, true>(n_sv, n_tris, out) : pt::forward_layout<Plugin, false>(n_sv, n_tris, out);
  return 0;
}

#ifdef PT_PLUGIN_ADJ

namespace {

using PluginAdj = PT_PLUGIN_ADJ;

template <bool MEDIA>
int record(const float* sv, int n_sv, const uint32_t* keys, float* rec, int width, int height, int spp, int depth,
           int n_lights, int n_materials, int flags, const float* const* extras, int n_extras, int p0, int pixels,
           int k0, int samples, void* stream) {
  pt::SceneView s;
  if (!view_of<MEDIA>(s, n_sv, n_lights, n_materials, flags, extras, n_extras)) return (int)cudaErrorInvalidValue;
  return pt::launch_record<PluginAdj, MEDIA>(sv, n_sv, keys, rec, width, height, spp, depth, flags, s,
                                             {p0, pixels, k0, samples}, stream);
}

template <bool MEDIA>
int adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct, float* rec, float* partial, int width,
            int height, int spp, int depth, int n_lights, int n_materials, int flags, const float* const* extras,
            int n_extras, int p0, int pixels, int k0, int samples, void* stream) {
  pt::SceneView s;
  if (!view_of<MEDIA>(s, n_sv, n_lights, n_materials, flags, extras, n_extras)) return (int)cudaErrorInvalidValue;
  return pt::launch_adjoint<PluginAdj, MEDIA>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth, flags, s,
                                              {p0, pixels, k0, samples}, stream);
}

}  // namespace

// K2's entry points for the plugin (megakernel_bwd.cu's
// pt_render_backward_record and pt_render_backward_adjoint, with the extras'
// table and count after the flags), without and with the medium; the
// reduction is megakernel_bwd.cu's.
extern "C" int pt_render_backward_plugin_record(const float* sv, int n_sv, const uint32_t* keys, float* rec,
                                                int width, int height, int spp, int depth, int n_lights,
                                                int n_materials, int flags, const float* const* extras, int n_extras,
                                                int p0, int pixels, int k0, int samples, void* stream) {
  return record<false>(sv, n_sv, keys, rec, width, height, spp, depth, n_lights, n_materials, flags, extras, n_extras,
                       p0, pixels, k0, samples, stream);
}

extern "C" int pt_render_backward_plugin_adjoint(const float* sv, int n_sv, const uint32_t* keys, const float* ct,
                                                 float* rec, float* partial, int width, int height, int spp,
                                                 int depth, int n_lights, int n_materials, int flags,
                                                 const float* const* extras, int n_extras, int p0, int pixels,
                                                 int k0, int samples, void* stream) {
  return adjoint<false>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth, n_lights, n_materials, flags,
                        extras, n_extras, p0, pixels, k0, samples, stream);
}

extern "C" int pt_render_backward_media_plugin_record(const float* sv, int n_sv, const uint32_t* keys, float* rec,
                                                      int width, int height, int spp, int depth, int n_lights,
                                                      int n_materials, int flags, const float* const* extras,
                                                      int n_extras, int p0, int pixels, int k0, int samples,
                                                      void* stream) {
  return record<true>(sv, n_sv, keys, rec, width, height, spp, depth, n_lights, n_materials, flags, extras, n_extras,
                      p0, pixels, k0, samples, stream);
}

extern "C" int pt_render_backward_media_plugin_adjoint(const float* sv, int n_sv, const uint32_t* keys,
                                                       const float* ct, float* rec, float* partial, int width,
                                                       int height, int spp, int depth, int n_lights, int n_materials,
                                                       int flags, const float* const* extras, int n_extras, int p0,
                                                       int pixels, int k0, int samples, void* stream) {
  return adjoint<true>(sv, n_sv, keys, ct, rec, partial, width, height, spp, depth, n_lights, n_materials, flags,
                       extras, n_extras, p0, pixels, k0, samples, stream);
}

// The record and adjoint kernels' resources (megakernel_bwd.cu's
// pt_backward_resources): backend PLUGIN the media-free instantiation,
// PLUGIN + 1 the MEDIA one.
extern "C" int pt_backward_resources(int backend, int n_sv, int n_tris, int* out) {
  if (backend == PLUGIN) return pt::backward_resources<PluginAdj, false>(n_sv, n_tris, out);
  if (backend == PLUGIN + 1) return pt::backward_resources<PluginAdj, true>(n_sv, n_tris, out);
  return (int)cudaErrorInvalidValue;
}

#endif  // PT_PLUGIN_ADJ

extern "C" const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
