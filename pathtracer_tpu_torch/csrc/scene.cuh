// The packed scene vector as a thread reads it, for every backend: the
// camera basis at its head, the backend's own records, then L light records
// of 15 and M material records of 20 (ops/megakernel.pack_scene,
// ops/megakernel_sdf.pack_sdf_scene, ops/megakernel_mesh.pack_mesh_scene,
// ops/megakernel_bigmesh.pack_bigmesh_scene, the JAX package's layouts):
//
//   [0, 12)   camera lower_left(3) horizontal(3) vertical(3) origin(3)
//   ...       the backend's records (analytical.cuh, sdf.cuh, mesh.cuh;
//             bigmesh.cuh has none, its tables come beside the vector)
//   L x 15    light: position(3) emission(3) u(3) v(3) radius area type
//   M x 20    material: rgb(3) anisotropic emission(3) metallic roughness
//             subsurface specular_tint sheen sheen_tint clearcoat
//             clearcoat_gloss spec_trans ior opacity alpha_mode alpha_cutoff
//
// A scene whose material table declares a medium packs M records of 26
// instead: the 20 above, then the medium's type density color(3)
// anisotropy. The kernels' media instantiation reads them into a
// MediaMaterial (load_material's overloads); the media-free one never sees
// them.
#pragma once

#include "bsdf.cuh"

namespace pt {

enum : int {
  SV_LOWER_LEFT = 0,
  SV_HORIZONTAL = 3,
  SV_VERTICAL = 6,
  SV_CAM_ORIGIN = 9,
  LIGHT_STRIDE = 15,
  MAT_STRIDE = 20,
  MAT_STRIDE_MEDIA = 26,
};

__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }

// The packed scene with its static structure, as the launch gives it.
struct SceneView {
  const float* sv;
  int n_lights;
  int n_materials;
  bool respect_max_dist;  // analytical: shadow rays stop at the light
  int lights_at;          // where the light records start; the materials follow them
  int n_spheres, n_boxes, n_tori;  // the SDF scene's primitives (0 for the analytical one)
  // The small mesh's topology, n_tris records of (a, b, c, material), and
  // the triangle table the kernels stage from it in shared memory beside
  // the packed vector (mesh.cuh).
  const int* topo = nullptr;
  int n_tris = 0;
  const float4* tris = nullptr;
  // The big mesh's tables in global memory (bigmesh.cuh): coef [n_chunks *
  // 128, 16], attr [8, n_chunks * 128], aabb [n_chunks, 8].
  const float* coef = nullptr;
  const float* attr = nullptr;
  const float* aabb = nullptr;
  int n_chunks = 0;

  __device__ __forceinline__ const float* light(int i) const { return sv + lights_at + i * LIGHT_STRIDE; }
  __device__ __forceinline__ const float* material(int i) const {
    return sv + lights_at + n_lights * LIGHT_STRIDE + i * MAT_STRIDE;
  }
};

__device__ __forceinline__ Material load_material(const float* p) {
  Material m = default_material();
  m.rgb = load3(p + 0);
  m.anisotropic = p[3];
  m.emission = load3(p + 4);
  m.metallic = p[7];
  m.roughness = p[8];
  m.subsurface = p[9];
  m.specular_tint = p[10];
  m.sheen = p[11];
  m.sheen_tint = p[12];
  m.clearcoat = p[13];
  m.clearcoat_gloss = p[14];
  m.spec_trans = p[15];
  m.ior = p[16];
  m.opacity = p[17];
  m.alpha_mode = (int)p[18];
  m.alpha_cutoff = p[19];
  return m;
}

// The medium a material fills its inside with: type 0 none (vacuum), 1
// Absorb, 2 Scatter (HG of anisotropy g), 3 Emissive.
struct Medium {
  int type;
  float density;
  V3 color;
  float aniso;
};

__device__ __forceinline__ Medium vacuum() { return {0, 0.0f, splat3(0.0f), 0.0f}; }

// A material with its medium, as the media instantiation's closest hit
// returns it; assigning a Material (Material::new on a miss) leaves it
// vacuum.
struct MediaMaterial : Material {
  Medium medium;
  __device__ __forceinline__ MediaMaterial& operator=(const Material& m) {
    Material::operator=(m);
    medium = vacuum();
    return *this;
  }
};

// The backends' closest hits load material i into `m`: a record of 20, or of
// 26 with its medium.
__device__ __forceinline__ void load_material(const SceneView& s, int i, Material& m) {
  m = load_material(s.material(i));
}

__device__ __forceinline__ void load_material(const SceneView& s, int i, MediaMaterial& m) {
  const float* p = s.sv + s.lights_at + s.n_lights * LIGHT_STRIDE + i * MAT_STRIDE_MEDIA;
  m = load_material(p);
  m.medium = {(int)p[20], p[21], load3(p + 22), p[25]};
}

// The sky shared by the demo scenes: gamma-2.2-decoded lerp of horizon and
// zenith by 0.5 (rd.y + 1), times scale; `sky` points at horizon(3)
// zenith(3) scale.
__device__ __forceinline__ V3 sky_background(const float* sky, V3 rd) {
  float t = 0.5f * (rd.y + 1.0f);
  V3 c = mix(load3(sky), load3(sky + 3), t);
  return to_linear(c) * splat3(sky[6]);
}

}  // namespace pt
