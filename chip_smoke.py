#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (Hopper, sm_90a).

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each of
which raises on failure (non-zero exit):

1. card: name and power limit (nvidia-smi), torch and nvcc versions;
2. build: the CUDA kernels of pathtracer_tpu_torch/csrc, timed, the SDF
   backend's libraries (megakernel_sdf.cu, megakernel_sdf_bwd_media.cu)
   for the demo scene's primitive counts (1, 1, 1) among them, all side by
   side; the seconds each library took;
3. kernel vs its plain PyTorch version on the card, depth 4: 320x240 at
   spp 1 and 2 VERBATIM and spp 1 FIXED, 1100x3 at spp 2 FIXED (its last
   tile of paths part empty), and the main path's 1920x1080;
4. kernel vs the committed JAX render tests/golden_torch/analytical_64x48_d4_k3.npy;
5. main path: the port's CLI renders 8 progressive 1920x1080 depth-4
   frames to a PNG; every frame must be one kernel launch. Then per-frame
   times (CUDA events, after a warm-up) of the kernel's wrapper
   render_frame_megakernel (scene pack, key upload, launch), of the
   launch alone, and of the plain version.
6. the backward megakernel K2 (two kernels: the record kernel traces each
   sample's path once and writes what each bounce decided, the adjoint
   kernel runs the reverse sweep from those records) vs its plain version
   (autograd of the eager frame rendered from the same packed scene) on
   the card: d(sum(ct *
   frame))/d(sv) for a numpy-seeded cotangent at 320x240, depth 4, spp 1
   and 2 VERBATIM and spp 1 FIXED, and at 1920x1080 when the plain
   version's peak memory, measured at 320x240 and scaled, fits;
7. K2 vs the committed JAX gradient
   tests/golden_torch/grad_analytical_64x48_d4_k3.npz, through the
   autograd Function and pack_scene to the scene leaves (one K1 launch, one
   K2 call: one record and one adjoint kernel launch);
8. the trainer: the port's invert CLI at 256x192, depth 4, 10 steps, where
   every step must be 2 launches of K1 and 1 call of K2, one launch of each
   of its kernels (the target 4 of K1)
   and the loss must fall; then the kernel path's first 3 losses against
   the eager path's on the card at 64x48;
9. times (CUDA events, after a warm-up) at 1920x1080, depth 4, spp 1: one
   training step through the kernels, K2 alone, its record kernel and its
   adjoint kernel apart on one record buffer, and the
   plain version's step and gradient; the record buffer's bytes, and each
   kernel's registers, stack, spills, shared memory and blocks an SM;
10. K1 with the SDF backend (K5) vs its plain version on the card, depth 4:
   320x240 at spp 1 and 2 VERBATIM and spp 1 FIXED, and 1920x1080; a
   smooth union (smooth_k 0.3) at 320x240; then vs the committed JAX
   render tests/golden_torch/sdf_64x48_d4_k3.npy;
11. the SDF main path: the render CLI with --scene sdf renders 8
   progressive 1920x1080 depth-4 frames; every frame must be one launch of
   K1 with the SDF backend (the library built for the scene's counts).
   Then per-frame times of the wrapper, the launch alone and the plain
   version, and ray segments per second;
12. the march-step counter K6 vs its plain version at 320x240 and
   1920x1080 (center rays, no random numbers): per-pixel trip counts of
   the primary and the NEE shadow march, per pixel and per warp, and the
   times of K6's wrapper measure_march_steps (pack, launch, per-warp
   reductions, host reads) and of its pack and launch alone. The SDF
   frame's bound counts every march of the 1080p frame (every segment's
   closest hit and every shadow ray K1 casts; tools/work.count_sdf_work),
   and prints beside it what the warps issue (each march until its
   slowest lane stops).
13. K2 with the SDF backend (the adjoint of K5, csrc/sdf_adj.cuh) vs its
   plain version (autograd of the eager frame of unpack_sdf_scene's
   scene), as phase 6: 320x240 depth 4 at spp 1 and 2 VERBATIM, spp 1
   FIXED and a smooth union (smooth_k 0.3), and 1920x1080 when the plain
   version fits; the grazing pixels are masked beside the knife-edge ones;
14. K2-SDF through the autograd Function and pack_sdf_scene to the scene
   leaves vs the committed JAX gradients
   tests/golden_torch/grad_sdf_64x48_d4_k3.npz (every float leaf) and
   grad_sdf_32x16_d2_k3.npz (the two radii);
15. the SDF trainer: the invert CLI with --scene sdf at 256x192, depth 4,
   10 steps, every step 2 launches of K1-SDF and 1 of K2-SDF (the target
   4 of K1-SDF) and the loss falling; then the kernel path's first 3
   losses (the 2nd and 3rd follow K2's gradients; rtol 1e-4) and its
   leaves after step 3 (rtol 1e-2) against the eager path's on the card
   at 64x48;
16. times at 1920x1080, depth 4, spp 1: one SDF training step through the
   kernels, K2-SDF alone and its two kernels apart (as phase 9), the plain
   step and the plain gradient; with `--other DIR` (another checkout, e.g.
   the parent commit unpacked with `git archive`), phase 24 times the
   analytical and SDF K2 of that tree against this one's in turns
   (tools/k2_pair.py), saying whether their gradients are bit-equal and
   the largest difference where they are not, which must stay within 1e-5
   of the other's largest entry (PAIR_MAX_REL), and the record kernels
   alone in turns, their records bit-equal;
17. K1 with the mesh backend (K7, csrc/mesh.cuh: each block's staged
   triangle table, the compacted loop) vs its plain version on the card,
   depth 4: 320x240 at spp 1 and 2 VERBATIM and spp 1 FIXED, and
   1920x1080; then vs the committed JAX render
   tests/golden_torch/mesh_64x48_d4_k3.npy;
18. the mesh main path: the render CLI with --scene mesh renders 8
   progressive 1920x1080 depth-4 frames, every frame exactly one launch of
   K1 with the mesh backend and no other launch. Then the times of the
   wrapper, the launch alone and the plain version, ray segments per
   second, and the bound from this frame's triangle tests
   (tools/work.count_mesh_work: the tests K7 and K8 make, shadow rays only
   where K1 casts one; the small mesh's at MESH_TRI_OPS a test on its
   staged table);
19. and 20. the same for the big mesh backend (K8, csrc/bigmesh.cuh) and
   --scene bigmesh, against tests/golden_torch/bigmesh_64x48_d4_k3.npy; the
   plain version walks blocks of rays at 1920x1080, and the bound counts
   the box tests and the (ray, triangle) pairs of K8's walks, each pair up
   to the guard at which mt_hit returns, with the pairs the warps run for
   the union of their lanes' chunks printed beside it. The render CLI's 8
   frames must build the big mesh's tables once
   (ops/megakernel_bigmesh.bigmesh_tables.builds). A CUDA big mesh scene whose
   vertices require grad must raise NotImplementedError (K2 takes no big
   mesh; the JAX package differentiates it through its XLA twin), and
   launch nothing;
21. K2 with the mesh backend (K7's adjoint, csrc/mesh_adj.cuh) vs its
   plain version as phase 6: 320x240 depth 4 at spp 1 and 2 VERBATIM and
   spp 1 FIXED, and 1920x1080 when the plain version fits; the pixels whose
   plain path passes near an edge are masked beside the knife-edge ones,
   counted, and may be at most 0.1% of the frame; then its record kernel
   traces K1's paths: on the mesh demo (depth 4) and the mesh's glass
   Scatter scene (K2 MEDIA, depth 6) at 1920x1080, the bounces each path
   entered in the records equal K3's counts for the same keys, lane for
   lane (check_record_paths);
22. K2-mesh through the autograd Function and pack_mesh_scene to every
   scene leaf (the 17 vertices included) vs the committed JAX gradient
   tests/golden_torch/grad_mesh_64x48_d4_k3.npz;
23. the mesh trainer: inverse_render(kernel="megakernel") recovering the
   pyramid's apex (y raised from 0.9 to 1.25) and the light's emission
   (x 0.45), selecting the vertices' y and the emission, lr 3e-2, spp 1,
   at 256x192, depth 4, 10 steps toward a K1-mesh render of the demo mesh:
   every step exactly 2 launches of K1-mesh and 1 of K2-mesh (the target 1
   of K1-mesh), no other backend's, and the loss falling; then the kernel
   path's first 3 losses and its leaves after step 3 against the eager
   path's on the card at 64x48 (phase 15's tolerances);
24. times at 1920x1080, depth 4, spp 1: one mesh training step through the
   kernels, K2-mesh alone and its two kernels apart (as phase 9), and the
   plain step and plain gradient, K2-mesh's bound from this frame's
   triangle tests; with `--other DIR`, the analytical and SDF K2 of that
   tree against this one's in turns (tools/k2_pair.py --scene analytical
   sdf);
25. K3, the occupancy kernel (K1 that also writes the bounces each
   sample's path entered alive), on each of the four backends: against its
   plain version (integrator/tracer.bounces_entered), per lane and in its
   alive fractions, with its frame bit-equal to K1's, at 320x240 depth 4
   spp 1 and 2 VERBATIM and spp 1 FIXED, and at 1920x1080; the render CLI
   with --occupancy at 1920x1080, 2 frames, which must launch K3 once and
   K1 once a frame, with the scene's backend, and nothing else; the K3 and
   K1 launches in turns (tools/k1_pair.in_turns), frames bit-equal; the
   1080p frame's alive fractions entering each bounce per lane, per block
   and per warp, the idle lanes of the live warps (the per-thread loop's
   share) and, on a backend that runs the compacted loop, the idle lane
   slots its tiles leave (occupancy_stats' compacted_wasted_fraction, for
   the tile that ops/megakernel.forward_layout reads from the library);
   K3's bound is K1's (phases 5, 12, 18, 20) plus the counts' bytes;
26. K4, the uniform stream (ops/megakernel.debug_uniform_stream): bit-equal
   to its plain version at the size of a 1080p depth-4 frame's stream
   (2025 tiles x 34 draws x 8 x 128 lanes), its statistics there
   (tools/validate_rng's thresholds), tools/validate_rng itself (its main
   path: two launches), its time and its bound, the least integer work
   a draw over the integer pipes' rates (K4_INT_OPS, K4_ADD_OPS).

27. participating media: K1's MEDIA instantiation (the segment inside a
   medium, the Scatter event, the medium transition; ops/megakernel
   selects it for a scene whose material table declares a medium) vs its
   plain version on the card, depth 6, on tests/test_medium.py's glass
   sphere (sphere 1: spec_trans 1, roughness 0.05, ior 1.5) filled with
   Absorb, Emissive, Scatter g 0 and Scatter g 0.4 (the demo: density 0.8,
   color (0.9, 0.2, 0.1)): 320x240 at spp 1 and 2 VERBATIM and spp 1
   FIXED, and 1920x1080 spp 1; the SDF, mesh and big mesh demos with a
   glass Scatter material at 320x240; the Scatter demo at 1100x3 spp 2
   FIXED (a part-empty tile); then vs the committed JAX render
   tests/golden_torch/media_analytical_64x48_d6_k3.npy. The pixels that
   took another branch (|diff| > 1e-3) are counted; on the mesh, the
   pixels whose plain path meets two coplanar triangles at once (the
   cube's bottom face lies on the floor; ops/megakernel_mesh.hit_ties)
   are left out and counted. The MEDIA instantiations'
   registers and spills are printed, and the analytical and mesh K1's and
   K1 MEDIA's registers, stack, shared memory a block and blocks an SM
   (with `--other DIR`, the other tree's registers and spills beside
   them);
28. the media main path: 8 progressive 1920x1080 depth-6 frames of the
   Scatter demo through render_frame_megakernel and accumulate, written to
   a PNG, every frame exactly one launch of K1's MEDIA instantiation and
   nothing else; the times of the wrapper, the launch alone and the plain
   version, and the bound from this frame's segments, those inside the
   medium and the scatter events (tools/work.count_media_work); a CUDA
   media scene whose leaves require grad renders with one K1 MEDIA launch,
   and its backward is one K2 MEDIA launch and nothing else. With `--other
   DIR`, K1 and K3 of both trees on each backend's demo and on each
   backend's glass Scatter scene (k1_pair.MEDIA_SCENES: K1 MEDIA) in turns
   (tools/k1_pair.pair), frames and counts bit-equal, but for the small
   mesh against a tree that built it with FMA contraction
   (k1_pair.mesh_rounds_apart: there they move in the last bits; the
   entries that differ, by how much at most, and whether K3's counts are
   equal are printed, and phases 17, 25, 27 and 29 hold them to the plain
   version), and each instantiation's registers,
   stack and spills in both trees (k1_pair.resources), printed with the
   pair's time ratio;
29. K3's MEDIA instantiation vs its plain version (bounces_entered), per
   lane and in its alive fractions, its frame bit-equal to K1's MEDIA
   frame, on each backend's glass Scatter scene at 320x240 (the analytical
   one also at spp 2, FIXED and 1920x1080; the mesh's coplanar ties left
   out); then one measure_occupancy_megakernel call at 1920x1080 (one K3
   MEDIA launch), its idle lane slots per-thread and compacted, and K3
   against K1 in turns there; the idle lane slots of the mesh's glass
   Scatter scene at 1920x1080 likewise.
30. K2's MEDIA instantiation (tracer_adj.cuh media_bounce_adj: the
   segment's Absorb and Emissive terms, the Scatter event with its HG-phase
   NEE, the medium's cotangent carried through the reverse sweep) vs its
   plain version, as phase 6, depth 6: the analytical glass filled with
   Scatter g 0.4, Absorb and Emissive, and the lit-medium case (the light
   inside the Scatter medium, shadow rays that stop at it), at 320x240 spp 1
   and 2 VERBATIM and spp 1 FIXED; the Scatter demo at 1920x1080 spp 1 (at
   the largest size the plain gradient fits in, if not there); the SDF and
   mesh glass Scatter scenes at 320x240 (the SDF's grazing pixels masked
   as in phase 13, the mesh's near-edge pixels and coplanar ties as in
   phases 21 and 27). K2 MEDIA is built without FMA contraction
   (csrc/megakernel_bwd_media.cu). Its instantiations' registers, stack
   and spills and each scene's shared memory a block are printed;
31. K2 MEDIA through the autograd Function and pack_scene, every float
   leaf, against the committed JAX gradient
   tests/golden_torch/grad_media_64x48_d6_k3.npz (Absorb, Emissive, Scatter
   g 0.4 and the lit case, 64x48, depth 6, PRNGKey(3)), one K1 MEDIA and one
   K2 MEDIA launch a case; the Scatter density's gradient exactly 0;
32. the media main path: inverse_render(kernel="megakernel") recovering
   the Absorb demo's density and color (started at 0.4 and (0.5, 0.5,
   0.5)), lr 3e-2, spp 1, 256x192, depth 6, 10 steps toward a K1 MEDIA
   render: every step exactly 2 K1 MEDIA and 1 K2 MEDIA launches, no other
   backend's, and the loss falling; the kernel path's first 3 losses and
   its leaves after step 3 against the eager path's at 64x48 (phase 15's
   tolerances); then 3 steps each on the SDF and mesh glass Scatter
   scenes, 2 K1 MEDIA and 1 K2 MEDIA launches a step with their backend;
33. times: one media training step at 1920x1080, depth 6, spp 1 (the
   Scatter demo's density, color and anisotropy), K2 MEDIA's launch alone,
   the plain gradient and the plain step, and K2 MEDIA's bound from this
   frame's segments, those inside the medium and the scatter events; the
   SDF and mesh K2 MEDIA at 320x240 likewise, each with its two kernels
   apart (as phase 9). With `--other DIR`, the mesh and MEDIA K2 of that
   tree against this one's in turns (phase 24 pairs the analytical and SDF
   ones; MEDIA, built without contraction, bit-equal; the mesh within
   1e-5 of the other's largest entry, its records bit-equal, but against
   a tree that built the mesh with FMA contraction, where both are printed)
   and both trees' K2 registers, stack and spills (tools/k2_pair.resources);
34. K2 at depth 20 (the records hold any depth) vs its plain version at
   320x240, spp 1 VERBATIM and spp 2 FIXED, on the demo scene inside
   sphere 1 grown to radius 20 (paths end only on the light or at depth
   20), as phase 6; one K1 launch and one K2 call through the autograd
   Function; the record buffer capped so that the frame takes 7 chunks of
   whole blocks of pixels (bit-equal to one chunk) and, at spp 2, chunks
   of samples (within 1e-5 of the largest entry), one record kernel and
   one adjoint kernel launch a chunk, as the wrapper counts them;
35. with `--other DIR`: one training step at 1920x1080, spp 1, of the
   analytical trainer (depth 4) and of the media trainer (the Scatter
   demo's medium, depth 6), through this tree's kernels and through the
   other tree's (tools/k1_pair.kernels_of), in turns, their first losses
   bit-equal.

The total seconds, with phase 25's, phase 26's, phases 27-29's, phases
30-33's and phase 34's, are printed before the kernels line. Each K2 row
of the kernels line lists its two kernels under "stages" (the record
kernel and the adjoint kernel: their launches on the main path and their
times apart).

Image tolerance (phases 3, 4, 10, 17, 19 and 27): quantile(|diff|, 0.999) < 1e-4 and
mean(|diff|) < 1e-5, all values finite. The two sides draw the same
threefry numbers, so they differ only by float rounding (FMA contraction,
libm ulps), which can flip a rare knife-edge branch in a few pixels.

Gradient tolerance (phases 6, 13, 21, 30 and 34), at every size: with the cotangent
zeroed at the knife-edge pixels (where the two forward frames differ by
more than 1e-3: a branch taken the other way, so K2 differentiates K1's
path and the plain version another), max|g_k - g_p| <= 1e-2 max|g_p|, and
entries above 1e-2 max|g_p| agree to rtol 2e-2. Both are float32 sums over
up to 2M pixels in another order. The numbers over all pixels are printed
beside. Phase 13 also masks the grazing pixels (a path with an SDF hit at
|<rd, n>| < 1e-3, ops/megakernel_sdf.hit_cosines, where the Newton step's
1/<rd, n> makes the pixel's gradient hang on the last bits of the incoming
ray; `tests/test_torch_k2_rounding.py --scene sdf --grazing 1e-3`
differentiates those pixels with and without nvcc's contraction on the
host) and prints the numbers with only the knife-edge pixels masked
beside. Phase 21 masks likewise the pixels whose plain path passes near an
edge of the mesh (ops/megakernel_mesh.hit_margins: the winning triangle's
min(u, v, 1 - u - v) below 3e-5, or |det| below 1e-5, where the last bits
of the ray can pick the other triangle of a shared edge;
`tests/test_torch_k2_rounding.py --scene mesh --grazing 3e-5` is their
witness). Phase 30 masks no more than phases 6, 13 and 21 do: K2 MEDIA
rounds each product and sum apart (`tests/test_torch_k2_rounding.py
--media absorb --spp 2 --seed 405` shows why: with contraction the host
build sits 1.3e-2 off the plain version, without it 2e-5, every pixel
counted). Phases 7, 14 and 22: the tolerances of tests/test_torch_grad.py (rtol
5e-3 / atol 1e-8 for material, light, checker and sky leaves, rtol 1e-2 /
atol 1e-7 for the geometry, the vertices and the camera); the small SDF fixture's own
(rtol 5e-3, atol 1e-7, tests/test_torch_sdf.py). Phase 31: the same, with
the light's position and radius as geometry, and each leaf's rtol taken of
the summed magnitudes of its four row bands' gradients in the fixture where
that is larger than its own (tests/test_torch_media_grad.py: a float32 sum
rounds in proportion to its terms). Phase 12: the kernel's
and the plain version's counts are equal on at least 99.9% of the pixels
(both round the march alike; a last-bit difference at |sdf| = HIT_EPS
moves a lane by a step). Phase 25: K3's frame bit-equal to K1's; its
per-lane counts equal to the plain version's on at least 99.9% of the
lanes (a knife-edge lane may take the other branch, as a pixel may in
phase 3) and its alive fractions within 1e-3 of the plain version's.
Phase 26: K4 bit-equal to its plain version, and the stream within
tools/validate_rng's thresholds (KS below 1.63/sqrt(n), |mean - 0.5| <
0.005, cross-tile |correlation| < 0.05, cross-seed collisions < 1%).

The last stdout line is {"ok": true, "device": {...}}; the line before it
is the card's name and power limit, and the one before that lists the
kernels as JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "analytical_64x48_d4_k3.npy")
SDF_FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "sdf_64x48_d4_k3.npy")
GRAD_FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "grad_analytical_64x48_d4_k3.npz")
SDF_GRAD_FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "grad_sdf_64x48_d4_k3.npz")
SDF_GRAD_FIXTURE_SMALL = os.path.join(ROOT, "tests", "golden_torch", "grad_sdf_32x16_d2_k3.npz")
MESH_GRAD_FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "grad_mesh_64x48_d4_k3.npz")
MEDIA_FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "media_analytical_64x48_d6_k3.npy")
Q_TOL, MEAN_TOL = 1e-4, 1e-5
GRAD_MAX_TOL, GRAD_RTOL, EDGE_TOL = 1e-2, 2e-2, 1e-3
MAIN_W, MAIN_H, MAIN_DEPTH, MAIN_FRAMES = 1920, 1080, 4, 8
TRAIN_W, TRAIN_H, TRAIN_STEPS = 256, 192, 10
FIXTURE_LEAVES = (
    [f"lights.emission.{c}" for c in "xyz"] + [f"params.materials.rgb.{c}" for c in "xyz"]
    + ["params.materials.roughness", "params.sphere_center.x", "camera.origin.z"]
)
# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W): float32 and
# float64 outside the tensor cores, and device memory. 32-bit integer
# operations: 64 a clock an SM (the CUDA C++ Programming Guide's throughput
# table for compute capability 9.0: integer add, shift, funnel shift and
# bitwise ops) on 132 SMs at the 1,980 MHz boost clock.
PEAK_F32, PEAK_F64, PEAK_BYTES = 67e12, 34e12, 3.35e12
PEAK_I32 = 64 * 132 * 1.98e9
# Operations per ray segment (one bounce entered by a live path), estimated
# by reading the per-thread code for the demo scene (one light, three
# primitives) on the shading path, not counted by a profiler. K1: ~1430
# float32 operations (closest hit ~60, emitter pass ~40, NEE ~510 of which
# disney_eval ~330, disney_sample ~275, the rest ~60) plus threefry2x32's
# ~86 integer operations for each of 6 uniforms (~516, counted at the
# float32 rate), and ~100 float64 ones (five sphere tests of ~20: two in
# the closest hit, the light in the emitter pass, two in the shadow ray).
# K2: what the gradient needs, the forward above plus its adjoint (~2560
# float32: disney_eval's ~1000, disney_sample's ~500, the light sample and
# shadow ray ~260, geometry and the rest ~800, of which the analytical
# closest hit's adjoint, its normal, plane test, material scatter and
# checker, is ~100; ~45 float64 in the hit sphere's adjoint), once: K2's
# record kernel traces the path K1 traced, and its adjoint kernel
# re-evaluates each bounce's BSDF inside its adjoint; neither is counted.
# Each camera ray takes ~30 float64 operations more per pixel.
K1_OPS = dict(f32=1430, f64=100)
K2_ADJ_OPS = dict(f32=2560, f64=45)
K2_OPS = dict(f32=K1_OPS["f32"] + K2_ADJ_OPS["f32"], f64=K1_OPS["f64"] + K2_ADJ_OPS["f64"])
ANALYTICAL_HIT_ADJ_F32 = 100
CAMERA_F64_OPS = 30
# The SDF backend (csrc/sdf.cuh), read the same way for the demo scene (one
# sphere, box and torus, the plane): one march step ~75 float32 operations
# (the sphere ~10, the rounded box ~24, the torus ~14, the plane ~8, the
# union ~4, the step and its stop tests ~15); per ray segment, K1's
# shading without the analytical hit (~1370), the normal (~130: the four
# gradients and their union) and the hit tests, the argmin and the checker
# (~190), with the float64 light-sphere test of the emitter pass (~20).
# The march work is every march of the frame's steps
# (tools/work.count_sdf_work: each segment's closest hit and each shadow
# ray K1 casts) x SDF_STEP_OPS. K6 (its center rays' primary and first
# shadow march) adds, per pixel, the normal, the light sample (~60) and
# the camera ray.
SDF_STEP_OPS = 75
SDF_SEGMENT_OPS = dict(f32=1370 + 130 + 190, f64=20)
# The SDF adjoint of one hit (csrc/sdf_adj.cuh), read the same way: the
# gradient for the normal's cotangent (~130), the forward-mode pass over
# the four primitives and the union (~330: each dual operation two to
# three float32 ones), the reverse pass with the records' scatter (~250),
# the Newton step, the argmin and the checker (~110). K2-SDF's bound counts,
# as K2's does, what the gradient needs and not the replays this design
# adds: the march once (every march of K1's frame, count_sdf_work), and
# per segment the SDF forward, K2's adjoint without the
# analytical hit's and this; in float64 only the SDF forward's light test
# and the camera ray.
SDF_ADJ_OPS = 130 + 330 + 250 + 110
K6_PIXEL_OPS = dict(f32=130 + 190 + 60, f64=0)
SDF_Q_MIN = 0.999
# The mesh backends (csrc/mesh.cuh, csrc/bigmesh.cuh), read the same way: one
# two-sided Möller-Trumbore test of the small mesh ~54 float32 operations
# (two cross products, four dot products, ro - v0, the division and the
# guards; no early return) on the first vertex and edges of the block's
# staged triangle table (60 when each test formed its two edges, before
# the table); one (ray, triangle) pair of the big
# mesh's mt_hit 8 up to the determinant's guard, 14 more up to u's and 24
# more to the end (it returns
# where a guard fails); one box test of a chunk ~24. Per ray segment, K1's
# shading without the analytical hit (~1370) and the winner's normal and
# material (~25); in float64 only the light-sphere test of the emitter pass
# (~20). The tests themselves are counted from this run's rays
# (tools/work.count_mesh_work): 20 per closest hit of the small mesh and, per
# shadow ray K1 casts, those up to the first occluder; the big mesh's walks
# over its chunks, the closest hit's and the shadow ray's, pair by pair.
MESH_TRI_OPS, BIGMESH_SLAB_OPS = 54, 24
BIGMESH_DET_OPS, BIGMESH_U_OPS, BIGMESH_REST_OPS = 8, 14, 24
MESH_SEGMENT_OPS = dict(f32=1370 + 25, f64=20)
MESH_FIXTURES = {
    "mesh": os.path.join(ROOT, "tests", "golden_torch", "mesh_64x48_d4_k3.npy"),
    "bigmesh": os.path.join(ROOT, "tests", "golden_torch", "bigmesh_64x48_d4_k3.npy"),
}
SMOOTH_K = 0.3  # a smooth union, against the demo's hard min (k = 0)
GRAZING = 1e-3  # phase 13 also masks pixels with an SDF hit at |<rd, n>| below this
# Phase 21 also masks pixels with a mesh hit whose barycentric margin or
# |det| is below these, and fails if they are more than MESH_NEAR_MAX of
# the frame.
MESH_MARGIN, MESH_DET, MESH_NEAR_MAX = 3e-5, 1e-5, 1e-3
# The mesh adjoint of one closest hit (csrc/mesh_adj.cuh), read as the
# others: ray_triangle_adj (~70: two cross products, their adjoints and the
# division's), the normal's adjoint (~60: the cross product,
# safe_normalize's and cross_adj) and the material scatter (~15). K2-mesh's
# bound counts, as K2's does, what the gradient needs: K1-mesh's forward
# (per segment MESH_SEGMENT_OPS, and the triangle tests of K1's walk from
# tools/work), and per segment K2's adjoint of the shading without the
# analytical hit's and this; not the record kernel's second walk.
MESH_HIT_ADJ_OPS = 70 + 60 + 15
# Phase 15, the kernel path against the eager one at 64x48: the first 3
# losses within rtol 1e-4 (3.0e-6 measured on the H100) and the leaves after
# step 3 within 1e-2 (3.0e-3 measured). Adam's normalised steps magnify a
# few grazing pixels' rounding in the leaves: the host build of K1 and K2
# moves the torus's radius by 2.4e-4 with nvcc-like contraction and 1e-7
# without (tests/test_torch_k2_rounding.py --scene sdf --trainer 3).
SDF_TRAIN_LOSS_RTOL, SDF_TRAIN_LEAF_RTOL = 1e-4, 1e-2
# Phase 25: K3's per-lane counts equal its plain version's on at least
# OCC_SAME_MIN of the lanes (a knife-edge lane may take the other branch, as
# a pixel may in phase 3), its alive fractions within OCC_FRAC_TOL of the
# plain version's; the render CLI with --occupancy renders OCC_FRAMES frames.
OCC_SAME_MIN, OCC_FRAC_TOL, OCC_FRAMES = 0.999, 1e-3, 2
# Phase 26: K4 at the size of a 1080p depth-4 frame's stream as the TPU
# kernel tiles it (2025 tiles of 8 x 128 lanes, 2 + 8 x 4 draws).
STREAM_SEED, STREAM_TILES, STREAM_DRAWS, STREAM_ROWS = 5, 2025, 34, 8
# K4's least work a draw (threefry.cuh stream_draw), by the pipes that can
# run it at the rates of the CUDA guide's table for cc 9.0. Only the integer
# pipe (64 a clock an SM) runs threefry's 20 funnel shifts and 20 xors and
# the output's xor and shift: K4_INT_OPS. Its 20 adds, the 5 injections into
# x1 (the key-only terms hoisted; x0's fold into the next round's
# three-input add), the key added to the counter and the counter itself
# may also issue as IMAD on the float pipe (64 a clock more): K4_ADD_OPS.
# The conversion to float and its multiply run on other pipes, beside
# these. The least integer work is the larger of the integer pipe's share
# and half of all of it.
K4_INT_OPS, K4_ADD_OPS = 20 + 20 + 2, 20 + 5 + 2 + 2
K4_DRAW_OPS = max(K4_INT_OPS, (K4_INT_OPS + K4_ADD_OPS) / 2)
# Phases 27-29: tests/test_medium.py's glass (the material of MEDIA_GLASS
# in each family's demo) filled with each medium of MEDIA: (type, density,
# color, anisotropy); "scatter g0.4" is the demo of the main path, at
# MEDIA_DEPTH (test_medium.py's depth).
MEDIA_DEPTH = 6
MEDIA_GLASS = {"analytical": 1, "sdf": 0, "mesh": 1, "bigmesh": 1}
MEDIA = {
    "absorb": (1, 0.8, (0.9, 0.2, 0.1), 0.0),
    "emissive": (3, 0.5, (0.2, 0.8, 0.3), 0.0),
    "scatter g0": (2, 2.0, (1.0, 1.0, 1.0), 0.0),
    "scatter g0.4": (2, 0.8, (0.9, 0.2, 0.1), 0.4),
}
MEDIA_MAIN = "scatter g0.4"
# A pixel that took another branch differs by more than FLIP; a mesh hit
# whose two nearest triangles' t are within MEDIA_TIE of each other is a
# coplanar tie.
FLIP, MEDIA_TIE = 1e-3, 1e-6
# K1's MEDIA work, read from tracer.cuh as K1_OPS: per segment that enters
# its bounce inside a medium, the free flight's draw (threefry's ~86 integer
# operations at the float32 rate), its log and division (~20) and the
# segment's terms (~10); a scatter event skips the surface's disney_eval
# (~330) and disney_sample (~275) and runs hg_phase (~15) and sample_hg
# (~60: the inverse CDF, the basis, the rotation).
MEDIUM_SEGMENT_OPS = 86 + 20 + 10
SCATTER_SAVED_OPS = 330 + 275 - 15 - 60
# Phases 30-33, K2's MEDIA instantiation. The lit-medium case: the Scatter
# demo with the light (position, radius, emission) inside sphere 1 and
# shadow rays that stop at it, so that the scatter points' HG-phase NEE
# contributes (tests/test_torch_media_grad.py). Phase 31's fixture holds
# jax.grad of every float leaf for each case of MEDIA_GRAD_CASES and each
# of its MEDIA_GRAD_BANDS bands of rows (the whole gradient's rtol is taken
# of the bands' summed magnitudes where that is larger: a float32 sum
# rounds in proportion to its terms). Phase 32 recovers the Absorb demo's
# density and color from MEDIA_TRAIN_START.
MEDIA_GRAD_FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "grad_media_64x48_d6_k3.npz")
MEDIA_GRAD_BANDS = 4
MEDIA_GRAD_CASES = {"absorb": "absorb", "emissive": "emissive", "scatter": MEDIA_MAIN, "lit": MEDIA_MAIN}
LIT_LIGHT = ((1.1, 0.0, 0.0), 0.25, (3.0, 3.0, 3.0))
MEDIA_GEOMETRY = ("params.sphere", "params.plane", "lights.position", "lights.radius", "camera")
MEDIA_SELECT = ("medium.density", "medium.color")
MEDIA_TRAIN_START = (0.4, (0.5, 0.5, 0.5))
MEDIA_TRAIN_FAMILY_STEPS = 3
# K2's MEDIA work, read from tracer_adj.cuh as K2_OPS: per segment inside a
# medium, K1's MEDIUM_SEGMENT_OPS and the segment's adjoint (~30: the
# exponent's and the emission's products); a scatter event skips K1's
# SCATTER_SAVED_OPS and the adjoints of disney_eval (~1000) and
# disney_sample (~500), and runs hg_phase_adj (~25) and the phase NEE's
# scale and MIS adjoint (~35).
MEDIUM_SEGMENT_ADJ_OPS = 30
SCATTER_SAVED_ADJ_OPS = 1000 + 500 - 25 - 35
# Phase 34: K2 at this depth, past the 16 bounces the adjoint once held.
DEEP_DEPTH = 20


def image_diff(a, b) -> dict:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.abs(a - b)
    return dict(
        q999=float(np.quantile(d, 0.999)), mean=float(d.mean()), max=float(d.max()),
        finite=bool(np.isfinite(a).all() and np.isfinite(b).all()),
    )


def check_diff(label: str, d: dict) -> None:
    print(f"  {label}: q0.999={d['q999']:.3e} mean={d['mean']:.3e} max={d['max']:.3e} finite={d['finite']}")
    if not (d["finite"] and d["q999"] < Q_TOL and d["mean"] < MEAN_TOL):
        raise AssertionError(f"{label}: outside tolerance (q0.999 < {Q_TOL}, mean < {MEAN_TOL})")


def grad_diff(g, r) -> dict:
    g = np.asarray(g, np.float64).ravel()
    r = np.asarray(r, np.float64).ravel()
    if not (np.isfinite(g).all() and np.isfinite(r).all()):
        nan = float("nan")
        print(f"  not finite: kernel entries {np.flatnonzero(~np.isfinite(g)).tolist()}, "
              f"plain entries {np.flatnonzero(~np.isfinite(r)).tolist()}")
        return dict(max_abs=nan, max_rel=nan, big_rel=nan, finite=False)
    scale = np.abs(r).max()
    big = np.abs(r) > 1e-2 * scale
    return dict(
        max_abs=float(np.abs(g - r).max()), max_rel=float(np.abs(g - r).max() / scale),
        big_rel=float((np.abs(g - r)[big] / np.abs(r[big])).max()),
        finite=bool(np.isfinite(g).all() and np.isfinite(r).all()),
    )


def leaf_close(got, want, name) -> bool:
    """tests/test_torch_grad.py's fixture tolerances, the geometry's for the
    camera and every primitive (tests/test_torch_sdf.py's GEOMETRY)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if name.startswith(("params.sphere", "params.box", "params.torus", "params.plane", "params.smooth_k",
                        "params.vertices", "camera")):
        atol, rtol = 1e-7, 1e-2
    else:
        atol, rtol = 1e-8, 5e-3
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def small_sdf_close(got, want, name) -> bool:
    """tests/golden_torch/grad_sdf_32x16_d2_k3.npz's tolerance
    (tests/test_torch_sdf.py): rtol 5e-3, atol 1e-7."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want) <= 1e-7 + 5e-3 * np.abs(want)))


def bound_of(f32_ops: float, f64_ops: float, nbytes: int, i32_ops: float = 0) -> tuple[float, str]:
    """The least time the card could take, ms: the larger of the operations
    over their type's peak and the bytes over the memory rate."""
    t_ops = f32_ops / PEAK_F32 + f64_ops / PEAK_F64 + i32_ops / PEAK_I32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound(segments: int, pixels: int, nbytes: int, ops: dict) -> tuple[float, str]:
    """bound_of() for `segments` ray segments of `ops` each and the camera
    rays of `pixels`."""
    return bound_of(segments * ops["f32"], segments * ops["f64"] + pixels * CAMERA_F64_OPS, nbytes)


# render_frame_megakernel's counts of K1 launches and K2 calls (and K2's
# record and adjoint kernel launches, one each a chunk), then K3's
# (measure_occupancy_megakernel's, prefixed occupancy_) and K4's
K1_K2_COUNTERS = ("launches", "bwd_launches", "sdf_launches", "sdf_bwd_launches", "mesh_launches",
                  "mesh_bwd_launches", "bigmesh_launches", "media_launches", "media_bwd_launches", "record_launches",
                  "adjoint_launches")
K3_COUNTERS = ("launches", "sdf_launches", "mesh_launches", "bigmesh_launches", "media_launches")
COUNTERS = K1_K2_COUNTERS + tuple(f"occupancy_{name}" for name in K3_COUNTERS) + ("stream_launches",)


def counters(mk) -> dict:
    """Each name of COUNTERS -> (the wrapper that counts, its attribute)."""
    out = {name: (mk.render_frame_megakernel, name) for name in K1_K2_COUNTERS}
    out.update({f"occupancy_{name}": (mk.measure_occupancy_megakernel, name) for name in K3_COUNTERS})
    out["stream_launches"] = (mk.debug_uniform_stream, "launches")
    return out


def reset_counts(mk) -> None:
    """Every launch count of the megakernels to 0."""
    for fn, name in counters(mk).values():
        setattr(fn, name, 0)


def read_counts(mk) -> dict:
    return {key: getattr(fn, name) for key, (fn, name) in counters(mk).items()}


def expect_counts(**nonzero) -> dict:
    """Every launch count: those given, the others 0; record_launches and
    adjoint_launches, unless given, as many as bwd_launches (each K2 call of
    these phases is one chunk: one record kernel and one adjoint kernel
    launch)."""
    nonzero.setdefault("record_launches", nonzero.get("bwd_launches", 0))
    nonzero.setdefault("adjoint_launches", nonzero["record_launches"])
    return {name: nonzero.get(name, 0) for name in COUNTERS}


def mesh_phases(torch, mk, cli, rng, cuda_ms, dev, card: str, family: str, first: int) -> tuple[dict, tuple]:
    """Phases `first` and `first + 1` for the mesh (K7) or the big mesh (K8)
    backend of K1: the kernel against its plain version and the committed
    JAX render, a CUDA scene with grad refused, then the render CLI's main
    path and the times. Returns the kernel's row of the kernels line and
    its work at 1080p, (float32 operations, float64 ones, bytes)."""
    from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
    from pathtracer_tpu_torch.models import families
    from pathtracer_tpu_torch.ops import megakernel_bigmesh
    from pathtracer_tpu_torch.tools.work import count_mesh_work

    what = {"mesh": "the mesh backend (K7)", "bigmesh": "the big mesh backend (K8)"}[family]
    print(f"== {first}. K1 with {what} vs its plain version on the card (depth 4)")
    scene = families.make_family_scene(family, device=dev)
    err = 0.0
    seeds = {"mesh": 61, "bigmesh": 71}[family]
    for i, (w, h, spp, quirks) in enumerate(((320, 240, 1, VERBATIM), (320, 240, 2, VERBATIM),
                                             (320, 240, 1, FIXED), (MAIN_W, MAIN_H, 1, VERBATIM))):
        key = rng.prng_key(seeds + i)
        img = mk.render_frame_megakernel(scene, key, w, h, spp, quirks)
        ref = mk.render_frame_reference(scene, key, w, h, spp, quirks)
        torch.cuda.synchronize()
        d = image_diff(img.cpu(), ref.cpu())
        err = max(err, d["max"])
        check_diff(f"{w}x{h} spp{spp} {'VERBATIM' if quirks == VERBATIM else 'FIXED'}", d)
        del img, ref
    img = mk.render_frame_megakernel(scene, rng.prng_key(3), 64, 48)
    check_diff("vs JAX (64x48, depth 4, PRNGKey(3))", image_diff(img.cpu(), np.load(MESH_FIXTURES[family])))
    if family == "bigmesh":  # K2 takes no big mesh
        grad_scene = families.make_family_scene(family, device=dev)
        grad_scene.params.vertices.x.requires_grad_(True)
        reset_counts(mk)
        try:
            mk.render_frame_megakernel(grad_scene, rng.prng_key(0), 16, 8)
        except NotImplementedError as e:
            print(f"  a CUDA {family} scene with grad raises: {e}")
        else:
            raise AssertionError(f"a CUDA {family} scene with grad rendered without a backward kernel")
        if read_counts(mk) != expect_counts():
            raise AssertionError(f"the refused {family} gradient launched a kernel: {read_counts(mk)}")

    print(f"== {first + 1}. {family} main path: CLI --scene {family}, {MAIN_W}x{MAIN_H}, depth {MAIN_DEPTH}, "
          f"{MAIN_FRAMES} frames")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, f"{family}.png")
        cfg, _ = cli.parse_args([
            "--scene", family, "--device", "cuda", "--width", str(MAIN_W), "--height", str(MAIN_H),
            "--depth", str(MAIN_DEPTH), "--spp", "1", "--frames", str(MAIN_FRAMES), "-o", png,
        ])
        reset_counts(mk)
        builds = megakernel_bigmesh.bigmesh_tables.builds
        buf = cli.render(cfg, png, log=lambda s: print("  " + s))
        counts = read_counts(mk)
        builds = megakernel_bigmesh.bigmesh_tables.builds - builds
        pixels = buf.pixels.cpu().numpy()
        if not os.path.getsize(png) > 0:
            raise AssertionError("no PNG written")
    print(f"  launches {counts}  mean rgb={pixels[..., :3].mean():.4f}"
          + (f"; the big mesh's tables built {builds} time(s) for {MAIN_FRAMES} frames" if family == "bigmesh" else ""))
    if family == "bigmesh" and builds != 1:
        raise AssertionError(f"the big mesh's tables were built {builds} times for one scene's {MAIN_FRAMES} frames")
    want = {name: 0 for name in COUNTERS}
    want.update(launches=MAIN_FRAMES, **{f"{family}_launches": MAIN_FRAMES})
    if counts != want:
        raise AssertionError(f"expected one launch of K1 with {what} per frame and nothing else, got {counts}")
    if pixels.shape != (MAIN_H, MAIN_W, 4) or not np.isfinite(pixels).all():
        raise AssertionError(f"{family} main-path image is not finite or has the wrong shape")
    if not pixels[..., :3].max() > 0.05:
        raise AssertionError(f"{family} main-path image is black")
    main = families.make_family_scene(family, recursion_depth=MAIN_DEPTH, device=dev)
    key = rng.prng_key(5)
    ms = cuda_ms(lambda: mk.render_frame_megakernel(main, key, MAIN_W, MAIN_H), 20)
    prepared = mk.prepare_launch(main, key, MAIN_W, MAIN_H, 1, VERBATIM)
    launch_ms = cuda_ms(lambda: mk.launch(prepared), 20)
    plain_ms = cuda_ms(lambda: mk.render_frame_reference(main, key, MAIN_W, MAIN_H), 1, warmup=0)
    tests = count_mesh_work(main, key, MAIN_W, MAIN_H)
    segments = tests["segments"]
    pix = MAIN_W * MAIN_H
    nbytes = prepared.sv.shape[1] * 4 + 16 + pix * 16 + sum(t.numel() * t.element_size() for t in prepared.extras)
    if family == "mesh":
        test_ops = (tests["closest_tests"] + tests["shadow_tests"]) * MESH_TRI_OPS
        walk = (f"{tests['closest_tests']} triangle tests in closest hits ({tests['closest_tests'] / segments:.2f} "
                f"per segment), {tests['shadow_tests']} in shadow rays, {MESH_TRI_OPS} operations a test on the "
                "staged table")
    else:
        pairs = {w: tests[f"{w}_pairs"] for w in ("closest", "shadow")}
        test_ops = sum(tests[f"{w}_pairs"] * BIGMESH_DET_OPS + tests[f"{w}_det_ok"] * BIGMESH_U_OPS
                       + tests[f"{w}_u_ok"] * BIGMESH_REST_OPS + tests[f"{w}_boxes"] * BIGMESH_SLAB_OPS
                       for w in ("closest", "shadow"))
        warp = {w: tests[f"{w}_warp_pairs"] for w in ("closest", "shadow")}
        walk = (f"pairs {pairs['closest']} in closest hits ({pairs['closest'] / segments:.2f} per segment; "
                f"{tests['closest_det_ok']} past the determinant's guard, {tests['closest_u_ok']} past u's), "
                f"{pairs['shadow']} in shadow rays ({tests['shadow_det_ok']}, {tests['shadow_u_ok']}); box tests "
                f"{tests['closest_boxes']} and {tests['shadow_boxes']}; the warps run the union of their lanes' "
                f"chunks: {warp['closest']} and {warp['shadow']} lane-pairs ({warp['closest'] / pairs['closest']:.3f}x "
                f"and {warp['shadow'] / pairs['shadow']:.3f}x the lanes' own; beside the bound, not in it)")
    work = (segments * MESH_SEGMENT_OPS["f32"] + test_ops, segments * MESH_SEGMENT_OPS["f64"] + pix * CAMERA_F64_OPS,
            nbytes)
    bound_ms, bound_by = bound_of(*work)
    print(f"  wrapper {ms:.3f} ms/frame (kernel launch alone {launch_ms:.3f} ms; the wrapper's own "
          f"{ms - launch_ms:.3f} ms), plain {plain_ms:.3f} ms/frame ({card})")
    print(f"  ray segments {segments} ({segments / pix:.3f} per pixel); ray segments/s: kernel "
          f"{segments / ms * 1e3:.4e}, plain {segments / plain_ms * 1e3:.4e} ({card})")
    print(f"  shadow rays cast {tests['shadow_rays']} ({tests['shadow_rays'] / segments:.3f} per segment); {walk}; "
          f"bound {bound_ms:.4f} ms ({bound_by}) ({card})")
    return dict(
        name=f"megakernel_fwd_{family}", route="cuda", source=f"pathtracer_tpu_torch/csrc/{family}.cuh",
        replaces={"mesh": "pathtracer_tpu/ops/megakernel_mesh.py:95",
                  "bigmesh": "pathtracer_tpu/ops/megakernel_bigmesh.py:158"}[family],
        launches=counts[f"{family}_launches"], max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
    ), work


def mesh_backward_phases(torch, mk, inverse, rng, cuda_ms, dev, card: str, total_bytes: int, trainer_pieces,
                         other) -> dict:
    """Phases 21-24, K2 with the mesh backend: against its plain version
    and the JAX gradient, the mesh trainer, the times and, with `other`, the
    analytical and SDF K2 of another tree in turns. Returns K2-mesh's row of
    the kernels line."""
    from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
    from pathtracer_tpu_torch.models import families, mesh
    from pathtracer_tpu_torch.ops import _build
    from pathtracer_tpu_torch.tools.work import count_mesh_work

    print("== 21. K2 with the mesh backend (K7's adjoint) vs its plain version on the card (depth 4)")
    scene = mesh.make_scene(device=dev)
    err, peak_320 = check_backward(torch, mk, rng, dev, total_bytes, [
        (scene, 320, 240, 1, VERBATIM, 81, ""), (scene, 320, 240, 2, VERBATIM, 82, ""),
        (scene, 320, 240, 1, FIXED, 83, ""), (scene, MAIN_W, MAIN_H, 1, VERBATIM, 84, ""),
    ], moved=mesh_near_edge)
    for label, sc in (("mesh demo", scene), ("mesh glass Scatter (MEDIA)",
                                             media_scene(torch, families, "mesh", dev, MEDIA_MAIN))):
        check_record_paths(torch, mk, mk.prepare_launch(sc, rng.prng_key(85), MAIN_W, MAIN_H, 1, VERBATIM), label)

    print("== 22. K2-mesh vs the JAX gradient fixture, through the autograd Function and pack_mesh_scene")
    with np.load(MESH_GRAD_FIXTURE) as data:
        names = sorted(data.files)
    grad_scene = mesh.make_scene(device=dev)
    leaves = dict(inverse.named_leaves(grad_scene))
    for name in names:
        leaves[name].requires_grad_(True)
    reset_counts(mk)
    img = mk.render_frame_megakernel(grad_scene, rng.prng_key(3), 64, 48)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in names], allow_unused=True)
    counts = read_counts(mk)
    print(f"  {os.path.basename(MESH_GRAD_FIXTURE)} (64x48, depth 4): launches {counts}")
    if counts != expect_counts(launches=1, mesh_launches=1, bwd_launches=1, mesh_bwd_launches=1):
        raise AssertionError(f"expected 1 K1 and 1 K2 launch with the mesh backend, got {counts}")
    check_leaf_grads({n: np.zeros(tuple(leaves[n].shape)) if g is None else g.cpu().numpy()
                      for n, g in zip(names, grads)}, MESH_GRAD_FIXTURE, leaf_close)

    print(f"== 23. mesh trainer: inverse_render, {TRAIN_W}x{TRAIN_H}, depth {MAIN_DEPTH}, {TRAIN_STEPS} steps")
    counting_render, real_render, calls = trainer_pieces
    true_scene = mesh.make_scene(recursion_depth=MAIN_DEPTH, device=dev)
    start = inverse.mesh_start_scene(true_scene)
    calls.clear()
    reset_counts(mk)
    with torch.no_grad():
        target = mk.render_frame_megakernel(true_scene, rng.prng_key(17), TRAIN_W, TRAIN_H)
    inverse.render_frame_megakernel = counting_render
    try:
        out = inverse.inverse_render(start, target, rng.prng_key(3), inverse.MESH_SELECT, TRAIN_W, TRAIN_H,
                                     steps=TRAIN_STEPS, lr=3e-2, spp=1, kernel="megakernel")
        counts = read_counts(mk)
    finally:
        inverse.render_frame_megakernel = real_render
    losses = out.losses.cpu().numpy()
    apex = float(out.scene.params.vertices.y[inverse.MESH_APEX])
    emission = [float(c) for c in out.scene.lights.unpack().emission]
    print(f"  launches {counts}; losses {losses[0]:.6e} -> {losses[-1]:.6e}: {np.array2string(losses, precision=6)}")
    print(f"  apex y: true 0.9000 start {inverse.MESH_APEX_Y:.4f} recovered {apex:.4f}; emission: true 3.0 start "
          f"{3.0 * inverse.MESH_DIM:.4f} recovered {', '.join(f'{e:.4f}' for e in emission)}")
    step_starts = [c[:2] for c in calls if c[2]]
    want = expect_counts(launches=1 + 2 * TRAIN_STEPS, mesh_launches=1 + 2 * TRAIN_STEPS, bwd_launches=TRAIN_STEPS,
                         mesh_bwd_launches=TRAIN_STEPS)
    if counts != want or step_starts != [(1 + 2 * i, i) for i in range(TRAIN_STEPS)]:
        raise AssertionError(f"a mesh step is not 2 K1-mesh + 1 K2-mesh launches: {calls} -> {counts}")
    if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"mesh trainer losses not finite or not falling: {losses}")
    train_bwd_launches, train_stages = counts["mesh_bwd_launches"], stage_counts(counts)
    small_true = mesh.make_scene(recursion_depth=MAIN_DEPTH, device=dev)
    with torch.no_grad():
        small_target = mk.render_frame_megakernel(small_true, rng.prng_key(17), 64, 48)
    runs = {kern: inverse.inverse_render(inverse.mesh_start_scene(small_true), small_target, rng.prng_key(3),
                                         inverse.MESH_SELECT, 64, 48, steps=3, lr=3e-2, spp=1, kernel=kern)
            for kern in inverse.KERNELS}
    got, want = runs["megakernel"], runs["eager"]
    loss_rel = np.abs(got.losses.cpu().numpy() / want.losses.cpu().numpy() - 1.0).max()
    leaves_got, _, leaf_names = inverse.select_leaves(got.scene, inverse.MESH_SELECT)
    leaves_want, _, _ = inverse.select_leaves(want.scene, inverse.MESH_SELECT)
    leaf_rel = {n: float(((a - b).abs() / b.abs().clamp_min(1e-6)).max().detach())
                for n, a, b in zip(leaf_names, leaves_got, leaves_want)}
    print(f"  64x48 losses: kernels {got.losses.cpu().numpy()}, eager {want.losses.cpu().numpy()}; max rel "
          f"{loss_rel:.3e} (tolerance {SDF_TRAIN_LOSS_RTOL})")
    print("  leaves after step 3, max rel: " + ", ".join(f"{n} {x:.3e}" for n, x in leaf_rel.items())
          + f" (tolerance {SDF_TRAIN_LEAF_RTOL})")
    if not (loss_rel <= SDF_TRAIN_LOSS_RTOL and max(leaf_rel.values()) <= SDF_TRAIN_LEAF_RTOL):
        raise AssertionError("the mesh kernel path's losses or leaves differ from the eager path's")

    print(f"== 24. times: one mesh training step at {MAIN_W}x{MAIN_H}, depth {MAIN_DEPTH}, spp 1")
    key, step_key = rng.prng_key(5), rng.prng_key(7)

    def step(kern):
        render = inverse.make_renderer(kern, MAIN_W, MAIN_H, 1, VERBATIM)
        with torch.no_grad():
            target = render(true_scene, rng.prng_key(8))
        train, rebuild, _ = inverse.select_leaves(start, inverse.MESH_SELECT)
        opt = inverse.make_adam(train, 3e-2)
        return lambda: inverse.paired_step(train, rebuild, None, opt, render, target, step_key)

    step_ms = cuda_ms(step("megakernel"), 10, warmup=2)
    k = mk.prepare_launch(true_scene, key, MAIN_W, MAIN_H, 1, VERBATIM)
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((MAIN_H, MAIN_W, 4)).astype(np.float32)).to(dev)
    bwd_ms = cuda_ms(lambda: mk.launch_backward(k, ct), 10)
    split = k2_stages(mk, _build, cuda_ms, k, ct, card, f"K2-mesh at {MAIN_W}x{MAIN_H}")
    need = peak_320 * (MAIN_W * MAIN_H) / (320 * 240)
    if need > 0.6 * total_bytes:
        raise AssertionError(f"the plain mesh gradient needs ~{need / 2**30:.1f} GiB at {MAIN_W}x{MAIN_H}")
    plain_bwd_ms = cuda_ms(lambda: mk.render_grad_reference(k.sv, true_scene, key, ct, MAIN_W, MAIN_H), 1, warmup=0)
    plain_step_ms = cuda_ms(step("eager"), 1, warmup=0)
    work = count_mesh_work(true_scene, key, MAIN_W, MAIN_H)
    segments, pix = work["segments"], MAIN_W * MAIN_H
    tests = work["closest_tests"] + work["shadow_tests"]
    n_sv = k.sv.shape[1]
    bound_ms, bound_by = bound_of(
        segments * (MESH_SEGMENT_OPS["f32"] + K2_ADJ_OPS["f32"] - ANALYTICAL_HIT_ADJ_F32 + MESH_HIT_ADJ_OPS)
        + tests * MESH_TRI_OPS,
        segments * MESH_SEGMENT_OPS["f64"] + pix * CAMERA_F64_OPS,
        n_sv * 8 + 16 + pix * 16 + k.extras[0].numel() * 4)
    print(f"  mesh training step: kernels {step_ms:.3f} ms, plain {plain_step_ms:.3f} ms ({card})")
    print(f"  K2-mesh launch alone {bwd_ms:.3f} ms, plain gradient (eager forward + autograd) {plain_bwd_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}; {segments} segments, {tests} triangle tests in K1's walk) ({card})")
    if other:
        from pathtracer_tpu_torch.tools import k2_pair

        check_pairing(k2_pair.pair([Path(other)], ("analytical", "sdf"), log=lambda s: print("  " + s)))
    else:
        print("  analytical and SDF K2 against another tree's: not run (no --other DIR given)")
    return dict(
        name="megakernel_bwd_mesh", route="cuda", source="pathtracer_tpu_torch/csrc/mesh_adj.cuh",
        replaces="pathtracer_tpu/ops/megakernel.py:1771 + pathtracer_tpu/ops/megakernel_mesh.py:95",
        launches=train_bwd_launches, max_abs_err=err, ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, stages=stage_rows(split, train_stages),
    )


def fmt_fractions(x) -> str:
    return "[" + ", ".join(f"{float(v):.5f}" for v in x) + "]"


def occupancy_phase(torch, mk, cli, rng, cuda_ms, dev, card: str, k1_work: dict) -> list[dict]:
    """Phase 25, K3 on each backend: against its plain version
    (tracer.bounces_entered) and its frame against K1's at 320x240 and
    1080p, the render CLI's --occupancy at 1080p, the K3 and K1 launches in
    turns and the divergence of the 1080p frame. `k1_work` holds each
    backend's K1 work at 1080p (float32 operations, float64 ones, bytes),
    K3's but for its counts' bytes. Returns K3's rows of the kernels line."""
    from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM, bounces_entered
    from pathtracer_tpu_torch.models import families
    from pathtracer_tpu_torch.tools.k1_pair import in_turns

    print("== 25. K3 (K1 plus the bounces each path entered alive) on each backend vs its plain version (depth 4)")
    rows = []
    for i, family in enumerate(families.FAMILIES):
        scene = families.make_family_scene(family, device=dev)
        err = 0.0
        for j, (w, h, spp, quirks) in enumerate(((320, 240, 1, VERBATIM), (320, 240, 2, VERBATIM),
                                                 (320, 240, 1, FIXED), (MAIN_W, MAIN_H, 1, VERBATIM))):
            key = rng.prng_key(111 + 10 * i + j)
            k = mk.prepare_launch(scene, key, w, h, spp, quirks)
            entered = torch.empty((spp, h, w), dtype=torch.int32, device=dev)
            frame = mk.launch(k, entered).clone()
            same_frame = bool(torch.equal(frame, mk.launch(k)))
            refs = []  # the plain run, timed: the 1080p one gives K3's plain_ms
            plain_ms = cuda_ms(lambda: refs.append(bounces_entered(scene, key, w, h, spp, quirks)), 1, warmup=0)
            ref = refs.pop()
            same = float((entered == ref).double().mean())
            got, want = (mk.occupancy_stats(e, scene.recursion_depth) for e in (entered, ref))
            d = float((got["alive_fraction"] - want["alive_fraction"]).abs().max())
            err = max(err, d)
            print(f"  {family} {w}x{h} spp{spp} {'VERBATIM' if quirks == VERBATIM else 'FIXED'}: frame bit-equal to "
                  f"K1's {same_frame}; counts equal on {same:.6f} of lanes (max |diff| "
                  f"{int((entered - ref).abs().max())}); alive fractions {fmt_fractions(got['alive_fraction'])}, plain "
                  f"{fmt_fractions(want['alive_fraction'])}, max |diff| {d:.2e}")
            if not (same_frame and same >= OCC_SAME_MIN and d <= OCC_FRAC_TOL):
                raise AssertionError(f"K3 {family} {w}x{h} spp{spp}: outside tolerance (frame bit-equal to K1's, "
                                     f"counts equal on {OCC_SAME_MIN} of lanes, fractions within {OCC_FRAC_TOL})")
            del k, entered, frame, ref

        with tempfile.TemporaryDirectory() as tmp:
            png = os.path.join(tmp, f"{family}.png")
            cfg, _ = cli.parse_args([
                "--scene", family, "--device", "cuda", "--width", str(MAIN_W), "--height", str(MAIN_H),
                "--depth", str(MAIN_DEPTH), "--spp", "1", "--frames", str(OCC_FRAMES), "--occupancy", "-o", png,
            ])
            reset_counts(mk)
            buf = cli.render(cfg, png, log=lambda s: print("  " + s))
            counts = read_counts(mk)
            pixels = buf.pixels.cpu().numpy()
        on = {} if family == "analytical" else {f"{family}_launches": OCC_FRAMES, f"occupancy_{family}_launches": 1}
        print(f"  CLI --scene {family} --occupancy, {OCC_FRAMES} frames: launches {counts}")
        if counts != expect_counts(launches=OCC_FRAMES, occupancy_launches=1, **on):
            raise AssertionError(f"--occupancy: expected one K3 launch and one K1 launch a frame with the {family} "
                                 f"backend and nothing else, got {counts}")
        if pixels.shape != (MAIN_H, MAIN_W, 4) or not np.isfinite(pixels).all() or not pixels[..., :3].max() > 0.05:
            raise AssertionError(f"--occupancy {family}: the image is not finite, black or of the wrong shape")

        main = families.make_family_scene(family, recursion_depth=MAIN_DEPTH, device=dev)
        key = rng.prng_key(5)
        k1 = mk.prepare_launch(main, key, MAIN_W, MAIN_H, 1, VERBATIM)
        k3 = k1._replace(out=torch.empty_like(k1.out))
        entered = torch.empty((1, MAIN_H, MAIN_W), dtype=torch.int32, device=dev)
        pair = in_turns({"other": lambda: mk.launch(k1), "this": lambda: mk.launch(k3, entered)},
                        f"K3 {family} launch (this) against K1's (other) at {MAIN_W}x{MAIN_H}, depth {MAIN_DEPTH}, "
                        "spp 1", card, log=lambda s: print("  " + s))
        if not pair["bit_equal"]:
            raise AssertionError(f"K3 {family}: its 1080p frame is not K1's")
        wrapper_ms = cuda_ms(lambda: mk.measure_occupancy_megakernel(main, key, MAIN_W, MAIN_H), 10)
        tile = mk.forward_layout(k1)["tile_paths"]
        st = mk.occupancy_stats(entered, MAIN_DEPTH, tile)
        print(f"  {family} 1080p frame, entering bounces 0-{MAIN_DEPTH - 1}: lanes alive "
              f"{fmt_fractions(st['alive_fraction'])} (wasted {st['wasted_fraction']:.5f}); blocks with a live "
              f"lane {fmt_fractions(st['block_alive_fraction'])}; warps with a live lane "
              f"{fmt_fractions(st['warp_alive_fraction'])}, live lanes per live warp "
              f"{fmt_fractions(st['warp_lanes'])}; idle lanes of live warps {st['warp_wasted_fraction']:.5f} "
              "(per-thread loop)" + (f", {st['compacted_wasted_fraction']:.5f} (the compacted loop's {tile}-path "
                                     "tiles)" if tile else "; the backend runs the per-thread loop"))
        f32, f64, nbytes = k1_work[family]
        bound_ms, bound_by = bound_of(f32, f64, nbytes + 4 * MAIN_W * MAIN_H)
        print(f"  K3 {family}: launch {pair['this_ms']:.4f} ms, K1's {pair['other_ms']:.4f} ms in turns "
              f"({pair['ratio']:.4f}x); wrapper (launch, reductions, host reads) {wrapper_ms:.4f} ms; plain "
              f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}) ({card})")
        launches = counts["occupancy_launches" if family == "analytical" else f"occupancy_{family}_launches"]
        rows.append(dict(
            name="megakernel_fwd_occupancy" + ("" if family == "analytical" else f"_{family}"), route="cuda",
            source="pathtracer_tpu_torch/csrc/" + {"sdf": "megakernel_sdf.cu", "mesh": "megakernel_mesh.cu"}.get(
                family, "megakernel_fwd.cu"),
            replaces="pathtracer_tpu/ops/megakernel.py:1644" + {
                "analytical": "", "sdf": " + pathtracer_tpu/ops/megakernel_sdf.py:172",
                "mesh": " + pathtracer_tpu/ops/megakernel_mesh.py:95",
                "bigmesh": " + pathtracer_tpu/ops/megakernel_bigmesh.py:158"}[family],
            launches=launches, max_abs_err=err, ms=pair["this_ms"], plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None,
        ))
        del k1, k3, entered
        torch.cuda.empty_cache()
    return rows


def uniform_stream_phase(torch, mk, cuda_ms, dev, card: str) -> dict:
    """Phase 26, K4: bit-equal to its plain version at the 1080p size, the
    stream's statistics there and through tools/validate_rng (its main
    path: two launches), its time and bound. Returns its kernels row."""
    from pathtracer_tpu_torch.tools import validate_rng

    shape = (STREAM_TILES, STREAM_DRAWS, STREAM_ROWS)
    print(f"== 26. K4, the in-kernel uniform stream, vs its plain version on the card ({STREAM_TILES} tiles x "
          f"{STREAM_DRAWS} draws x {STREAM_ROWS} x 128 lanes)")
    got = mk.debug_uniform_stream(STREAM_SEED, *shape, device=dev)
    ref = mk.debug_uniform_stream_reference(STREAM_SEED, *shape, device=dev)
    equal = bool(torch.equal(got, ref))
    err = float((got - ref).abs().max())
    del ref
    result = {"stream": validate_rng.stream_stats(got),
              "independence": validate_rng.independence(got, mk.debug_uniform_stream(STREAM_SEED + 1, *shape,
                                                                                         device=dev))}
    print(f"  bit-equal {equal} (max |diff| {err:.3e}); {json.dumps(result)}")
    if not (equal and validate_rng.passes(result)):
        raise AssertionError("K4: not its plain version's stream, or the stream fails the validation's thresholds")
    reset_counts(mk)
    rc = validate_rng.main(["--device", "cuda"])
    counts = read_counts(mk)
    if rc != 0 or counts != expect_counts(stream_launches=2):
        raise AssertionError(f"tools/validate_rng: exit {rc}, launches {counts} (two K4 launches expected)")
    ms = cuda_ms(lambda: mk.debug_uniform_stream(STREAM_SEED, *shape, device=dev), 20)
    plain_ms = cuda_ms(lambda: mk.debug_uniform_stream_reference(STREAM_SEED, *shape, device=dev), 2)
    draws = got.numel()
    bound_ms, bound_by = bound_of(0, 0, draws * 4, i32_ops=draws * K4_DRAW_OPS)
    print(f"  K4 {ms:.4f} ms a launch ({draws * 4 / ms / 1e6:.1f} GB/s written), plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {K4_INT_OPS} operations a draw only the integer pipe runs, "
          f"{K4_ADD_OPS} more it shares with the float pipe; the bytes alone "
          f"{draws * 4 / PEAK_BYTES * 1e3:.4f} ms); {bound_ms / ms:.3f} of the bound's rate ({card})")
    return dict(
        name="uniform_stream", route="cuda", source="pathtracer_tpu_torch/csrc/uniform_stream.cu",
        replaces="pathtracer_tpu/ops/megakernel.py:1871", launches=counts["stream_launches"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )


def media_scene(torch, families, family: str, dev, name: str, depth: int = MEDIA_DEPTH, lit: bool = False):
    """The family's demo with its MEDIA_GLASS material made glass
    (tests/test_medium.py's: spec_trans 1, metallic 0, roughness 0.05, ior
    1.5) and filled with the medium `name` of MEDIA; with `lit` (the
    analytical scene) the light is LIT_LIGHT, inside the medium, and shadow
    rays stop at it."""
    from pathtracer_tpu_torch.models.light import spherical_light

    med_type, density, color, g = MEDIA[name]
    extra = dict(respect_max_dist=True, lights=spherical_light(*LIT_LIGHT, device=dev)) if lit else {}
    scene = families.make_family_scene(family, recursion_depth=depth, device=dev, **extra)
    m, i = scene.params.materials, MEDIA_GLASS[family]
    with torch.no_grad():
        m.spec_trans[i], m.metallic[i], m.roughness[i], m.ior[i] = 1.0, 0.0, 0.05, 1.5
        m.medium.medium_type[i], m.medium.density[i], m.medium.anisotropy[i] = med_type, density, g
        m.medium.color.x[i], m.medium.color.y[i], m.medium.color.z[i] = color
    return scene


def coplanar_ties(torch, scene, key, w, h, spp, quirks):
    """[h, w] bool on the host: the mesh pixels whose plain path meets two
    coplanar triangles at once (none off the small mesh)."""
    from pathtracer_tpu_torch.models import families
    from pathtracer_tpu_torch.ops.megakernel_mesh import hit_ties

    if families.family_of(scene) != "mesh":
        return torch.zeros((h, w), dtype=torch.bool)
    return (hit_ties(scene, key, w, h, spp, quirks) < MEDIA_TIE).any(1).any(0).reshape(h, w).cpu()


def media_phases(torch, mk, _build, rng, cuda_ms, dev, card: str, other) -> list[dict]:
    """Phases 27-29: K1's and K3's MEDIA instantiations against their plain
    versions and the JAX render, the media main path with its times and
    bound, the refused gradient, with `other` K1 and K3 of another tree in
    turns on each backend's demo and the media demo, and K3 MEDIA. Returns
    the two rows of the kernels line."""
    from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM, accumulate, bounces_entered
    from pathtracer_tpu_torch.models import families
    from pathtracer_tpu_torch.tools import k1_pair
    from pathtracer_tpu_torch.tools.work import count_media_work
    from pathtracer_tpu_torch.utils.buffer import ColorBuffer, new_buffer
    from pathtracer_tpu_torch.utils.image import save_render

    print(f"== 27. K1's media instantiation vs its plain version on the card (depth {MEDIA_DEPTH})")
    for key_, line in sorted(k1_pair.forward_instantiations(_build.CSRC).items()):
        if key_[2]:
            print(f"  {key_[0]} {'K3' if key_[1] else 'K1'} MEDIA: {line}")
    theirs = k1_pair.forward_instantiations(k1_pair.tree_csrc(other)) if other else {}
    for family in ("analytical", "mesh"):  # the backends of K1's tiles of 1536 paths
        scene = media_scene(torch, families, family, dev, MEDIA_MAIN)
        demo = mk.prepare_launch(scene, rng.prng_key(0), MAIN_W, MAIN_H, 1, VERBATIM)
        for media in (False, True):
            k = demo._replace(media=media, sv=mk.BACKENDS[family].pack(scene, MAIN_W, MAIN_H, media).contiguous())
            res = mk.forward_resources(k)
            label = f"K1{' MEDIA' if media else ''} {family}"
            print(f"  {label}: this tree {res['registers']} registers, {res['stack_bytes']} B stack, "
                  f"{res['shared_bytes']} B shared memory a block of {mk.forward_layout(k)['tile_paths']} paths, "
                  f"{res['blocks_per_sm']} block(s) an SM"
                  + (f"; the other tree: {theirs.get((family.capitalize(), False, media))}" if other else ""))
    err = 0.0
    cases = [("analytical", name, w, h, spp, quirks) for name in MEDIA
             for w, h, spp, quirks in ((320, 240, 1, VERBATIM), (320, 240, 2, VERBATIM), (320, 240, 1, FIXED),
                                       (MAIN_W, MAIN_H, 1, VERBATIM))]
    cases += [(family, MEDIA_MAIN, 320, 240, 1, VERBATIM) for family in ("sdf", "mesh", "bigmesh")]
    cases += [("analytical", MEDIA_MAIN, 1100, 3, 2, FIXED)]  # the last tile of paths part empty
    for i, (family, name, w, h, spp, quirks) in enumerate(cases):
        scene = media_scene(torch, families, family, dev, name)
        key = rng.prng_key(201 + i)
        reset_counts(mk)
        img = mk.render_frame_megakernel(scene, key, w, h, spp, quirks).cpu()
        counts = read_counts(mk)
        on = {} if family == "analytical" else {f"{family}_launches": 1}
        if counts != expect_counts(launches=1, media_launches=1, **on):
            raise AssertionError(f"{family} {name}: expected one launch of K1's MEDIA instantiation, got {counts}")
        ref = mk.render_frame_reference(scene, key, w, h, spp, quirks).cpu()
        ties = coplanar_ties(torch, scene, key, w, h, spp, quirks)
        flips = (img - ref).abs()[..., :3].amax(-1) > FLIP
        d = image_diff(img[~ties], ref[~ties])
        if family == "analytical":
            err = max(err, d["max"])
        label = f"{family} {name} {w}x{h} spp{spp} {'VERBATIM' if quirks == VERBATIM else 'FIXED'}"
        print(f"  {label}: {int((flips & ~ties).sum())} pixels flipped (|diff| > {FLIP})"
              + (f"; {int(ties.sum())} coplanar-tie pixels left out ({int((flips & ties).sum())} flipped)"
                 if family == "mesh" else ""))
        check_diff(label, d)
        del img, ref
    scene = media_scene(torch, families, "analytical", dev, MEDIA_MAIN)
    img = mk.render_frame_megakernel(scene, rng.prng_key(3), 64, 48)
    check_diff("vs JAX (Scatter g 0.4, 64x48, depth 6, PRNGKey(3))", image_diff(img.cpu(), np.load(MEDIA_FIXTURE)))

    print(f"== 28. media main path: the Scatter demo, {MAIN_W}x{MAIN_H}, depth {MEDIA_DEPTH}, {MAIN_FRAMES} "
          "progressive frames")
    main = media_scene(torch, families, "analytical", dev, MEDIA_MAIN)
    buf = new_buffer(MAIN_W, MAIN_H, torch.float32, dev)
    key = rng.prng_key(0)
    reset_counts(mk)
    for f in range(MAIN_FRAMES):
        key, sub = rng.split(key)
        buf = ColorBuffer(*accumulate(buf.pixels, mk.render_frame_megakernel(main, sub, MAIN_W, MAIN_H), buf.frames))
        counts = read_counts(mk)
        if counts != expect_counts(launches=f + 1, media_launches=f + 1):
            raise AssertionError(f"frame {f + 1} is not one launch of K1's MEDIA instantiation: {counts}")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "media.png")
        save_render(png, buf.pixels)
        if not os.path.getsize(png) > 0:
            raise AssertionError("no PNG written")
    pixels = buf.pixels.cpu().numpy()
    print(f"  launches {counts}  mean rgb={pixels[..., :3].mean():.4f}; wrote a PNG")
    if pixels.shape != (MAIN_H, MAIN_W, 4) or not np.isfinite(pixels).all() or not pixels[..., :3].max() > 0.05:
        raise AssertionError("the media main-path image is not finite, black or of the wrong shape")
    main_launches = counts["media_launches"]
    key = rng.prng_key(5)
    ms = cuda_ms(lambda: mk.render_frame_megakernel(main, key, MAIN_W, MAIN_H), 20)
    k1 = mk.prepare_launch(main, key, MAIN_W, MAIN_H, 1, VERBATIM)
    launch_ms = cuda_ms(lambda: mk.launch(k1), 20)
    plain_ms = cuda_ms(lambda: mk.render_frame_reference(main, key, MAIN_W, MAIN_H), 2)
    work = count_media_work(main, key, MAIN_W, MAIN_H)
    pix = MAIN_W * MAIN_H
    k1_work = (work["segments"] * K1_OPS["f32"] + work["medium"] * MEDIUM_SEGMENT_OPS
               - work["scatter"] * SCATTER_SAVED_OPS,
               work["segments"] * K1_OPS["f64"] + pix * CAMERA_F64_OPS, k1.sv.shape[1] * 4 + 16 + pix * 16)
    bound_ms, bound_by = bound_of(*k1_work)
    print(f"  wrapper {ms:.3f} ms/frame (kernel launch alone {launch_ms:.3f} ms), plain {plain_ms:.3f} ms/frame "
          f"({card})")
    print(f"  ray segments {work['segments']} ({work['segments'] / pix:.3f} per pixel), {work['medium']} inside the "
          f"medium, {work['scatter']} scatter events; ray segments/s: kernel {work['segments'] / ms * 1e3:.4e}, "
          f"plain {work['segments'] / plain_ms * 1e3:.4e}; bound {bound_ms:.4f} ms ({bound_by}) ({card})")
    # where the time goes: the same glass without its medium through the
    # media-free K1 and through the MEDIA instantiation (a vacuum record)
    glass = media_scene(torch, families, "analytical", dev, MEDIA_MAIN)
    glass.params.materials.medium.medium_type.zero_()
    kv = mk.prepare_launch(glass, key, MAIN_W, MAIN_H, 1, VERBATIM)
    km = kv._replace(sv=mk.pack_scene(glass, MAIN_W, MAIN_H, True).contiguous(), media=True)
    vacuum_ms, vacuum_media_ms = cuda_ms(lambda: mk.launch(kv), 20), cuda_ms(lambda: mk.launch(km), 20)
    vacuum_segments = count_media_work(glass, key, MAIN_W, MAIN_H)["segments"]
    print(f"  the glass without its medium ({vacuum_segments} segments): media-free K1 {vacuum_ms:.3f} ms, the MEDIA "
          f"instantiation {vacuum_media_ms:.3f} ms; with the Scatter medium {launch_ms:.3f} ms ({card})")
    grad_scene = media_scene(torch, families, "analytical", dev, MEDIA_MAIN)
    density = grad_scene.params.materials.medium.density.requires_grad_(True)
    reset_counts(mk)
    img = mk.render_frame_megakernel(grad_scene, rng.prng_key(0), 16, 8)
    fwd_counts = read_counts(mk)
    reset_counts(mk)
    torch.autograd.grad(img[..., :3].sum(), density)
    if (fwd_counts, read_counts(mk)) != (expect_counts(launches=1, media_launches=1),
                                         expect_counts(bwd_launches=1, media_bwd_launches=1)):
        raise AssertionError(f"a CUDA media scene with grad: not one K1 MEDIA launch, then one K2 MEDIA launch and "
                             f"nothing else: {fwd_counts}, {read_counts(mk)}")
    print("  a CUDA media scene with grad: one K1 MEDIA launch, its backward one K2 MEDIA launch and nothing else")
    if other:
        results = k1_pair.pair([Path(other)], (*families.FAMILIES, *k1_pair.MEDIA_SCENES),
                               log=lambda s: print("  " + s))
        k1_pair.resources(Path(other), log=lambda s: print("  " + s))
        for r in results:
            print(f"  {r['kernel']} {r['scene']}: this / other {r['ratio']:.4f}, "
                  f"{'frames and counts' if r['kernel'].startswith('K3') else 'output'} bit-equal {r['bit_equal']}"
                  + ("" if r["bit_equal"] else f" ({r['differ']} of {r['entries']} entries differ"
                     + (f", by at most {r['max_diff']:.3e}" if r["max_diff"] is not None else "")
                     + (f"; counts equal {r['counts_equal']}" if "counts_equal" in r else "") + ")"))
        # the small mesh's frames (and with them K3's output) move in the
        # last bits against a tree that built it with FMA contraction:
        # phases 17, 25, 27 and 29 hold them to the plain version. Every
        # other pair is the other tree's bit for bit.
        contracted = not k1_pair.mesh_rounds_apart(k1_pair.tree_csrc(other))
        moved = [(r["kernel"], r["scene"]) for r in results if not r["bit_equal"]
                 and not (contracted and k1_pair.MEDIA_SCENES.get(r["scene"], r["scene"]) == "mesh")]
        if moved:
            raise AssertionError(f"K1 or K3 of this tree and the other's differ in output: {moved}")
    else:
        print("  K1 and K3 against another tree's: not run (no --other DIR given)")

    print("== 29. K3's media instantiation vs its plain version (bounces_entered), frame bit-equal to K1's")
    k3_err = 0.0
    cases = [("analytical", w, h, spp, quirks) for w, h, spp, quirks in (
        (320, 240, 1, VERBATIM), (320, 240, 2, VERBATIM), (320, 240, 1, FIXED), (MAIN_W, MAIN_H, 1, VERBATIM))]
    cases += [(family, 320, 240, 1, VERBATIM) for family in ("sdf", "mesh", "bigmesh")]
    for i, (family, w, h, spp, quirks) in enumerate(cases):
        scene = media_scene(torch, families, family, dev, MEDIA_MAIN)
        key = rng.prng_key(301 + i)
        k = mk.prepare_launch(scene, key, w, h, spp, quirks)
        entered = torch.empty((spp, h, w), dtype=torch.int32, device=dev)
        frame = mk.launch(k, entered).clone()
        same_frame = bool(torch.equal(frame, mk.launch(k)))
        ref = bounces_entered(scene, key, w, h, spp, quirks)
        keep = ~coplanar_ties(torch, scene, key, w, h, spp, quirks).to(dev)
        same = float((entered[:, keep] == ref[:, keep]).double().mean())
        got, want = (mk.occupancy_stats(e, MEDIA_DEPTH) for e in (entered, ref))
        d = float((got["alive_fraction"] - want["alive_fraction"]).abs().max())
        k3_err = max(k3_err, d)
        print(f"  {family} {w}x{h} spp{spp} {'VERBATIM' if quirks == VERBATIM else 'FIXED'}: frame bit-equal to "
              f"K1's {same_frame}; counts equal on {same:.6f} of lanes"
              + (f" ({int((~keep).sum())} coplanar-tie pixels left out)" if family == "mesh" else "")
              + f"; alive fractions {fmt_fractions(got['alive_fraction'])}, max |diff| {d:.2e}")
        if not (same_frame and same >= OCC_SAME_MIN and d <= OCC_FRAC_TOL):
            raise AssertionError(f"K3 MEDIA {family} {w}x{h} spp{spp}: outside tolerance")
        del k, entered, frame, ref
    key = rng.prng_key(5)
    reset_counts(mk)
    occ = mk.measure_occupancy_megakernel(main, key, MAIN_W, MAIN_H)
    counts = read_counts(mk)
    if counts != expect_counts(occupancy_launches=1, occupancy_media_launches=1):
        raise AssertionError(f"measure_occupancy_megakernel on the media scene: not one K3 MEDIA launch: {counts}")
    print(f"  measure_occupancy_megakernel at {MAIN_W}x{MAIN_H}: launches {counts}; alive fractions "
          f"{fmt_fractions(occ['alive_fraction'])}, idle lanes of live warps {occ['warp_wasted_fraction']:.5f} "
          f"(per-thread loop), {occ['compacted_wasted_fraction']:.5f} (compacted loop)")
    occ_mesh = mk.measure_occupancy_megakernel(media_scene(torch, families, "mesh", dev, MEDIA_MAIN), key, MAIN_W,
                                               MAIN_H)
    print(f"  the mesh's glass Scatter scene at {MAIN_W}x{MAIN_H}: alive fractions "
          f"{fmt_fractions(occ_mesh['alive_fraction'])}, idle lanes of live warps "
          f"{occ_mesh['warp_wasted_fraction']:.5f} (per-thread loop), {occ_mesh['compacted_wasted_fraction']:.5f} "
          "(compacted loop)")
    k3 = k1._replace(out=torch.empty_like(k1.out))
    entered = torch.empty((1, MAIN_H, MAIN_W), dtype=torch.int32, device=dev)
    pair = k1_pair.in_turns({"other": lambda: mk.launch(k1), "this": lambda: mk.launch(k3, entered)},
                            f"K3 MEDIA launch (this) against K1 MEDIA's (other) at {MAIN_W}x{MAIN_H}, depth "
                            f"{MEDIA_DEPTH}, spp 1", card, log=lambda s: print("  " + s))
    if not pair["bit_equal"]:
        raise AssertionError("K3 MEDIA: its 1080p frame is not K1 MEDIA's")
    refs = []
    k3_plain_ms = cuda_ms(lambda: refs.append(bounces_entered(main, key, MAIN_W, MAIN_H)), 1, warmup=0)
    k3_bound_ms, k3_bound_by = bound_of(k1_work[0], k1_work[1], k1_work[2] + 4 * pix)
    print(f"  K3 MEDIA launch {pair['this_ms']:.4f} ms, K1 MEDIA's {pair['other_ms']:.4f} ms in turns "
          f"({pair['ratio']:.4f}x); plain {k3_plain_ms:.3f} ms; bound {k3_bound_ms:.4f} ms ({k3_bound_by}) ({card})")
    return [dict(
        name="megakernel_fwd_media", route="cuda", source="pathtracer_tpu_torch/csrc/megakernel_fwd.cu",
        replaces="pathtracer_tpu/ops/megakernel.py:1605", launches=main_launches, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    ), dict(
        name="megakernel_fwd_occupancy_media", route="cuda", source="pathtracer_tpu_torch/csrc/megakernel_fwd.cu",
        replaces="pathtracer_tpu/ops/megakernel.py:1644", launches=counts["occupancy_media_launches"],
        max_abs_err=k3_err, ms=pair["this_ms"], plain_ms=k3_plain_ms, bound_ms=k3_bound_ms, bound_by=k3_bound_by,
        library_ms=None,
    )]


def step_pair_phase(torch, inverse, rng, dev, card: str, other) -> None:
    """Phase 35, with `other`: a training step at 1920x1080, spp 1, of the
    analytical trainer (recover_demo's leaves, depth 4) and of the media
    trainer (the Scatter demo's medium, depth 6), each through this tree's
    kernels and through the other tree's (tools/k1_pair.kernels_of), in
    turns (k1_pair.in_turns), each side's trainer from the same start, its
    first loss bit-equal to the other side's."""
    from pathtracer_tpu_torch.integrator.tracer import VERBATIM
    from pathtracer_tpu_torch.tools import k1_pair

    print(f"== 35. training steps at {MAIN_W}x{MAIN_H}, spp 1, against another tree's kernels, in turns")
    if not other:
        print("  not run (no --other DIR given)")
        return

    def analytical():
        true_scene, start_scene = inverse.demo_scenes(MAIN_DEPTH, dev)
        return true_scene, start_scene, inverse.DEMO_SELECTS["analytical"], inverse.PROJECTIONS["analytical"]

    def media():
        true_scene, start_scene = k1_pair.media_demo(dev), k1_pair.media_demo(dev)
        with torch.no_grad():
            med = start_scene.params.materials.medium
            med.density[1] = MEDIA_TRAIN_START[0]
            med.color.x[1], med.color.y[1], med.color.z[1] = MEDIA_TRAIN_START[1]
        return true_scene, start_scene, ("medium",), None

    def step(scenes, tree=None):
        """One trainer's step as a call, through `tree`'s kernels (this
        tree's by default)."""
        true_scene, start_scene, select, projection = scenes()
        render = inverse.make_renderer("megakernel", MAIN_W, MAIN_H, 1, VERBATIM)
        with torch.no_grad():
            target = render(true_scene, rng.prng_key(8))
        train, rebuild, _ = inverse.select_leaves(start_scene, select)
        opt = inverse.make_adam(train, 3e-2)

        def run():
            with k1_pair.kernels_of(tree) if tree else contextlib.nullcontext():
                return inverse.paired_step(train, rebuild, projection, opt, render, target, rng.prng_key(7))
        return run

    for name, scenes in (("analytical", analytical), ("media", media)):
        r = k1_pair.in_turns({"other": step(scenes, Path(other)), "this": step(scenes)},
                             f"{name} training step (2 K1 + 1 K2) against {other}'s kernels", card,
                             log=lambda s: print("  " + s))
        if not r["bit_equal"]:
            raise AssertionError(f"the {name} step's first loss differs from the other tree's")


def media_moved(scene, key, w, h, spp, quirks):
    """Phase 30's pixels on the mesh: mesh_near_edge's and the coplanar ties
    (a path inside the glass cube that meets its bottom face and the floor
    at one t), which may be 5% of the frame (the host tests' bound)."""
    import torch

    near, _, _ = mesh_near_edge(scene, key, w, h, spp, quirks)
    ties = coplanar_ties(torch, scene, key, w, h, spp, quirks).to(near.device)
    return near | ties, f"near an edge or at a coplanar tie ({int(ties.sum())} ties)", 0.05


def media_leaf_close(got, want, name, scale) -> bool:
    """leaf_close's tolerances for phase 31 (the light's position and radius
    with the geometry), the rtol taken of `scale` where that is larger than
    |want|."""
    rtol, atol = (1e-2, 1e-7) if name.startswith(MEDIA_GEOMETRY) else (5e-3, 1e-8)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.maximum(np.abs(want), scale)))


def k2_media_ops(work: dict, segment_f32: float) -> float:
    """K2 MEDIA's float32 operations for count_media_work's `work`, at
    `segment_f32` a segment off media."""
    return (work["segments"] * segment_f32 + work["medium"] * (MEDIUM_SEGMENT_OPS + MEDIUM_SEGMENT_ADJ_OPS)
            - work["scatter"] * (SCATTER_SAVED_OPS + SCATTER_SAVED_ADJ_OPS))


def media_backward_phases(torch, mk, _build, inverse, rng, cuda_ms, dev, card: str, total_bytes: int,
                          trainer_pieces, other) -> list[dict]:
    """Phases 30-33, K2's MEDIA instantiation: against its plain version and
    the JAX gradients, the media trainer (the main path) with the SDF and
    mesh ones, the times, and with `other` the mesh and MEDIA K2 of
    another tree in turns and both trees' resources. Returns its rows of the
    kernels line, one a backend."""
    from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
    from pathtracer_tpu_torch.models import families
    from pathtracer_tpu_torch.ops import megakernel_sdf as mks
    from pathtracer_tpu_torch.tools import k1_pair, k2_pair
    from pathtracer_tpu_torch.tools.work import count_media_work, count_mesh_work

    print(f"== 30. K2's media instantiation vs its plain version on the card (depth {MEDIA_DEPTH})")
    lib = _build.load("megakernel_bwd")
    for kernel, counts in (("megakernel_bwd", None), ("megakernel_bwd_media", None), ("megakernel_mesh", None),
                           ("megakernel_sdf", (1, 1, 1)), ("megakernel_sdf_bwd_media", (1, 1, 1))):
        for key_, line in sorted(k1_pair.instantiations(_build.CSRC, kernel, k2_pair.k2_key, counts=counts).items()):
            print(f"  {key_[1]} K2{' MEDIA' if key_[2] else ''} {key_[0]}: {line}")
    scenes = {name: media_scene(torch, families, "analytical", dev, name) for name in ("absorb", "emissive", MEDIA_MAIN)}
    scenes["lit"] = media_scene(torch, families, "analytical", dev, MEDIA_MAIN, lit=True)
    for family in ("sdf", "mesh"):
        scenes[family] = media_scene(torch, families, family, dev, MEDIA_MAIN)
    for name, sc in scenes.items():
        k = mk.prepare_launch(sc, rng.prng_key(0), 8, 8, 1, VERBATIM)
        n_tris = k.counts[0] if name == "mesh" else 0
        print(f"  {name}: P = {k.sv.shape[1]}, {lib.pt_backward_smem_bytes(k.sv.shape[1], n_tris)} B of shared "
              "memory a block")
    cases = [(scenes[name], 320, 240, spp, quirks, 401 + 3 * i + j, f", {name}")
             for i, name in enumerate((MEDIA_MAIN, "absorb", "emissive", "lit"))
             for j, (spp, quirks) in enumerate(((1, VERBATIM), (2, VERBATIM), (1, FIXED)))]
    err, peak_320 = check_backward(torch, mk, rng, dev, total_bytes, cases)
    w, h = MAIN_W, MAIN_H
    while peak_320 * (w * h) / (320 * 240) > 0.6 * total_bytes:
        w, h = w // 2, h // 2
    if w != MAIN_W:
        print(f"  the plain gradient does not fit at {MAIN_W}x{MAIN_H}: the largest case is {w}x{h}")
    e, _ = check_backward(torch, mk, rng, dev, total_bytes, [(scenes[MEDIA_MAIN], w, h, 1, VERBATIM, 420,
                                                              f", {MEDIA_MAIN}")], peak_320=peak_320)
    err = max(err, e)
    family_err = {}
    for family, seed, moved in (("sdf", 421, sdf_grazing), ("mesh", 422, media_moved)):
        family_err[family], _ = check_backward(torch, mk, rng, dev, total_bytes, [
            (scenes[family], 320, 240, 1, VERBATIM, seed, f", {family} {MEDIA_MAIN}")], moved=moved)

    print("== 31. K2 MEDIA vs the JAX gradient fixture, every leaf, through the autograd Function and the packers")
    with np.load(MEDIA_GRAD_FIXTURE) as data:
        fixture = {k: data[k] for k in data.files}
    bad = []
    for case, name in MEDIA_GRAD_CASES.items():
        want = {k[len(case) + 1:]: v for k, v in fixture.items()
                if k.startswith(case + "/") and "/" not in k[len(case) + 1:]}
        scene = media_scene(torch, families, "analytical", dev, name, lit=case == "lit")
        leaves = dict(inverse.named_leaves(scene))
        names = sorted(want)
        if names != sorted(n for n, leaf in leaves.items() if leaf.is_floating_point()):
            raise AssertionError(f"{case}: the fixture's leaves are not the scene's float leaves")
        for n in names:
            leaves[n].requires_grad_(True)
        reset_counts(mk)
        img = mk.render_frame_megakernel(scene, rng.prng_key(3), 64, 48)
        grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in names], allow_unused=True)
        counts = read_counts(mk)
        if counts != expect_counts(launches=1, media_launches=1, bwd_launches=1, media_bwd_launches=1):
            raise AssertionError(f"{case}: expected 1 K1 MEDIA and 1 K2 MEDIA launch, got {counts}")
        got_all = {n: np.zeros(want[n].shape) if g is None else g.cpu().numpy() for n, g in zip(names, grads)}
        n_ok = 0
        for n in names:
            got = got_all[n]
            scale = sum(np.abs(fixture[f"{case}/rows{k}/{n}"]) for k in range(MEDIA_GRAD_BANDS))
            if media_leaf_close(got, want[n], n, scale):
                n_ok += 1
            else:
                bad.append(f"{case}/{n}")
                print(f"  {case} {n}: K2 {np.array2string(got.ravel(), precision=6)} "
                      f"JAX {np.array2string(want[n].ravel(), precision=6)} OUTSIDE")
        medium = {n: got_all[n].ravel() for n in names if "medium" in n}
        print(f"  {case}: {n_ok} of {len(names)} leaves within tolerance; launches 1 K1 MEDIA, 1 K2 MEDIA; medium "
              + ", ".join(f"{n.rsplit('medium.', 1)[1]} {np.array2string(v, precision=6)}" for n, v in medium.items()))
        if case in ("scatter", "lit") and medium["params.materials.medium.density"][1] != 0.0:
            raise AssertionError(f"{case}: the Scatter density's gradient is not 0")
    if bad:
        raise AssertionError(f"K2 MEDIA gradients outside the fixture's tolerance: {bad}")

    print(f"== 32. media trainer: inverse_render on the Absorb demo, {TRAIN_W}x{TRAIN_H}, depth {MEDIA_DEPTH}, "
          f"{TRAIN_STEPS} steps")
    counting_render, real_render, calls = trainer_pieces

    def start_of(family, name):
        """The family's glass filled with the medium `name`, its density and
        color at MEDIA_TRAIN_START."""
        out = media_scene(torch, families, family, dev, name)
        with torch.no_grad():
            i = MEDIA_GLASS[family]
            med = out.params.materials.medium
            med.density[i] = MEDIA_TRAIN_START[0]
            med.color.x[i], med.color.y[i], med.color.z[i] = MEDIA_TRAIN_START[1]
        return out

    true_scene = scenes["absorb"]
    calls.clear()
    reset_counts(mk)
    with torch.no_grad():
        target = mk.render_frame_megakernel(true_scene, rng.prng_key(17), TRAIN_W, TRAIN_H)
    inverse.render_frame_megakernel = counting_render
    try:
        out = inverse.inverse_render(start_of("analytical", "absorb"), target, rng.prng_key(3), MEDIA_SELECT, TRAIN_W,
                                     TRAIN_H, steps=TRAIN_STEPS, lr=3e-2, spp=1, kernel="megakernel")
        counts = read_counts(mk)
    finally:
        inverse.render_frame_megakernel = real_render
    losses = out.losses.cpu().numpy()
    med = out.scene.params.materials.medium
    print(f"  launches {counts}; losses {losses[0]:.6e} -> {losses[-1]:.6e}: {np.array2string(losses, precision=6)}")
    print(f"  density: true {MEDIA['absorb'][1]} start {MEDIA_TRAIN_START[0]} recovered {float(med.density[1]):.4f}; "
          f"color: true {MEDIA['absorb'][2]} start {MEDIA_TRAIN_START[1]} recovered "
          f"({float(med.color.x[1]):.4f}, {float(med.color.y[1]):.4f}, {float(med.color.z[1]):.4f})")
    step_starts = [c[:2] for c in calls if c[2]]
    want = expect_counts(launches=1 + 2 * TRAIN_STEPS, media_launches=1 + 2 * TRAIN_STEPS, bwd_launches=TRAIN_STEPS,
                         media_bwd_launches=TRAIN_STEPS)
    if counts != want or step_starts != [(1 + 2 * i, i) for i in range(TRAIN_STEPS)]:
        raise AssertionError(f"a media step is not 2 K1 MEDIA + 1 K2 MEDIA launches: {calls} -> {counts}")
    if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"media trainer losses not finite or not falling: {losses}")
    launches = {"analytical": (counts["media_bwd_launches"], stage_counts(counts))}
    with torch.no_grad():
        small_target = mk.render_frame_megakernel(true_scene, rng.prng_key(17), 64, 48)
    runs = {kern: inverse.inverse_render(start_of("analytical", "absorb"), small_target, rng.prng_key(3), MEDIA_SELECT,
                                         64, 48, steps=3, lr=3e-2, spp=1, kernel=kern) for kern in inverse.KERNELS}
    got, want = runs["megakernel"], runs["eager"]
    loss_rel = np.abs(got.losses.cpu().numpy() / want.losses.cpu().numpy() - 1.0).max()
    leaves_got, _, leaf_names = inverse.select_leaves(got.scene, MEDIA_SELECT)
    leaves_want, _, _ = inverse.select_leaves(want.scene, MEDIA_SELECT)
    leaf_rel = {n: float(((a - b).abs() / b.abs().clamp_min(1e-6)).max().detach())
                for n, a, b in zip(leaf_names, leaves_got, leaves_want)}
    print(f"  64x48 losses: kernels {got.losses.cpu().numpy()}, eager {want.losses.cpu().numpy()}; max rel "
          f"{loss_rel:.3e} (tolerance {SDF_TRAIN_LOSS_RTOL})")
    print("  leaves after step 3, max rel: " + ", ".join(f"{n} {x:.3e}" for n, x in leaf_rel.items())
          + f" (tolerance {SDF_TRAIN_LEAF_RTOL})")
    if not (loss_rel <= SDF_TRAIN_LOSS_RTOL and max(leaf_rel.values()) <= SDF_TRAIN_LEAF_RTOL):
        raise AssertionError("the media kernel path's losses or leaves differ from the eager path's")
    for family in ("sdf", "mesh"):
        scene = scenes[family]
        reset_counts(mk)
        with torch.no_grad():
            target = mk.render_frame_megakernel(scene, rng.prng_key(17), TRAIN_W, TRAIN_H)
        out = inverse.inverse_render(start_of(family, MEDIA_MAIN), target, rng.prng_key(3), MEDIA_SELECT, TRAIN_W,
                                     TRAIN_H, steps=MEDIA_TRAIN_FAMILY_STEPS, lr=3e-2, spp=1, kernel="megakernel")
        counts = read_counts(mk)
        n = MEDIA_TRAIN_FAMILY_STEPS
        want = expect_counts(launches=1 + 2 * n, media_launches=1 + 2 * n, bwd_launches=n, media_bwd_launches=n,
                             **{f"{family}_launches": 1 + 2 * n, f"{family}_bwd_launches": n})
        losses = out.losses.cpu().numpy()
        print(f"  {family} glass ({MEDIA_MAIN}, density and color from {MEDIA_TRAIN_START}): {n} steps, launches "
              f"{counts}; losses {np.array2string(losses, precision=6)}")
        if counts != want or not np.isfinite(losses).all():
            raise AssertionError(f"a {family} media step is not 2 K1 MEDIA + 1 K2 MEDIA launches with its backend, "
                                 f"or its losses are not finite: {counts}")
        launches[family] = (counts["media_bwd_launches"], stage_counts(counts))

    print(f"== 33. times: K2 MEDIA at {MAIN_W}x{MAIN_H}, depth {MEDIA_DEPTH}, spp 1, the Scatter demo")
    main = scenes[MEDIA_MAIN]
    key, step_key = rng.prng_key(5), rng.prng_key(7)

    def step(kern, scene, w, h):
        render = inverse.make_renderer(kern, w, h, 1, VERBATIM)
        with torch.no_grad():
            target = render(scene, rng.prng_key(8))
        train, rebuild, _ = inverse.select_leaves(start_of("analytical", MEDIA_MAIN), ("medium",))
        opt = inverse.make_adam(train, 3e-2)
        return lambda: inverse.paired_step(train, rebuild, None, opt, render, target, step_key)

    step_ms = cuda_ms(step("megakernel", main, MAIN_W, MAIN_H), 10, warmup=2)
    k = mk.prepare_launch(main, key, MAIN_W, MAIN_H, 1, VERBATIM)
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((MAIN_H, MAIN_W, 4)).astype(np.float32)).to(dev)
    bwd_ms = cuda_ms(lambda: mk.launch_backward(k, ct), 10)
    split = k2_stages(mk, _build, cuda_ms, k, ct, card, f"K2 MEDIA at {MAIN_W}x{MAIN_H}")
    if (w, h) == (MAIN_W, MAIN_H):
        plain_bwd_ms = cuda_ms(lambda: mk.render_grad_reference(k.sv, main, key, ct, MAIN_W, MAIN_H), 1, warmup=0)
        plain_step_ms = cuda_ms(step("eager", main, MAIN_W, MAIN_H), 1, warmup=0)
        plain_at = ""
    else:
        kp = mk.prepare_launch(main, key, w, h, 1, VERBATIM)
        plain_bwd_ms = cuda_ms(lambda: mk.render_grad_reference(kp.sv, main, key, ct[:h, :w], w, h), 1, warmup=0)
        plain_step_ms = cuda_ms(step("eager", main, w, h), 1, warmup=0)
        plain_at = f" at {w}x{h} (it does not fit at {MAIN_W}x{MAIN_H})"
    work = count_media_work(main, key, MAIN_W, MAIN_H)
    pix = MAIN_W * MAIN_H
    bound_ms, bound_by = bound_of(k2_media_ops(work, K2_OPS["f32"]), work["segments"] * K2_OPS["f64"]
                                  + pix * CAMERA_F64_OPS, k.sv.shape[1] * 8 + 16 + pix * 16)
    print(f"  media training step: kernels {step_ms:.3f} ms, plain {plain_step_ms:.3f} ms{plain_at} ({card})")
    print(f"  K2 MEDIA launch alone {bwd_ms:.3f} ms, plain gradient (eager forward + autograd) {plain_bwd_ms:.3f} ms"
          f"{plain_at}, bound {bound_ms:.4f} ms ({bound_by}; {work['segments']} segments, {work['medium']} inside "
          f"the medium, {work['scatter']} scatter events) ({card})")
    rows = [dict(
        name="megakernel_bwd_media", route="cuda", source="pathtracer_tpu_torch/csrc/tracer_adj.cuh",
        replaces="pathtracer_tpu/ops/megakernel.py:1771", launches=launches["analytical"][0], max_abs_err=err,
        ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        stages=stage_rows(split, launches["analytical"][1]),
    )]
    # the SDF and mesh instantiations at 320x240, plain version and bound alike
    w, h = 320, 240
    pix = w * h
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((h, w, 4)).astype(np.float32)).to(dev)
    for family, replaces, seg_f32 in (
            ("sdf", "pathtracer_tpu/ops/megakernel_sdf.py:172",
             SDF_SEGMENT_OPS["f32"] + K2_ADJ_OPS["f32"] - ANALYTICAL_HIT_ADJ_F32 + SDF_ADJ_OPS),
            ("mesh", "pathtracer_tpu/ops/megakernel_mesh.py:95",
             MESH_SEGMENT_OPS["f32"] + K2_ADJ_OPS["f32"] - ANALYTICAL_HIT_ADJ_F32 + MESH_HIT_ADJ_OPS)):
        scene = scenes[family]
        kf = mk.prepare_launch(scene, key, w, h, 1, VERBATIM)
        ms = cuda_ms(lambda: mk.launch_backward(kf, ct), 10)
        family_split = k2_stages(mk, _build, cuda_ms, kf, ct, card, f"K2 MEDIA {family} at {w}x{h}")
        plain_ms = cuda_ms(lambda: mk.render_grad_reference(kf.sv, scene, key, ct, w, h), 1, warmup=0)
        work = count_media_work(scene, key, w, h)
        f32 = k2_media_ops(work, seg_f32)
        nbytes = kf.sv.shape[1] * 8 + 16 + pix * 16
        if family == "sdf":
            steps = mks.measure_march_steps(scene, w, h)
            f32 += (int(steps["steps"].sum()) + int(steps["shadow_steps"].sum())) * SDF_STEP_OPS
            f64 = work["segments"] * SDF_SEGMENT_OPS["f64"] + pix * CAMERA_F64_OPS
        else:
            mw = count_mesh_work(scene, key, w, h)
            f32 += (mw["closest_tests"] + mw["shadow_tests"]) * MESH_TRI_OPS
            f64 = work["segments"] * MESH_SEGMENT_OPS["f64"] + pix * CAMERA_F64_OPS
            nbytes += kf.extras[0].numel() * 4
        fb_ms, fb_by = bound_of(f32, f64, nbytes)
        print(f"  K2 MEDIA {family} at {w}x{h}: launch alone {ms:.3f} ms, plain gradient {plain_ms:.3f} ms, bound "
              f"{fb_ms:.4f} ms ({fb_by}; {work['segments']} segments, {work['medium']} inside the medium, "
              f"{work['scatter']} scatter events) ({card})")
        rows.append(dict(
            name=f"megakernel_bwd_media_{family}", route="cuda",
            source=f"pathtracer_tpu_torch/csrc/{family}_adj.cuh", replaces=f"pathtracer_tpu/ops/megakernel.py:1771 + "
            f"{replaces}", launches=launches[family][0], max_abs_err=family_err[family], ms=ms, plain_ms=plain_ms,
            bound_ms=fb_ms, bound_by=fb_by, library_ms=None, stages=stage_rows(family_split, launches[family][1]),
        ))
    if other:
        check_pairing(k2_pair.pair([Path(other)], ("mesh", "media"), log=lambda s: print("  " + s)))
        k2_pair.resources(Path(other), log=lambda s: print("  " + s))
        print("  analytical and SDF K2 of both trees in turns: phase 24")
    else:
        print("  K2 against another tree's: not run (no --other DIR given)")
    return rows


def enclosed_scene(torch, make_scene, dev, depth: int = DEEP_DEPTH):
    """The demo scene inside sphere 1, grown to radius 20 about the origin
    (tests/test_torch_kernel_bwd_host.py's enclosed_scene): the camera,
    sphere 0, the light and the floor lie within it, so a path ends only on
    the light or at `depth`."""
    scene = make_scene(recursion_depth=depth, device=dev)
    with torch.no_grad():
        scene.params.sphere_center.x[1], scene.params.sphere_radius[1] = 0.0, 20.0
    return scene


def deep_phase(torch, mk, rng, dev, total_bytes: int) -> None:
    """Phase 34: K2 at depth 20 (its records hold any depth; the adjoint
    once held 16 bounces a thread) against its plain version at 320x240,
    through the autograd Function (one K1 launch, one K2 call, one record
    kernel launch), and the record buffer's chunks: capped so that the frame
    takes several launches of each kernel, whole blocks of pixels must give
    the one-chunk gradient bit for bit and chunks of samples within 1e-5 of
    the largest entry (a float32 sum in another order)."""
    from pathtracer_tpu_torch.integrator import inverse
    from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM, bounces_entered
    from pathtracer_tpu_torch.models.analytical import make_scene

    print(f"== 34. K2 at depth {DEEP_DEPTH} vs its plain version on the card, and the record buffer's chunks")
    scene = enclosed_scene(torch, make_scene, dev)
    w, h = 320, 240
    for seed, quirks in ((141, VERBATIM), (142, FIXED)):
        entered = bounces_entered(scene, rng.prng_key(seed), w, h, 1, quirks)
        print(f"  seed {seed}: {float((entered > 16).double().mean()):.4f} of the paths enter more than 16 bounces, "
              f"{float((entered == DEEP_DEPTH).double().mean()):.4f} all {DEEP_DEPTH}")
        if int(entered.max()) != DEEP_DEPTH:
            raise AssertionError(f"no path enters {DEEP_DEPTH} bounces")
    check_backward(torch, mk, rng, dev, total_bytes, [(scene, w, h, 1, VERBATIM, 141, f", depth {DEEP_DEPTH}"),
                                                      (scene, w, h, 2, FIXED, 142, f", depth {DEEP_DEPTH}")])
    grad_scene = enclosed_scene(torch, make_scene, dev)
    leaf = dict(inverse.named_leaves(grad_scene))["lights.emission.x"].requires_grad_(True)
    reset_counts(mk)
    (g,) = torch.autograd.grad(mk.render_frame_megakernel(grad_scene, rng.prng_key(143), w, h)[..., :3].mean(), leaf)
    counts = read_counts(mk)
    print(f"  through the autograd Function: launches {counts}, d/d emission.x {float(g):.6e}")
    if counts != expect_counts(launches=1, bwd_launches=1) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"depth {DEEP_DEPTH}: not one K1 launch and one K2 call, or not finite: {counts}")
    ct = torch.from_numpy(np.random.default_rng(144).standard_normal((h, w, 4)).astype(np.float32)).to(dev)
    for spp in (1, 2):
        k = mk.prepare_launch(scene, rng.prng_key(144), w, h, spp, VERBATIM)
        whole = mk.record_plan(k)[0]
        g = mk.launch_backward(k, ct)
        per = whole // (w * h * spp)  # one pixel's sample
        # 7 chunks of whole blocks of pixels; at spp 2 also 2 chunks of samples
        for cap in (per * 128 * 97,) + ((per * w * h,) if spp > 1 else ()):
            nbytes, pixels, samples = mk.record_plan(k, cap)
            chunks = -(-w * h // pixels) * -(-spp // samples)
            reset_counts(mk)
            g_cap = mk.launch_backward(k, ct, cap=cap)
            launched = stage_counts(read_counts(mk))
            rel = float((g_cap - g).abs().max() / g.abs().max())
            same = bool(torch.equal(g_cap, g))
            print(f"  spp {spp}, cap {cap} bytes: {chunks} chunks of {pixels} pixels x {samples} samples "
                  f"({nbytes} bytes), {launched} record and adjoint kernel launches; against one chunk: bit-equal "
                  f"{same}, "
                  f"max|d|/max|g| {rel:.3e}")
            if launched != (chunks, chunks) or nbytes > cap or chunks < 2:
                raise AssertionError(f"spp {spp}, cap {cap}: {chunks} chunks, {launched} launches, {nbytes} bytes")
            if (samples == spp and not same) or rel > 1e-5:
                raise AssertionError(f"spp {spp}, cap {cap}: the chunked gradient differs from the one-chunk one")


def print_registers(_build) -> None:
    """ptxas's lines of each library's build, and the seconds it took."""
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line or line.startswith(("built in", "== ")):
            print("  " + line.strip())


def sdf_grazing(scene, key, w, h, spp, quirks):
    """Phase 13's pixels: an SDF hit at |<rd, n>| < GRAZING on the plain
    path ([h, w] bool), what they are, and the share of the frame they may
    be (None: no limit)."""
    from pathtracer_tpu_torch.ops.megakernel_sdf import hit_cosines

    near = (hit_cosines(scene, key, w, h, spp, quirks) < GRAZING).flatten(0, 1).any(0).reshape(h, w)
    return near, f"with a hit at |<rd, n>| < {GRAZING}", None


def mesh_near_edge(scene, key, w, h, spp, quirks):
    """Phase 21's pixels: a mesh hit on the plain path whose barycentric
    margin is below MESH_MARGIN or |det| below MESH_DET."""
    from pathtracer_tpu_torch.ops.megakernel_mesh import hit_margins

    margin, det = hit_margins(scene, key, w, h, spp, quirks)
    near = ((margin < MESH_MARGIN) | (det < MESH_DET)).flatten(0, 1).any(0).reshape(h, w)
    return near, f"near an edge (margin < {MESH_MARGIN} or |det| < {MESH_DET})", MESH_NEAR_MAX


def check_record_paths(torch, mk, k, label: str) -> None:
    """K2's record kernel traces K1's paths: for launch `k` (one chunk of
    records), the bounces each path entered in its records (the lengths
    after them, csrc/megakernel_bwd.cuh) equal K3's counts for the same
    keys, lane for lane; raises where they do not."""
    from pathtracer_tpu_torch.tools import k2_pair

    height, width = k.out.shape[:2]
    lanes = k.spp * height * width
    if mk.record_chunks(k) != [(0, height * width, 0, k.spp)]:
        raise AssertionError(f"{label}: the records of {width}x{height} take more than one chunk")
    entered = torch.empty((k.spp, height, width), dtype=torch.int32, device=k.out.device)
    mk.launch(k, entered)
    rec = k2_pair.record_launcher(k)()
    lens = rec[rec.numel() - lanes:].view(torch.int32).reshape(entered.shape)
    same = int((lens == entered).sum())
    print(f"  {label} at {width}x{height}: the record kernel's path lengths equal K3's counts on {same} of {lanes} "
          f"paths (mean length {float(entered.double().mean()):.4f})")
    if same != lanes:
        raise AssertionError(f"{label}: K2's record kernel and K3 trace different paths on {lanes - same} lanes")
    del rec, entered


def check_backward(torch, mk, rng, dev, total_bytes: int, cases: list, moved=None,
                   peak_320=None) -> tuple[float, int]:
    """K2 against its plain version (phases 6, 13 and 21) for each case
    (scene, W, H, spp, quirks, seed, note): d(sum(ct * frame))/d(sv) for a
    numpy-seeded cotangent, over all pixels and with the knife-edge pixels
    masked (and those `moved` gives: sdf_grazing, mesh_near_edge, which
    fails past its limit), and K2 run twice for bit-equality. A 1920x1080
    case runs when the plain version's peak memory, measured at 320x240
    spp 1 VERBATIM (the first case, or `peak_320` where given) and scaled,
    fits in 0.6 of the card; else it prints why it did not. Returns the
    largest masked max|d| and the 320x240 peak."""
    from pathtracer_tpu_torch.integrator.tracer import VERBATIM

    err = 0.0
    for scene, w, h, spp, quirks, seed, note in cases:
        label = f"{w}x{h} spp{spp} {'VERBATIM' if quirks == VERBATIM else 'FIXED'}{note}"
        if w == MAIN_W:
            need = peak_320 * (MAIN_W * MAIN_H) / (320 * 240)
            if need > 0.6 * total_bytes:
                print(f"  {label}: skipped, the plain version would need ~{need / 2**30:.1f} GiB "
                      f"of {total_bytes / 2**30:.1f}")
                continue
        plain_grad = lambda c: mk.render_grad_reference(k.sv, scene, key, c, w, h, spp, quirks)
        key = rng.prng_key(seed)
        k = mk.prepare_launch(scene, key, w, h, spp, quirks)
        ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32)).to(dev)
        g = mk.launch_backward(k, ct)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        r = plain_grad(ct)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        if peak_320 is None:
            peak_320 = peak
        repeat = mk.launch_backward(k, ct)
        d = grad_diff(g.cpu(), r.cpu())
        del r
        # knife-edge pixels: the two forward frames took another branch there
        edge = (mk.launch(k) - mk.render_frame_reference(scene, key, w, h, spp, quirks)).abs()[..., :3]
        edge = edge.amax(dim=-1) > EDGE_TOL
        n_edge = int(edge.sum())
        if moved is not None:
            graze, kind, limit = moved(scene, key, w, h, spp, quirks)
            graze = graze & ~edge
            masked = ct * (~edge)[..., None]
            dm = grad_diff(mk.launch_backward(k, masked).cpu(), plain_grad(masked).cpu()) if n_edge else d
            print(f"    only the {n_edge} knife-edge pixels masked: max|d|/max|g|={dm['max_rel']:.3e}, "
                  f"entries > 1e-2 max rel {dm['big_rel']:.3e}; {int(graze.sum())} more pixels {kind} "
                  f"({int(graze.sum()) / (w * h):.3e} of the frame)")
            if limit is not None and int(graze.sum()) > limit * w * h:
                raise AssertionError(f"{label}: more than {limit} of the pixels {kind}")
            edge = edge | graze
        ct_m = ct * (~edge)[..., None]
        de = grad_diff(mk.launch_backward(k, ct_m).cpu(), plain_grad(ct_m).cpu())
        err = max(err, de["max_abs"])
        what = f"{n_edge} knife-edge" + (f" and {int(graze.sum())} moved" if moved is not None else "")
        print(f"  {label}: without the {what} pixels max|d|/max|g|={de['max_rel']:.3e}, "
              f"entries > 1e-2 max rel {de['big_rel']:.3e}, max|d| {de['max_abs']:.3e} (all pixels: "
              f"{d['max_rel']:.3e}, {d['big_rel']:.3e}, {d['max_abs']:.3e}); plain peak {peak / 2**20:.0f} MiB; "
              f"repeat bit-equal {bool(torch.equal(repeat, g))}")
        if not (d["finite"] and de["finite"] and de["max_rel"] <= GRAD_MAX_TOL and de["big_rel"] <= GRAD_RTOL):
            raise AssertionError(f"{label}: K2 outside tolerance")
        if not torch.equal(repeat, g):
            raise AssertionError(f"{label}: K2 is not reproducible")
        del g, repeat, ct, ct_m, k
        torch.cuda.empty_cache()
    return err, peak_320


def k2_stages(mk, _build, cuda_ms, k, ct, card: str, label: str) -> dict:
    """K2's two kernels of launch `k` (a frame of one chunk) timed apart on
    one record buffer (the record kernel's launch, then the adjoint
    kernel's; CUDA events, 10 calls each after a warm-up), the record
    buffer's bytes, and each kernel's registers, stack and spills (ptxas),
    dynamic shared memory and blocks of 128 an SM (the CUDA runtime's
    occupancy calculator)."""
    import torch

    from pathtracer_tpu_torch.tools import k1_pair, k2_pair

    rec = mk.record_buffer(k)
    nbytes, pixels, samples = mk.record_plan(k)
    (chunk,) = mk.record_chunks(k)
    height, width = k.out.shape[:2]
    partial = torch.empty((-(-width * height // 128), k.sv.shape[1]), device=k.sv.device)
    record_ms = cuda_ms(lambda: mk.launch_record(k, rec, chunk), 10)
    adjoint_ms = cuda_ms(lambda: mk.launch_adjoint(k, ct, rec, partial, chunk), 10)
    res = mk.backward_resources(k)
    if k.backend == "sdf":
        ptxas = k1_pair.instantiations(_build.CSRC, "megakernel_sdf_bwd_media" if k.media else "megakernel_sdf",
                                       k2_pair.k2_key, counts=k.counts)
    else:
        library = "megakernel_bwd_media" if k.media else {"mesh": "megakernel_mesh"}.get(k.backend, "megakernel_bwd")
        ptxas = k1_pair.instantiations(_build.CSRC, library, k2_pair.k2_key)
    backend = {"analytical": "AnalyticalAdj", "sdf": "SdfAdj", "mesh": "MeshAdj"}[k.backend]
    print(f"  {label}: record kernel {record_ms:.3f} ms, adjoint kernel {adjoint_ms:.3f} ms ({card}); record buffer "
          f"{nbytes} bytes ({nbytes / 2**20:.1f} MiB; chunks of {pixels} pixels x {samples} samples)")
    for name in ("record", "adjoint"):
        r = res[name]
        print(f"    {name}_kernel: {r['registers']} registers, {r['stack_bytes']} B stack, {r['shared_bytes']} B of "
              f"dynamic shared memory a block, {r['blocks_per_sm']} blocks of 128 an SM; ptxas: "
              f"{ptxas.get((f'{name}_kernel', backend, k.media))}")
    del rec, partial
    return dict(record_ms=record_ms, adjoint_ms=adjoint_ms, record_bytes=nbytes)


def stage_counts(counts: dict) -> tuple[int, int]:
    """The record and adjoint kernels' launches in a run's counts."""
    return counts["record_launches"], counts["adjoint_launches"]


def stage_rows(split: dict, launches: tuple[int, int]) -> list[dict]:
    """The K2 row's two kernels: each one's launches on the main path (the
    record and adjoint counts of stage_counts) and time."""
    return [dict(name="record_kernel", launches=launches[0], ms=split["record_ms"]),
            dict(name="adjoint_kernel", launches=launches[1], ms=split["adjoint_ms"])]


# How far another tree's K2 may sit from this one's (tools/k2_pair.pair's
# max_rel: the largest difference over the other's largest entry) in
# phases 24 and 33: the two designs sum the same float32 terms in other
# orders (1.2e-7 to 6.1e-7 against the one-kernel K2 on the H100); the
# MEDIA instantiation, built without contraction, was bit-equal.
PAIR_MAX_REL = 1e-5


def check_pairing(results: list[dict]) -> None:
    """Each of k2_pair.pair's results within PAIR_MAX_REL of the other
    tree's gradient, MEDIA's bit-equal, and the record kernels' records
    bit-equal (each is K1's bounce, whose frames are the other tree's). The
    small mesh's only printed against a tree that built it with FMA
    contraction (k1_pair.mesh_rounds_apart), whose paths may branch
    otherwise (phases 21-23 hold its gradient to the plain version and to
    JAX's)."""
    from pathtracer_tpu_torch.tools import k1_pair

    for r in results:
        rec = r["record"]
        print(f"  K2 {r['scene']}'s record kernel: this / other {rec['ratio']:.4f} ({rec['this_ms']:.4f} against "
              f"{rec['other_ms']:.4f} ms), records bit-equal {rec['bit_equal']}"
              + ("" if rec["bit_equal"] else f" ({rec['differ']} of {rec['entries']} words differ); the gradients' "
                 f"largest difference {r['max_rel']:.3e} of the other's largest entry"))
        if r["scene"] == "mesh" and not k1_pair.mesh_rounds_apart(k1_pair.tree_csrc(r["other"])):
            continue
        if not rec["bit_equal"]:
            raise AssertionError(f"K2 {r['scene']}'s records differ from {r['other']}'s")
        if r["scene"] == "media" and not r["bit_equal"]:
            raise AssertionError(f"K2 MEDIA differs from {r['other']}'s: max_rel {r['max_rel']:.3e}")
        if r["max_rel"] > PAIR_MAX_REL:
            raise AssertionError(f"K2 {r['scene']} differs from {r['other']}'s by {r['max_rel']:.3e} of its largest "
                                 f"entry (limit {PAIR_MAX_REL})")


def check_leaf_grads(grads: dict, fixture: str, close) -> None:
    """Every leaf of `fixture` against `grads` (name -> numpy array; a
    leaf K2 leaves untouched is zeros) with close(got, want, name)."""
    with np.load(fixture) as want:
        if sorted(want.files) != sorted(grads):
            raise AssertionError(f"{fixture}: leaves {sorted(want.files)} != {sorted(grads)}")
        bad = []
        for name in sorted(want.files):
            ok = close(grads[name], want[name], name)
            print(f"  {name}: K2 {np.array2string(grads[name].ravel(), precision=6)} "
                  f"JAX {np.array2string(want[name].ravel(), precision=6)} {'ok' if ok else 'OUTSIDE'}")
            if not ok:
                bad.append(name)
        if bad:
            raise AssertionError(f"K2 gradients outside the fixture's tolerance: {bad}")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch port on one CUDA card.")
    ap.add_argument("--other", default=None, help="root of another checkout: phase 24 times its analytical and "
                    "SDF K2 against this tree's, phase 28 its K1 and K3 on every backend and the media demo, phase 33 "
                    "its mesh and MEDIA K2, phase 35 the analytical and media training steps through its kernels, in "
                    "turns, and both trees' K1 and K2 resources")
    args = ap.parse_args(argv)

    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pathtracer_tpu_torch.app import invert as invert_cli
    from pathtracer_tpu_torch.app import render as cli
    from pathtracer_tpu_torch.integrator import inverse
    from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
    from pathtracer_tpu_torch.models.analytical import make_scene
    from pathtracer_tpu_torch.models.sdf import make_scene as make_sdf_scene
    from pathtracer_tpu_torch.ops import _build, rng
    from pathtracer_tpu_torch.ops import megakernel as mk
    from pathtracer_tpu_torch.ops import megakernel_sdf as mks
    from pathtracer_tpu_torch.tools.work import count_sdf_work, count_segments
    from pathtracer_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== 1. card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(f"  {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {nvcc.stdout.strip().splitlines()[-1]}")

    print("== 2. build")
    t0 = time.perf_counter()
    demo_counts = mks.sdf_counts(make_sdf_scene())
    _build.build(sdf_counts=(demo_counts,))
    for kernel in _build.kernels():
        _build.load(kernel)
    for kernel in _build.PER_COUNT:
        _build.load(kernel, counts=demo_counts)
    print(f"  built (one nvcc per kernel, side by side; the SDF backend's for the demo's counts {demo_counts}) and "
          f"loaded in {time.perf_counter() - t0:.1f} s")
    print_registers(_build)

    scene = make_scene(device=dev)
    max_err = 0.0

    print("== 3. kernel vs plain version on the card (depth 4)")
    for w, h, spp, quirks, seed in ((320, 240, 1, VERBATIM, 11), (320, 240, 2, VERBATIM, 12),
                                    (320, 240, 1, FIXED, 13), (1100, 3, 2, FIXED, 15), (MAIN_W, MAIN_H, 1, VERBATIM, 14)):
        label = f"{w}x{h} spp{spp} {'VERBATIM' if quirks == VERBATIM else 'FIXED'}"
        key = rng.prng_key(seed)
        img = mk.render_frame_megakernel(scene, key, w, h, spp, quirks)
        ref = mk.render_frame_reference(scene, key, w, h, spp, quirks)
        torch.cuda.synchronize()
        d = image_diff(img.cpu(), ref.cpu())
        max_err = max(max_err, d["max"])
        check_diff(label, d)

    print("== 4. kernel vs the JAX render fixture (64x48, depth 4, PRNGKey(3))")
    img = mk.render_frame_megakernel(scene, rng.prng_key(3), 64, 48)
    check_diff("vs JAX", image_diff(img.cpu(), np.load(FIXTURE)))

    print(f"== 5. main path: CLI, {MAIN_W}x{MAIN_H}, depth {MAIN_DEPTH}, {MAIN_FRAMES} frames")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render.png")
        cfg, _ = cli.parse_args([
            "--device", "cuda", "--width", str(MAIN_W), "--height", str(MAIN_H),
            "--depth", str(MAIN_DEPTH), "--spp", "1", "--frames", str(MAIN_FRAMES), "-o", png,
        ])
        reset_counts(mk)
        buf = cli.render(cfg, png, log=lambda s: print("  " + s))
        counts = read_counts(mk)
        launches = counts.pop("launches")
        if any(counts.values()):
            raise AssertionError(f"the forward render launched the backward kernel or another backend: {counts}")
        pixels = buf.pixels.cpu().numpy()
        if not os.path.getsize(png) > 0:
            raise AssertionError("no PNG written")
    print(f"  launches={launches}  mean rgb={pixels[..., :3].mean():.4f}")
    if launches != MAIN_FRAMES:
        raise AssertionError(f"expected {MAIN_FRAMES} kernel launches, got {launches}")
    if pixels.shape != (MAIN_H, MAIN_W, 4) or not np.isfinite(pixels).all():
        raise AssertionError("main-path image is not finite or has the wrong shape")
    if not pixels[..., :3].max() > 0.05:
        raise AssertionError("main-path image is black")

    main_scene = make_scene(recursion_depth=MAIN_DEPTH, device=dev)
    key = rng.prng_key(5)
    ms = cuda_ms(lambda: mk.render_frame_megakernel(main_scene, key, MAIN_W, MAIN_H), 20)
    prepared = mk.prepare_launch(main_scene, key, MAIN_W, MAIN_H, 1, VERBATIM)
    launch_ms = cuda_ms(lambda: mk.launch(prepared), 20)
    plain_ms = cuda_ms(lambda: mk.render_frame_reference(main_scene, key, MAIN_W, MAIN_H), 2)
    segs = MAIN_W * MAIN_H * MAIN_DEPTH
    print(f"  wrapper {ms:.3f} ms/frame (kernel launch alone {launch_ms:.3f} ms; before the backend template: "
          f"2.333 and 2.142 ms on an H100 80GB HBM3 at 700 W), plain {plain_ms:.3f} ms/frame ({card})")
    print(f"  ray segments/s: kernel {segs / ms * 1e3:.4e}, plain {segs / plain_ms * 1e3:.4e} ({card})")

    main_segments = count_segments(main_scene, key, MAIN_W, MAIN_H)
    n_sv = prepared.sv.shape[1]
    k1_work = {"analytical": (main_segments * K1_OPS["f32"], main_segments * K1_OPS["f64"]
                              + MAIN_W * MAIN_H * CAMERA_F64_OPS, n_sv * 4 + 16 + MAIN_W * MAIN_H * 16)}
    fwd_bound, fwd_bound_by = bound_of(*k1_work["analytical"])
    print(f"  ray segments {main_segments} ({main_segments / (MAIN_W * MAIN_H):.3f} per pixel); "
          f"bound {fwd_bound:.4f} ms ({fwd_bound_by})")

    print("== 6. backward kernel K2 vs its plain version on the card (depth 4)")
    free_bytes, total_bytes = torch.cuda.mem_get_info(dev)
    bwd_err, peak_320 = check_backward(torch, mk, rng, dev, total_bytes, [
        (scene, 320, 240, 1, VERBATIM, 21, ""), (scene, 320, 240, 2, VERBATIM, 22, ""),
        (scene, 320, 240, 1, FIXED, 23, ""), (scene, MAIN_W, MAIN_H, 1, VERBATIM, 24, ""),
    ])
    print_registers(_build)

    print("== 7. K2 vs the JAX gradient fixture (64x48, depth 4, PRNGKey(3), loss mean(rgb^2))")
    grad_scene = make_scene(device=dev)
    leaves = dict(inverse.named_leaves(grad_scene))
    for name in FIXTURE_LEAVES:
        leaves[name].requires_grad_(True)
    reset_counts(mk)
    img = mk.render_frame_megakernel(grad_scene, rng.prng_key(3), 64, 48)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in FIXTURE_LEAVES])
    counts = read_counts(mk)
    if counts != expect_counts(launches=1, bwd_launches=1):
        raise AssertionError(f"expected 1 K1 launch and 1 K2 call (one record and one adjoint launch), got {counts}")
    with np.load(GRAD_FIXTURE) as want:
        for name, got in zip(FIXTURE_LEAVES, grads):
            got = got.cpu().numpy()
            ok = leaf_close(got, want[name], name)
            print(f"  {name}: K2 {np.array2string(got.ravel(), precision=6)} "
                  f"JAX {np.array2string(want[name].ravel(), precision=6)} {'ok' if ok else 'OUTSIDE'}")
            if not ok:
                raise AssertionError(f"{name}: K2 gradient outside the fixture's tolerance")

    print(f"== 8. trainer: invert CLI, {TRAIN_W}x{TRAIN_H}, depth {MAIN_DEPTH}, {TRAIN_STEPS} steps")
    calls = []  # (K1, K2) launch counts when each render of the trainer starts
    real_render = inverse.render_frame_megakernel

    def counting_render(*args, **kw):
        calls.append((mk.render_frame_megakernel.launches, mk.render_frame_megakernel.bwd_launches,
                      torch.is_grad_enabled()))
        return real_render(*args, **kw)

    inverse.render_frame_megakernel = counting_render
    try:
        with tempfile.TemporaryDirectory() as tmp:
            report_path = os.path.join(tmp, "report.json")
            reset_counts(mk)
            invert_cli.main([
                "--device", "cuda", "--width", str(TRAIN_W), "--height", str(TRAIN_H),
                "--depth", str(MAIN_DEPTH), "--steps", str(TRAIN_STEPS), "--json-out", report_path,
            ], log=lambda s: print("  " + s))
            counts = read_counts(mk)
            train_launches = (counts["launches"], counts["bwd_launches"], counts["record_launches"],
                              counts["adjoint_launches"])
            with open(report_path) as f:
                losses = json.load(f)["losses"]
    finally:
        inverse.render_frame_megakernel = real_render
    print(f"  launches K1={train_launches[0]} K2={train_launches[1]} (record kernel {train_launches[2]}, adjoint "
          f"kernel {train_launches[3]}); losses "
          f"{losses[0]:.6e} -> {losses[-1]:.6e}")
    step_starts = [c[:2] for c in calls if c[2]]  # the render with grad opens each step
    want_starts = [(4 + 2 * i, i) for i in range(TRAIN_STEPS)]
    if counts != expect_counts(launches=4 + 2 * TRAIN_STEPS, bwd_launches=TRAIN_STEPS) or step_starts != want_starts:
        raise AssertionError(f"a step is not 2 K1 + 1 K2 launches of the analytical backend: {calls} -> {counts}")
    if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"trainer losses not finite or not falling: {losses}")
    runs = {kern: inverse.recover_demo(key=rng.prng_key(0), width=64, height=48, steps=3, kernel=kern,
                                       device=dev, verbose=False).losses.numpy() for kern in inverse.KERNELS}
    rel = np.abs(runs["megakernel"] / runs["eager"] - 1.0).max()
    print(f"  64x48 losses: kernels {runs['megakernel']}, eager {runs['eager']}, max rel {rel:.3e}")
    if not rel <= 1e-2:
        raise AssertionError("kernel path's losses differ from the eager path's")

    print(f"== 9. times: one training step at {MAIN_W}x{MAIN_H}, depth {MAIN_DEPTH}, spp 1")
    true_scene, start_scene = inverse.demo_scenes(MAIN_DEPTH, dev)
    step_key = rng.prng_key(7)

    def trainer(kern, true_scene, start_scene, family):
        """One recover_demo step of `family` at 1080p as a call."""
        render = inverse.make_renderer(kern, MAIN_W, MAIN_H, 1, VERBATIM)
        with torch.no_grad():
            target = render(true_scene, rng.prng_key(8))
        train, rebuild, _ = inverse.select_leaves(start_scene, inverse.DEMO_SELECTS[family])
        opt = inverse.make_adam(train, 3e-2)
        return lambda: inverse.paired_step(train, rebuild, inverse.PROJECTIONS[family], opt, render, target,
                                           step_key)

    step_ms = cuda_ms(trainer("megakernel", true_scene, start_scene, "analytical"), 10, warmup=2)
    bwd_launch = mk.prepare_launch(main_scene, key, MAIN_W, MAIN_H, 1, VERBATIM)
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((MAIN_H, MAIN_W, 4)).astype(np.float32)).to(dev)
    bwd_ms = cuda_ms(lambda: mk.launch_backward(bwd_launch, ct), 10)
    bwd_split = k2_stages(mk, _build, cuda_ms, bwd_launch, ct, card, f"K2 at {MAIN_W}x{MAIN_H}")
    need = peak_320 * (MAIN_W * MAIN_H) / (320 * 240)
    if need > 0.6 * total_bytes:
        raise AssertionError(f"the plain version needs ~{need / 2**30:.1f} GiB at {MAIN_W}x{MAIN_H}")
    plain_bwd_ms = cuda_ms(lambda: mk.render_grad_reference(
        bwd_launch.sv, main_scene, key, ct, MAIN_W, MAIN_H), 2)
    plain_step_ms = cuda_ms(trainer("eager", true_scene, start_scene, "analytical"), 2)
    bwd_bound, bwd_bound_by = bound(main_segments, MAIN_W * MAIN_H, n_sv * 8 + 16 + MAIN_W * MAIN_H * 16, K2_OPS)
    print(f"  training step: kernels {step_ms:.3f} ms, plain {plain_step_ms:.3f} ms ({card})")
    print(f"  K2 launch alone {bwd_ms:.3f} ms, plain gradient (eager forward + autograd) {plain_bwd_ms:.3f} ms, "
          f"bound {bwd_bound:.4f} ms ({bwd_bound_by}) ({card})")

    print("== 10. K1 with the SDF backend (K5) vs its plain version on the card (depth 4)")
    sdf_scene = make_sdf_scene(device=dev)
    sdf_err = 0.0
    for w, h, spp, quirks, seed in ((320, 240, 1, VERBATIM, 31), (320, 240, 2, VERBATIM, 32),
                                    (320, 240, 1, FIXED, 33), (MAIN_W, MAIN_H, 1, VERBATIM, 34)):
        label = f"{w}x{h} spp{spp} {'VERBATIM' if quirks == VERBATIM else 'FIXED'}"
        key = rng.prng_key(seed)
        img = mk.render_frame_megakernel(sdf_scene, key, w, h, spp, quirks)
        ref = mk.render_frame_reference(sdf_scene, key, w, h, spp, quirks)
        torch.cuda.synchronize()
        d = image_diff(img.cpu(), ref.cpu())
        sdf_err = max(sdf_err, d["max"])
        check_diff(label, d)
    smooth_scene = make_sdf_scene(device=dev)
    smooth_scene.params.smooth_k = torch.tensor(SMOOTH_K, device=dev)
    key = rng.prng_key(35)
    d = image_diff(mk.render_frame_megakernel(smooth_scene, key, 320, 240).cpu(),
                   mk.render_frame_reference(smooth_scene, key, 320, 240).cpu())
    sdf_err = max(sdf_err, d["max"])
    check_diff(f"320x240 spp1 VERBATIM, smooth union k={SMOOTH_K}", d)
    img = mk.render_frame_megakernel(sdf_scene, rng.prng_key(3), 64, 48)
    check_diff("vs JAX (64x48, depth 4, PRNGKey(3))", image_diff(img.cpu(), np.load(SDF_FIXTURE)))

    print(f"== 11. SDF main path: CLI --scene sdf, {MAIN_W}x{MAIN_H}, depth {MAIN_DEPTH}, {MAIN_FRAMES} frames")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "sdf.png")
        cfg, _ = cli.parse_args([
            "--scene", "sdf", "--device", "cuda", "--width", str(MAIN_W), "--height", str(MAIN_H),
            "--depth", str(MAIN_DEPTH), "--spp", "1", "--frames", str(MAIN_FRAMES), "-o", png,
        ])
        reset_counts(mk)
        buf = cli.render(cfg, png, log=lambda s: print("  " + s))
        sdf_counts = (mk.render_frame_megakernel.launches, mk.render_frame_megakernel.sdf_launches,
                      sum(v for k, v in read_counts(mk).items() if k not in ("launches", "sdf_launches")))
        pixels = buf.pixels.cpu().numpy()
        if not os.path.getsize(png) > 0:
            raise AssertionError("no PNG written")
    print(f"  launches K1={sdf_counts[0]} (SDF backend {sdf_counts[1]}), K2 or other backends {sdf_counts[2]}  "
          f"mean rgb={pixels[..., :3].mean():.4f}")
    if sdf_counts != (MAIN_FRAMES, MAIN_FRAMES, 0):
        raise AssertionError(f"expected {MAIN_FRAMES} launches of K1 with the SDF backend and nothing else")
    if pixels.shape != (MAIN_H, MAIN_W, 4) or not np.isfinite(pixels).all():
        raise AssertionError("SDF main-path image is not finite or has the wrong shape")
    if not pixels[..., :3].max() > 0.05:
        raise AssertionError("SDF main-path image is black")
    main_sdf = make_sdf_scene(recursion_depth=MAIN_DEPTH, device=dev)
    key = rng.prng_key(5)
    sdf_ms = cuda_ms(lambda: mk.render_frame_megakernel(main_sdf, key, MAIN_W, MAIN_H), 20)
    sdf_prepared = mk.prepare_launch(main_sdf, key, MAIN_W, MAIN_H, 1, VERBATIM)
    sdf_launch_ms = cuda_ms(lambda: mk.launch(sdf_prepared), 20)
    sdf_plain_ms = cuda_ms(lambda: mk.render_frame_reference(main_sdf, key, MAIN_W, MAIN_H), 1, warmup=0)
    sdf_segments = count_segments(main_sdf, key, MAIN_W, MAIN_H)
    print(f"  wrapper {sdf_ms:.3f} ms/frame (kernel launch alone {sdf_launch_ms:.3f} ms), "
          f"plain {sdf_plain_ms:.3f} ms/frame ({card})")
    print(f"  ray segments {sdf_segments} ({sdf_segments / (MAIN_W * MAIN_H):.3f} per pixel); ray segments/s: "
          f"kernel {sdf_segments / sdf_ms * 1e3:.4e}, plain {sdf_segments / sdf_plain_ms * 1e3:.4e} ({card})")
    print(f"  K1 analytical launch {launch_ms:.3f} ms in this run (phase 5); 2.142 ms before the backend template "
          "(H100 80GB HBM3, 700 W)")

    print("== 12. march-step counter K6 vs its plain version on the card (center rays)")
    k6_err = 0
    for w, h in ((320, 240), (MAIN_W, MAIN_H)):
        mks.measure_march_steps.launches = 0
        got = mks.measure_march_steps(main_sdf, w, h)
        torch.cuda.synchronize()
        k6_launches = mks.measure_march_steps.launches
        ref = mks.march_steps_reference(main_sdf, w, h)
        for name, r in zip(("steps", "shadow_steps"), ref):
            diff = (got[name] - r).abs()
            same = float((diff == 0).double().mean())
            k6_err = max(k6_err, int(diff.max()))
            pre = "shadow_" if name == "shadow_steps" else ""
            print(f"  {w}x{h} {name}: equal on {same:.6f} of pixels, max |diff| {int(diff.max())}; per pixel mean "
                  f"{got[pre + 'mean_steps']:.4f} max {got[pre + 'max_steps']}; per warp (max of 32) mean "
                  f"{got[pre + 'warp_mean_steps']:.4f} max {got[pre + 'warp_max_steps']}")
            if same < SDF_Q_MIN:
                raise AssertionError(f"K6 {w}x{h} {name}: equal on {same} of pixels, below {SDF_Q_MIN}")
        if k6_launches != 1:
            raise AssertionError(f"measure_march_steps launched K6 {k6_launches} times, not once")
    k6_ms = cuda_ms(lambda: mks.measure_march_steps(main_sdf, MAIN_W, MAIN_H), 20)
    k6_launch_ms = cuda_ms(lambda: mks.launch_march_steps(main_sdf, MAIN_W, MAIN_H), 20)
    k6_plain_ms = cuda_ms(lambda: mks.march_steps_reference(main_sdf, MAIN_W, MAIN_H), 2)
    sdf_work_counts = count_sdf_work(main_sdf, key, MAIN_W, MAIN_H)
    pix = MAIN_W * MAIN_H
    k6_trips = int(got["steps"].sum()) + int(got["shadow_steps"].sum())
    k6_warp_trips = 32 * (int(got["warp_steps"].sum()) + int(got["shadow_warp_steps"].sum()))
    # every march of the frame (tools/work.count_sdf_work): the lanes' steps
    # give the bound, the warps' slowest lanes what the card issues
    trips = sdf_work_counts["closest_trips"] + sdf_work_counts["shadow_trips"]
    warp_trips = sdf_work_counts["closest_warp_trips"] + sdf_work_counts["shadow_warp_trips"]
    sdf_n_sv = sdf_prepared.sv.shape[1]
    sdf_bytes = sdf_n_sv * 4 + 16 + pix * 16

    def sdf_work(march_trips):
        return (march_trips * SDF_STEP_OPS + sdf_segments * SDF_SEGMENT_OPS["f32"],
                sdf_segments * SDF_SEGMENT_OPS["f64"] + pix * CAMERA_F64_OPS, sdf_bytes)

    k1_work["sdf"] = sdf_work(trips)
    sdf_bound_ms, sdf_bound_by = bound_of(*k1_work["sdf"])
    sdf_warp_bound_ms, _ = bound_of(*sdf_work(warp_trips))
    k6_bound_ms, k6_bound_by = bound_of(k6_trips * SDF_STEP_OPS + pix * K6_PIXEL_OPS["f32"], pix * CAMERA_F64_OPS,
                                        sdf_n_sv * 4 + pix * 8)
    print(f"  K6 wrapper {k6_ms:.3f} ms (pack and launch alone {k6_launch_ms:.3f} ms), plain {k6_plain_ms:.3f} ms, "
          f"bound {k6_bound_ms:.4f} ms ({k6_bound_by}) ({card})")
    print(f"  K6's 1080p march trips (center rays: primary + shadow of the first segment): {k6_trips} summed over the "
          f"pixels, {k6_warp_trips} as the warps issue them ({k6_warp_trips / k6_trips:.3f}x)")
    print(f"  every march of the 1080p frame (tools/work.count_sdf_work, {sdf_work_counts['segments']} segments, "
          f"{sdf_work_counts['shadow_rays']} shadow rays): closest hits {sdf_work_counts['closest_trips']} steps, "
          f"shadow rays {sdf_work_counts['shadow_trips']}, {trips} in all ({trips / pix:.3f} a pixel); as the warps "
          f"issue them {sdf_work_counts['closest_warp_trips']} + {sdf_work_counts['shadow_warp_trips']} = {warp_trips} "
          f"lane slots ({warp_trips / trips:.3f}x); the longest march {sdf_work_counts['max_trips']} steps")
    print(f"  SDF frame bound {sdf_bound_ms:.4f} ms ({sdf_bound_by}) from the lanes' steps; from the warps' "
          f"{sdf_warp_bound_ms:.4f} ms, beside it, not the bound ({card})")


    print("== 13. K2 with the SDF backend vs its plain version on the card (depth 4)")
    smooth_bwd = make_sdf_scene(device=dev)
    smooth_bwd.params.smooth_k = torch.tensor(SMOOTH_K, device=dev)
    sdf_bwd_err, sdf_peak_320 = check_backward(torch, mk, rng, dev, total_bytes, [
        (sdf_scene, 320, 240, 1, VERBATIM, 41, ""), (sdf_scene, 320, 240, 2, VERBATIM, 42, ""),
        (sdf_scene, 320, 240, 1, FIXED, 43, ""), (smooth_bwd, 320, 240, 1, VERBATIM, 44, f", smooth_k {SMOOTH_K}"),
        (sdf_scene, MAIN_W, MAIN_H, 1, VERBATIM, 45, ""),
    ], moved=sdf_grazing)

    print("== 14. K2-SDF vs the JAX gradient fixtures, through the autograd Function and pack_sdf_scene")
    for fixture, (w, h, depth), close in ((SDF_GRAD_FIXTURE, (64, 48, 4), leaf_close),
                                          (SDF_GRAD_FIXTURE_SMALL, (32, 16, 2), small_sdf_close)):
        with np.load(fixture) as data:
            names = sorted(data.files)
        grad_scene = make_sdf_scene(recursion_depth=depth, device=dev)
        leaves = dict(inverse.named_leaves(grad_scene))
        for name in names:
            leaves[name].requires_grad_(True)
        reset_counts(mk)
        img = mk.render_frame_megakernel(grad_scene, rng.prng_key(3), w, h)
        grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in names], allow_unused=True)
        counts = read_counts(mk)
        print(f"  {os.path.basename(fixture)} ({w}x{h}, depth {depth}): K1-SDF {counts['sdf_launches']}, "
              f"K2-SDF {counts['sdf_bwd_launches']} calls, record and adjoint kernels {stage_counts(counts)} launches")
        if counts != expect_counts(launches=1, sdf_launches=1, bwd_launches=1, sdf_bwd_launches=1):
            raise AssertionError(f"expected 1 K1 and 1 K2 launch with the SDF backend, got {counts}")
        check_leaf_grads({n: np.zeros(tuple(leaves[n].shape)) if g is None else g.cpu().numpy()
                          for n, g in zip(names, grads)}, fixture, close)

    print(f"== 15. SDF trainer: invert CLI --scene sdf, {TRAIN_W}x{TRAIN_H}, depth {MAIN_DEPTH}, {TRAIN_STEPS} steps")
    calls = []
    inverse.render_frame_megakernel = counting_render
    try:
        with tempfile.TemporaryDirectory() as tmp:
            report_path = os.path.join(tmp, "report.json")
            reset_counts(mk)
            invert_cli.main([
                "--scene", "sdf", "--device", "cuda", "--width", str(TRAIN_W), "--height", str(TRAIN_H),
                "--depth", str(MAIN_DEPTH), "--steps", str(TRAIN_STEPS), "--json-out", report_path,
            ], log=lambda s: print("  " + s))
            counts = read_counts(mk)
            sdf_train = (counts["launches"], counts["bwd_launches"], counts["sdf_launches"],
                         counts["sdf_bwd_launches"], stage_counts(counts))
            with open(report_path) as f:
                report = json.load(f)
    finally:
        inverse.render_frame_megakernel = real_render
    losses = report["losses"]
    print(f"  launches K1={sdf_train[0]} (SDF {sdf_train[2]}) K2={sdf_train[1]} (SDF {sdf_train[3]}; record and "
          f"adjoint kernels {sdf_train[4]}); losses {losses[0]:.6e} -> {losses[-1]:.6e}")
    for r in report["rows"]:
        print(f"  {r['name']}: true {r['true_value']:.4f} start {r['start_value']:.4f} "
              f"recovered {r['recovered']:.4f}")
    step_starts = [c[:2] for c in calls if c[2]]
    want = expect_counts(launches=4 + 2 * TRAIN_STEPS, sdf_launches=4 + 2 * TRAIN_STEPS, bwd_launches=TRAIN_STEPS,
                         sdf_bwd_launches=TRAIN_STEPS)
    if counts != want or step_starts != want_starts:
        raise AssertionError(f"an SDF step is not 2 K1-SDF + 1 K2-SDF launches: {calls} -> {counts}")
    if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"SDF trainer losses not finite or not falling: {losses}")
    runs = {kern: inverse.recover_demo(key=rng.prng_key(0), scene="sdf", width=64, height=48, steps=3, kernel=kern,
                                       device=dev, verbose=False) for kern in inverse.KERNELS}
    got, want = runs["megakernel"], runs["eager"]
    loss_rel = np.abs(got.losses.numpy() / want.losses.numpy() - 1.0).max()
    leaf_rel = [abs(a.recovered / b.recovered - 1.0) for a, b in zip(got.rows, want.rows)]
    print(f"  64x48 losses: kernels {got.losses.numpy()}, eager {want.losses.numpy()}; max rel {loss_rel:.3e} "
          f"(tolerance {SDF_TRAIN_LOSS_RTOL})")
    print("  leaves after step 3, rel: " + ", ".join(f"{r.name} {x:.3e}" for r, x in zip(want.rows, leaf_rel))
          + f" (tolerance {SDF_TRAIN_LEAF_RTOL})")
    if not (loss_rel <= SDF_TRAIN_LOSS_RTOL and max(leaf_rel) <= SDF_TRAIN_LEAF_RTOL):
        raise AssertionError("the SDF kernel path's losses or leaves differ from the eager path's")

    print(f"== 16. times: one SDF training step at {MAIN_W}x{MAIN_H}, depth {MAIN_DEPTH}, spp 1")
    sdf_true, sdf_start = inverse.demo_scenes(MAIN_DEPTH, dev, "sdf")
    sdf_step_ms = cuda_ms(trainer("megakernel", sdf_true, sdf_start, "sdf"), 10, warmup=2)
    sdf_bwd_launch = mk.prepare_launch(main_sdf, key, MAIN_W, MAIN_H, 1, VERBATIM)
    sdf_bwd_ms = cuda_ms(lambda: mk.launch_backward(sdf_bwd_launch, ct), 10)
    sdf_split = k2_stages(mk, _build, cuda_ms, sdf_bwd_launch, ct, card, f"K2-SDF at {MAIN_W}x{MAIN_H}")
    need = sdf_peak_320 * (MAIN_W * MAIN_H) / (320 * 240)
    if need > 0.6 * total_bytes:
        raise AssertionError(f"the plain SDF gradient needs ~{need / 2**30:.1f} GiB at {MAIN_W}x{MAIN_H}")
    sdf_plain_bwd_ms = cuda_ms(lambda: mk.render_grad_reference(
        sdf_bwd_launch.sv, main_sdf, key, ct, MAIN_W, MAIN_H), 1, warmup=0)
    sdf_plain_step_ms = cuda_ms(trainer("eager", sdf_true, sdf_start, "sdf"), 1, warmup=0)
    # K2-SDF's work: the march, and per segment the SDF forward, K2's
    # adjoint of the shading and the SDF adjoint of the hit (SDF_ADJ_OPS)
    sdf_bwd_bound_ms, sdf_bwd_bound_by = bound_of(
        trips * SDF_STEP_OPS
        + sdf_segments * (SDF_SEGMENT_OPS["f32"] + K2_ADJ_OPS["f32"] - ANALYTICAL_HIT_ADJ_F32 + SDF_ADJ_OPS),
        sdf_segments * SDF_SEGMENT_OPS["f64"] + pix * CAMERA_F64_OPS, sdf_n_sv * 8 + 16 + pix * 16)
    print(f"  SDF training step: kernels {sdf_step_ms:.3f} ms, plain {sdf_plain_step_ms:.3f} ms ({card})")
    print(f"  K2-SDF launch alone {sdf_bwd_ms:.3f} ms, plain gradient (eager forward + autograd) "
          f"{sdf_plain_bwd_ms:.3f} ms, bound {sdf_bwd_bound_ms:.4f} ms ({sdf_bwd_bound_by}) ({card})")
    print(f"  analytical K2 launch {bwd_ms:.3f} ms in this run (phase 9); against another tree's: phase 24")

    mesh_rows = []
    for family, first in (("mesh", 17), ("bigmesh", 19)):
        row, k1_work[family] = mesh_phases(torch, mk, cli, rng, cuda_ms, dev, card, family, first)
        mesh_rows.append(row)
    mesh_bwd_row = mesh_backward_phases(torch, mk, inverse, rng, cuda_ms, dev, card, total_bytes, trainer_pieces=(
        counting_render, real_render, calls), other=args.other)
    t25 = time.perf_counter()
    occupancy_rows = occupancy_phase(torch, mk, cli, rng, cuda_ms, dev, card, k1_work)
    t26 = time.perf_counter()
    stream_row = uniform_stream_phase(torch, mk, cuda_ms, dev, card)
    t27 = time.perf_counter()
    media_rows = media_phases(torch, mk, _build, rng, cuda_ms, dev, card, args.other)
    t30 = time.perf_counter()
    media_bwd_rows = media_backward_phases(torch, mk, _build, inverse, rng, cuda_ms, dev, card, total_bytes,
                                           (counting_render, real_render, calls), args.other)
    t34 = time.perf_counter()
    deep_phase(torch, mk, rng, dev, total_bytes)
    t35 = time.perf_counter()
    step_pair_phase(torch, inverse, rng, dev, card, args.other)

    kernels = [dict(
        name="megakernel_fwd", route="cuda", source="pathtracer_tpu_torch/csrc/megakernel_fwd.cu",
        replaces="pathtracer_tpu/ops/megakernel.py:1605", launches=launches,
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=fwd_bound, bound_by=fwd_bound_by,
        library_ms=None,
    ), dict(
        name="megakernel_bwd", route="cuda", source="pathtracer_tpu_torch/csrc/megakernel_bwd.cu",
        replaces="pathtracer_tpu/ops/megakernel.py:1771", launches=train_launches[1],
        max_abs_err=bwd_err, ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bwd_bound, bound_by=bwd_bound_by,
        library_ms=None, stages=stage_rows(bwd_split, train_launches[2:]),
    ), dict(
        name="megakernel_fwd_sdf", route="cuda", source="pathtracer_tpu_torch/csrc/sdf.cuh",
        replaces="pathtracer_tpu/ops/megakernel_sdf.py:172", launches=sdf_counts[1],
        max_abs_err=sdf_err, ms=sdf_ms, plain_ms=sdf_plain_ms, bound_ms=sdf_bound_ms, bound_by=sdf_bound_by,
        library_ms=None,
    ), dict(
        name="megakernel_bwd_sdf", route="cuda", source="pathtracer_tpu_torch/csrc/sdf_adj.cuh",
        replaces="pathtracer_tpu/ops/megakernel_sdf.py:172", launches=sdf_train[3],
        max_abs_err=sdf_bwd_err, ms=sdf_bwd_ms, plain_ms=sdf_plain_bwd_ms, bound_ms=sdf_bwd_bound_ms,
        bound_by=sdf_bwd_bound_by, library_ms=None, stages=stage_rows(sdf_split, sdf_train[4]),
    ), dict(
        name="march_steps", route="cuda", source="pathtracer_tpu_torch/csrc/megakernel_sdf.cu",
        replaces="pathtracer_tpu/ops/megakernel_sdf.py:395", launches=k6_launches,
        max_abs_err=float(k6_err), ms=k6_ms, plain_ms=k6_plain_ms, bound_ms=k6_bound_ms, bound_by=k6_bound_by,
        library_ms=None,
    ), *mesh_rows, mesh_bwd_row, *occupancy_rows, stream_row, *media_rows, *media_bwd_rows]
    print(f"== total {time.perf_counter() - started:.1f} s (phase 25 {t26 - t25:.1f} s, phase 26 {t27 - t26:.1f} s, "
          f"phases 27-29 {t30 - t27:.1f} s, phases 30-33 {t34 - t30:.1f} s, phase 34 {t35 - t34:.1f} s)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
