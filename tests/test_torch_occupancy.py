"""Occupancy: the eager probe `integrator/tracer.measure_occupancy`, the
plain version of the occupancy kernel K3 (`tracer.bounces_entered`, the
bounces each sample's path entered alive) and the wrapper
`ops/megakernel.measure_occupancy_megakernel`, held to the JAX package.

The JAX side is committed, for each family at 128x32, depth 3,
PRNGKey(4): `tests/golden_torch/occupancy_<family>_128x32_d3_k4.npz` holds
JAX's XLA probe at spp 1 and 2 (`probe_spp1`, `probe_spp2`) and its
Pallas K3 in interpret mode with "hbm" uniforms at tile_rows 8
(`<tiling>_spp<n>_counts` [tiles, depth], the lanes of each tile alive
entering each bounce, and `<tiling>_spp<n>_fraction`) for flat tiles at
spp 1 and 2 and block tiles at spp 1. Regenerate them with
`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_occupancy.py`
(about two minutes); their guard is marked `slow`.

Checks: the port's probe equals JAX's to 1e-6 (the same lanes die);
the plain per-lane counts, reduced to JAX's flat and block tiles in JAX's
lane order (ray pixel * spp + sample), equal K3's counts tile for tile;
the host build of `trace_sample` (g++, as tests/test_torch_kernel_host.py
builds it) counts the bounces each lane entered as the plain version does,
lane for lane, on every backend, and leaves the frame K1's bit for bit.
The card's K3 is in tests/test_torch_kernel_cuda.py and chip_smoke.py
phase 25. Budget: ~60 s for the module on one torch thread.
"""

import functools
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.app import render as cli
from pathtracer_tpu_torch.integrator import tracer as T
from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models import families
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import _build, rng
from test_torch_kernel_host import MESH_VIEW, PRELUDE, build_shim, launch_keys, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H, DEPTH, KEY_SEED, TILE_ROWS, LANES = 128, 32, 3, 4, 8, 128
FAMILIES = ("analytical", "sdf", "mesh", "bigmesh")
CONFIGS = (("flat", 1), ("flat", 2), ("block", 1))


def fixture_path(family: str) -> str:
    name = f"occupancy_{family}_{W}x{H}_d{DEPTH}_k{KEY_SEED}.npz"
    return os.path.join(os.path.dirname(__file__), "golden_torch", name)


@functools.lru_cache(maxsize=None)
def fixture(family: str) -> dict:
    with np.load(fixture_path(family)) as data:
        return {k: data[k] for k in data.files}


def jax_occupancy(family: str) -> dict:
    """The fixture's arrays as the JAX package computes them today."""
    import jax
    import jax.numpy as jnp

    import pathtracer_tpu as pt
    from pathtracer_tpu.integrator.tracer import measure_occupancy
    from pathtracer_tpu.models import bigmesh, mesh, sdf
    from pathtracer_tpu.ops.megakernel import measure_occupancy_pallas

    make = {"analytical": pt.make_analytical_scene, "sdf": sdf.make_scene, "mesh": mesh.make_scene,
            "bigmesh": bigmesh.make_scene}[family]
    scene = make(dtype=jnp.float32, recursion_depth=DEPTH)
    key = jax.random.PRNGKey(KEY_SEED)
    out = {f"probe_spp{spp}": np.asarray(measure_occupancy(scene, key, W, H, spp=spp)) for spp in (1, 2)}
    for tiling, spp in CONFIGS:
        stats = measure_occupancy_pallas(scene, key, W, H, spp=spp, tile_rows=TILE_ROWS, uniforms="hbm",
                                         interpret=True, tiling=tiling)
        out[f"{tiling}_spp{spp}_counts"] = np.asarray(stats["counts"])
        out[f"{tiling}_spp{spp}_fraction"] = np.asarray(stats["alive_fraction"])
    return out


def scene_of(family: str):
    return families.make_family_scene(family, recursion_depth=DEPTH)


@functools.lru_cache(maxsize=None)
def plain_counts(family: str, spp: int) -> torch.Tensor:
    return T.bounces_entered(scene_of(family), rng.prng_key(KEY_SEED), W, H, spp)


def block_lane_to_ray(width: int, height: int, tile_rows: int, spp: int) -> np.ndarray:
    """JAX's block tiling (tile_rows x 128 lanes, a pixel's samples in
    adjacent lanes, edge lanes clamped to the border): the ray index
    pixel * spp + sample of each lane, tile-major."""
    bw = LANES // spp
    nbx, nby = -(-width // bw), -(-height // tile_rows)
    t = np.arange(nbx * nby)
    by, bx = t // nbx, t % nbx
    rows, cols = np.arange(tile_rows), np.arange(LANES)
    py = np.minimum(by[:, None, None] * tile_rows + rows[None, :, None] + 0 * cols[None, None, :], height - 1)
    px = np.minimum(bx[:, None, None] * bw + (cols // spp)[None, None, :] + 0 * rows[None, :, None], width - 1)
    return ((py * width + px) * spp + (cols % spp)[None, None, :]).reshape(-1)


def jax_tiles(entered: torch.Tensor, tiling: str, depth: int) -> np.ndarray:
    """Per-lane counts [spp, H, W] -> JAX K3's counts [tiles, depth]: the
    lanes of each tile alive entering each bounce."""
    spp, h, w = entered.shape
    rays = entered.permute(1, 2, 0).reshape(-1).numpy()  # ray = pixel * spp + sample
    tile = TILE_ROWS * LANES
    if tiling == "flat":
        lanes = np.pad(rays, (0, -rays.size % tile)).reshape(-1, tile)
    else:
        lanes = rays[block_lane_to_ray(w, h, TILE_ROWS, spp)].reshape(-1, tile)
    return np.stack([(lanes > b).sum(axis=1) for b in range(depth)], axis=1)


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_probe_matches_jax(family, spp):
    got = T.measure_occupancy(scene_of(family), rng.prng_key(KEY_SEED), W, H, spp)
    want = fixture(family)[f"probe_spp{spp}"]
    assert got.shape == (DEPTH,) and float(got[0]) == 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tiling,spp", CONFIGS, ids=[f"{t}_spp{s}" for t, s in CONFIGS])
@pytest.mark.parametrize("family", FAMILIES)
def test_plain_counts_match_jax_kernel_tiles(family, tiling, spp):
    entered = plain_counts(family, spp)
    assert entered.shape == (spp, H, W) and entered.dtype == torch.int32
    assert 1 <= int(entered.min()) and int(entered.max()) <= DEPTH
    want = fixture(family)[f"{tiling}_spp{spp}_counts"]
    np.testing.assert_array_equal(jax_tiles(entered, tiling, DEPTH), want)
    frac = np.stack([(entered > b).double().mean().item() for b in range(DEPTH)])
    np.testing.assert_allclose(frac, fixture(family)[f"{tiling}_spp{spp}_fraction"], rtol=0, atol=1e-6)


def test_plain_counts_at_spp1_are_the_probe():
    scene = scene_of("analytical")
    entered = T.bounces_entered(scene, rng.prng_key(9), 24, 16, 1, FIXED)
    probe = T.measure_occupancy(scene, rng.prng_key(9), 24, 16, 1, FIXED)
    frac = torch.stack([(entered > b).double().mean() for b in range(DEPTH)])
    torch.testing.assert_close(frac, probe, rtol=0, atol=0)


# K1's and K3's per-thread code on the host: one entry per backend with the
# arguments of its K3 entry point (csrc/megakernel_fwd.cu) but the stream; a
# null `entered` runs K1's instantiation.
SHIM = PRELUDE + r"""
#include "analytical.cuh"
#include "bigmesh.cuh"
#include "mesh.cuh"
#include "sdf.cuh"
#include "tracer.cuh"
""" + MESH_VIEW + r"""

template <class B>
static void frame(const pt::SceneView& s, const uint32_t* keys, float* out, int* entered, int width, int height,
                  int spp, int depth, int flags) {
  const int n = width * height;
  for (int p = 0; p < n; ++p) {
    pt::V3 sum = pt::splat3(0.0f);
    for (int k = 0; k < spp; ++k) {
      const uint32_t* kk = keys + 4 * k;
      pt::V3 r;
      if (entered != nullptr) {
        int e = 0;
        r = pt::trace_sample<B, true>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3], &e);
        entered[k * n + p] = e;
      } else {
        r = pt::trace_sample<B>(s, p, n, width, height, depth, flags, kk[0], kk[1], kk[2], kk[3]);
      }
      sum = k == 0 ? r : sum + r;
    }
    if (spp > 1) sum = sum / (float)spp;
    out[4 * p + 0] = sum.x;
    out[4 * p + 1] = sum.y;
    out[4 * p + 2] = sum.z;
    out[4 * p + 3] = 1.0f;
  }
}

#define HEAD const float* sv, int n_sv, const uint32_t* keys, float* out, int* entered, int width, int height, \
             int spp, int depth, int n_lights, int n_materials, int flags
#define RUN(B, view) frame<B>(view, keys, out, entered, width, height, spp, depth, flags)

extern "C" void host_analytical(HEAD) {
  RUN(pt::Analytical, pt::analytical_view(sv, n_lights, n_materials, (flags & pt::FLAG_RESPECT_MAX_DIST) != 0));
}
extern "C" void host_sdf(HEAD, int n_spheres, int n_boxes, int n_tori) {
  WITH_SDF_COUNTS(n_spheres, n_boxes, n_tori, RUN(pt::Sdf<C>, pt::sdf_view(sv, n_lights, n_materials, n_spheres, n_boxes, n_tori)));
}
extern "C" void host_mesh(HEAD, const int* topo, int n_tris, int n_verts) {
  RUN(pt::Mesh, host_mesh_view(sv, n_lights, n_materials, topo, n_tris, n_verts));
}
extern "C" void host_bigmesh(HEAD, const float* coef, const float* attr, const float* aabb, int n_chunks) {
  RUN(pt::BigMesh, pt::bigmesh_view(sv, n_lights, n_materials, coef, attr, aabb, n_chunks));
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory.mktemp("occupancy_host"), SHIM)
    for family in FAMILIES:
        library = {"sdf": "megakernel_sdf", "mesh": "megakernel_mesh"}.get(family, "megakernel_fwd")
        argtypes, _ = _build.SIGNATURES[library][MK.BACKENDS[family].occupancy]
        getattr(lib, f"host_{family}").argtypes = argtypes[:-3]  # no pixel range, no stream
    return lib


def host_run(lib, scene, key, w, h, spp, quirks, count: bool):
    """What measure_occupancy_megakernel hands K3 (K1 without `count`), run
    on the host: (frame [H, W, 4], entered [spp, H, W] or None)."""
    family = families.family_of(scene)
    b = MK.BACKENDS[family]
    # held: the library reads their memory
    sv, keys, extras = b.pack(scene, w, h).contiguous(), launch_keys(key, spp), b.extras(scene)
    out = torch.empty((h, w, 4), dtype=torch.float32)
    entered = torch.zeros((spp, h, w), dtype=torch.int32) if count else None
    getattr(lib, f"host_{family}")(
        sv.data_ptr(), sv.shape[1], keys.data_ptr(), out.data_ptr(), entered.data_ptr() if count else None, w, h,
        spp, scene.recursion_depth, scene.num_lights, int(scene.params.materials.roughness.shape[0]),
        MK.kernel_flags(scene, quirks), *(t.data_ptr() for t in extras), *b.counts(scene))
    return out, entered


HOST_CASES = {"spp1": (1, VERBATIM, 31), "spp2": (2, VERBATIM, 32), "fixed": (1, FIXED, 33)}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
@pytest.mark.parametrize("family", FAMILIES)
def test_host_trace_sample_counts_match_plain_version(host_lib, family, case):
    """K3's per-thread code counts, lane for lane, the bounces the plain
    version's paths entered, and renders K1's frame bit for bit."""
    spp, quirks, seed = HOST_CASES[case]
    scene, key = families.make_family_scene(family, recursion_depth=4), rng.prng_key(seed)
    img, entered = host_run(host_lib, scene, key, 48, 32, spp, quirks, count=True)
    k1_img, _ = host_run(host_lib, scene, key, 48, 32, spp, quirks, count=False)
    assert torch.equal(img, k1_img)
    want = T.bounces_entered(scene, key, 48, 32, spp, quirks)
    assert int(want.max()) == 4 and int(want.min()) >= 1
    assert torch.equal(entered, want), f"{int((entered != want).sum())} lanes differ"


def test_wrapper_on_the_cpu_is_the_plain_version():
    """measure_occupancy_megakernel on a CPU scene: no launch, the plain
    counts, and JAX's keys with the launch's blocks as tiles and its
    warps' numbers beside."""
    scene = scene_of("sdf")
    launches = MK.measure_occupancy_megakernel.launches
    got = MK.measure_occupancy_megakernel(scene, rng.prng_key(KEY_SEED), W, H, 2)
    assert MK.measure_occupancy_megakernel.launches == launches
    entered = plain_counts("sdf", 2)
    assert torch.equal(got["entered"], entered)
    assert got["tile"] == 256 and got["num_tiles"] == W * H // 128 and got["tiling"] == "flat"
    np.testing.assert_array_equal(got["counts"].numpy(), [
        [int((entered.reshape(2, -1)[:, t * 128:(t + 1) * 128] > b).sum()) for b in range(DEPTH)]
        for t in range(W * H // 128)])
    np.testing.assert_array_equal(got["block_alive_fraction"].numpy(), (got["counts"] > 0).double().mean(0).numpy())
    frac = got["alive_fraction"].numpy()
    np.testing.assert_allclose(frac, fixture("sdf")["flat_spp2_fraction"], rtol=0, atol=1e-6)
    assert got["wasted_fraction"] == pytest.approx(1.0 - frac.mean())
    assert got["compacted_wasted_fraction"] is None  # no kernel ran: no tile
    warps = entered.reshape(2, -1, 32)
    for b in range(DEPTH):
        live = (warps > b).sum(-1)
        assert float(got["warp_alive_fraction"][b]) == pytest.approx(float((live > 0).double().mean()))
        assert float(got["warp_lanes"][b]) == pytest.approx(float(live.sum() / (live > 0).sum()))
    assert 0.0 <= got["warp_wasted_fraction"] <= got["wasted_fraction"]


def test_stats_of_a_short_last_block_and_warp():
    """Only real pixels count: a 5x7 frame is one block of 35 pixels and two
    warps, the second of 3 pixels."""
    entered = torch.tensor([1, 2, 3, 3, 2, 1, 1] * 5, dtype=torch.int32).reshape(1, 7, 5)
    got = MK.occupancy_stats(entered, 3)
    np.testing.assert_array_equal(got["counts"].numpy(), [[35, 20, 10]])
    np.testing.assert_allclose(got["alive_fraction"].numpy(), [1.0, 20 / 35, 10 / 35])
    np.testing.assert_array_equal(got["block_alive_fraction"].numpy(), [1.0, 1.0, 1.0])
    # the short warp holds 2, 1, 1: it runs bounces 0 and 1, not 2
    np.testing.assert_allclose(got["warp_alive_fraction"].numpy(), [1.0, 1.0, 0.5])
    np.testing.assert_allclose(got["warp_lanes"].numpy(), [35 / 2, 20 / 2, 10 / 1])
    assert got["warp_wasted_fraction"] == pytest.approx(1.0 - 65 / (32 * 5))
    # no tile, no compacted figure (the per-thread loop); a compacted loop
    # lists the one tile's 35, 20 and 10 live paths: 2, 1 and 1 warps
    assert got["compacted_wasted_fraction"] is None
    compacted = MK.occupancy_stats(entered, 3, 1536)["compacted_wasted_fraction"]
    assert compacted == pytest.approx(1.0 - 65 / (32 * 4))
    assert MK.occupancy_stats(entered, 3, 256)["compacted_wasted_fraction"] == compacted


def test_compacted_stats_of_hand_made_counts():
    """compacted_wasted_fraction on hand-made counts: 2 samples of 2 tiles
    of 256 pixels, per tile, sample and bounce ceil(live / 32) warps; the
    same counts in one tile a sample."""
    n = 2 * 256
    entered = torch.zeros((2, n), dtype=torch.int32)
    entered[0, :256] = 3                          # sample 0, tile 0: 256 live at bounces 0-2
    entered[0, 256:256 + 33] = 1                  # tile 1: 33 live at bounce 0
    entered[1, 0:64:2] = 2                        # sample 1, tile 0: 32 live, one in two, at bounces 0-1
    entered[1, 256:256 + 100] = torch.tensor([1, 2, 3, 3] * 25, dtype=torch.int32)  # 100, 75, 50
    got = MK.occupancy_stats(entered.reshape(2, 4, 128), 3, 256)
    lanes = 3 * 256 + 33 + 2 * 32 + 100 + 75 + 50
    warps = 3 * 8 + 2 + 2 * 1 + 4 + 3 + 2
    assert got["compacted_wasted_fraction"] == pytest.approx(1.0 - lanes / (32 * warps))
    # one tile a sample: 256 + 33 = 289, 256 and 256 live; 132, 107 and 50
    whole = MK.occupancy_stats(entered.reshape(2, 4, 128), 3, n)
    assert whole["compacted_wasted_fraction"] == pytest.approx(1.0 - lanes / (32 * (10 + 8 + 8 + 5 + 4 + 2)))
    # the per-thread loop's live warps: sample 1's first two warps half full,
    # and the four warps of its second tile live at every bounce
    per_thread = 3 * 8 + 2 + 2 * 2 + 3 * 4
    assert got["warp_wasted_fraction"] == pytest.approx(1.0 - lanes / (32 * per_thread))
    assert got["compacted_wasted_fraction"] < got["warp_wasted_fraction"]


def test_render_cli_prints_the_occupancy_on_the_cpu(tmp_path):
    lines = []
    cfg, out = cli.parse_args(["--device", "cpu", "--scene", "mesh", "--width", str(W), "--height", str(H),
                               "--depth", str(DEPTH), "--seed", str(KEY_SEED), "--frames", "1", "--occupancy",
                               "-o", str(tmp_path / "o.png")])
    cli.render(cfg, out, log=lines.append)
    head = lines[0]
    assert head.startswith("bounce occupancy (alive-lane fraction entering each bounce")
    want = fixture("mesh")["probe_spp1"]
    assert lines[1].split() == [f"b{i}:" if j == 0 else f"{x:.3f}" for i, x in enumerate(want) for j in (0, 1)]
    assert (tmp_path / "o.png").exists()


@pytest.mark.slow
def test_fixtures_are_what_jax_computes():
    for family in FAMILIES:
        want = jax_occupancy(family)
        got = fixture(family)
        assert sorted(got) == sorted(want), family
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{family} {k}")


if __name__ == "__main__":
    for fam in FAMILIES:
        arrays = jax_occupancy(fam)
        np.savez(fixture_path(fam), **arrays)
        print(fam, {k: v.tolist() for k, v in arrays.items() if "fraction" in k or "probe" in k})
