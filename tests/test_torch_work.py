"""`tools/work.py`, the counts behind the mesh and SDF kernels' bounds.

`bigmesh_walk` replays K8's walks over its chunks with tensor ops; here a
loop that follows `csrc/bigmesh.cuh` statement by statement (chunk by
chunk, the box test against the best t so far or max_dist, `mt_hit`'s
early returns, the shadow ray's return at its first occluder) must count
the same box tests and pairs on seeded rays, and the pairs its warps run.
`count_mesh_work` on a small frame of each mesh scene: its counts must fit
each other (every shadow ray on a segment, no more tests than the walks
allow). `count_sdf_work`: the primary marches' steps against the march of
`csrc/sdf.cuh` built for the host, and every march of a frame fitting
together.
"""

import ctypes

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.models import bigmesh as TB
from pathtracer_tpu_torch.models import families
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.vecmath import V3
from pathtracer_tpu_torch.tools.work import WARP, bigmesh_walk, chunk_cull, count_mesh_work, count_sdf_work, warp_cost
from test_torch_kernel_host import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rays(n: int, seed: int) -> tuple[V3, V3]:
    """Seeded float32 rays from around the camera and above the ground
    toward the sphere and the floor."""
    rs = np.random.default_rng(seed)
    ro = np.where(rs.random(n) < 0.5, rs.uniform(-0.4, 0.4, (3, n)) + np.array([[0.0], [0.3], [5.0]]),
                  rs.uniform(-2.5, 2.5, (3, n)) * np.array([[1.0], [0.3], [1.0]]) + np.array([[0.0], [1.5], [0.0]]))
    rd = rs.uniform(-2.0, 2.0, (3, n)) * np.array([[1.0], [0.6], [1.0]]) + np.array([[0.0], [-0.4], [0.0]]) - ro
    rd = rd / np.linalg.norm(rd, axis=0)
    as_v3 = lambda a: V3(*(torch.tensor(c, dtype=torch.float32) for c in a))
    return as_v3(ro), as_v3(rd)


def _kernel_walk(p, ro: V3, rd: V3, max_dist=None) -> np.ndarray:
    """[N, 4] (boxes, pairs, past the determinant's guard, past u's) of
    BigMesh::closest_hit, or of BigMesh::any_hit with max_dist, one ray and
    one chunk at a time."""
    coef, _, aabb = TB.coef_tables(p)
    d, m, o = TB._ray_rows(ro, rd)
    out = np.zeros((d[0].shape[0], 4), np.int64)
    for r in range(d[0].shape[0]):
        row = lambda cols: [c[r:r + 1] for c in cols]
        best = float("inf") if max_dist is None else float(max_dist[r])
        for c in range(aabb.shape[0]):
            out[r, 0] += 1
            if not bool(chunk_cull(aabb[c:c + 1], row(o), row(d), torch.tensor([[best]]))[0, 0]):
                continue
            rows = coef[c * TB.CHUNK:(c + 1) * TB.CHUNK]
            det, u_num, v_num, t_num = TB.mt_terms([rows[:, k][None, :] for k in range(TB.FEAT)], row(d), row(m), row(o))
            t = TB.mt_hit_t(det, u_num, v_num, t_num)[0]
            det_ok = (torch.abs(det) > TB.EPS)[0]
            u_ok = det_ok & (u_num[0] / torch.where(det_ok, det[0], 1.0) >= 0.0)
            tested, occluded = TB.CHUNK, False
            if max_dist is None:
                best = min(best, float(t.min()))
            else:
                occ = torch.nonzero(t < best)
                occluded = occ.numel() > 0
                tested = int(occ[0, 0]) + 1 if occluded else TB.CHUNK
            out[r, 1:] += [tested, int(det_ok[:tested].sum()), int(u_ok[:tested].sum())]
            if occluded:
                break
    return out


@pytest.mark.parametrize("walk", ["closest", "shadow"])
def test_bigmesh_walk_counts_what_the_kernel_tests(walk):
    p = TB.default_params()
    ro, rd = _rays(120, 31)
    md = None
    if walk == "shadow":
        md = torch.tensor(np.random.default_rng(32).uniform(0.5, 8.0, 120), dtype=torch.float32)
    got = bigmesh_walk(p, ro, rd, md)
    want = _kernel_walk(p, ro, rd, md)
    counted = np.stack([got.boxes.numpy(), got.pairs.numpy(), got.det_ok.numpy(), got.u_ok.numpy()], axis=1)
    np.testing.assert_array_equal(counted, want)
    np.testing.assert_array_equal(got.chunk_pairs.sum(dim=1).numpy(), want[:, 1])
    # a warp runs each chunk as far as its slowest lane goes in it
    lanes = np.zeros(120, bool)
    lanes[::3] = lanes[1::7] = True
    chunk = got.chunk_pairs.numpy() * lanes[:, None]
    by_loop = sum(WARP * chunk[w:w + WARP].max(axis=0).sum() for w in range(0, 120, WARP))
    assert warp_cost(got.chunk_pairs, torch.from_numpy(lanes)) == by_loop > want[lanes, 1].sum()
    # the rays reach both kinds of walk: some skip chunks, some stop early
    assert (want[:, 1] < 9 * TB.CHUNK).any() and (want[:, 1] > TB.CHUNK).any()
    if walk == "shadow":
        assert (want[:, 0] < 9).any()


@pytest.mark.parametrize("family", ["mesh", "bigmesh"])
def test_count_mesh_work_fits_together(family):
    scene = families.make_family_scene(family, recursion_depth=3)
    work = count_mesh_work(scene, rng.prng_key(7), 32, 24)
    segments, shadow = work["segments"], work["shadow_rays"]
    assert 32 * 24 <= segments <= 3 * 32 * 24
    assert 0 < shadow < segments
    if family == "mesh":
        n_tris = scene.params.tri_idx.shape[0]
        assert work["closest_tests"] == n_tris * segments
        assert shadow <= work["shadow_tests"] < n_tris * shadow
    else:
        assert work["closest_boxes"] == 9 * segments
        assert shadow <= work["shadow_boxes"] <= 9 * shadow
        for w, rays in (("closest", segments), ("shadow", shadow)):
            assert 0 < work[f"{w}_u_ok"] < work[f"{w}_det_ok"] <= work[f"{w}_pairs"] <= 9 * TB.CHUNK * rays


def test_warp_cost():
    work = torch.tensor([3, 1, 0, 7] + [2] * 30 + [5])
    mask = torch.ones(35, dtype=torch.bool)
    assert warp_cost(work, mask) == WARP * (7 + 5)
    mask[3] = False
    assert warp_cost(work, mask) == WARP * (3 + 5)
    assert warp_cost(torch.stack([work, 10 - work], 1), mask) == WARP * (3 + 10 + 5 + 8)


def test_count_sdf_work_primary_marches_match_the_kernel_march(tmp_path):
    """At depth 1 every segment is a primary ray: count_sdf_work's steps are
    the march of csrc/sdf.cuh (built for the host) on the same camera rays
    on at least 99.9% of the lanes, and its warp count the warps' slowest
    lanes'."""
    from pathtracer_tpu_torch.integrator import tracer as T
    from pathtracer_tpu_torch.models.camera import gen_ray, pixel_coords
    from pathtracer_tpu_torch.ops.vecmath import V2
    from test_torch_kernel_host import build_shim
    from test_torch_sdf_kernel_host import SHIM, HostSdf

    host = HostSdf(build_shim(tmp_path, SHIM))
    p, i = ctypes.c_void_p, ctypes.c_int
    host.lib.host_folds.argtypes = [p, p, i, p, p, p, p, p, p, p]
    scene, key, w, h = families.make_family_scene("sdf", recursion_depth=1), rng.prng_key(12), 48, 32
    work = count_sdf_work(scene, key, w, h)
    cam_u, _ = T.draw_uniforms(key, w * h, 1, torch.float32, None)
    ro, rd = gen_ray(scene.camera.unpack(), pixel_coords(w, h, torch.float64, None), V2(cam_u[:, 0], cam_u[:, 1]),
                     float(w), float(h))
    ro = np.broadcast_to(np.stack([np.asarray(c, np.float32) for c in ro], -1), (w * h, 3))
    _, _, steps = host.folds(scene, ro, np.stack([np.asarray(c, np.float32) for c in rd], -1))
    assert work["segments"] == w * h and work["shadow_rays"] > 0
    assert abs(work["closest_trips"] - int(steps.sum())) <= 1e-3 * int(steps.sum())
    assert abs(work["closest_warp_trips"] - warp_cost(steps.long(), torch.ones(w * h, dtype=torch.bool))) <= (
        1e-2 * work["closest_warp_trips"])
    assert work["max_trips"] == int(steps.max()) == 96


def test_count_sdf_work_fits_together():
    scene = families.make_family_scene("sdf", recursion_depth=3)
    work = count_sdf_work(scene, rng.prng_key(7), 32, 24)
    segments, shadow = work["segments"], work["shadow_rays"]
    assert 32 * 24 <= segments <= 3 * 32 * 24 and 0 < shadow < segments
    assert segments <= work["closest_trips"] <= work["closest_warp_trips"] <= 96 * WARP * -(-segments // 1)
    assert shadow <= work["shadow_trips"] <= work["shadow_warp_trips"]
    assert work["max_trips"] == 96
