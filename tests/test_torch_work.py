"""`tools/work.py`, the counts behind the mesh kernels' bounds.

`bigmesh_walk` replays K8's walks over its chunks with tensor ops; here a
loop that follows `csrc/bigmesh.cuh` statement by statement (chunk by
chunk, the box test against the best t so far or max_dist, `mt_hit`'s
early returns, the shadow ray's return at its first occluder) must count
the same box tests and pairs on seeded rays. `count_mesh_work` on a small
frame of each mesh scene: its counts must fit each other (every shadow ray
on a segment, no more tests than the walks allow).
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.models import bigmesh as TB
from pathtracer_tpu_torch.models import families
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.vecmath import V3
from pathtracer_tpu_torch.tools.work import bigmesh_walk, chunk_cull, count_mesh_work
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
