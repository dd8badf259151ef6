"""What one frame asks of K1, counted from its plain version on the same
threefry numbers: the ray segments (bounces entered by a live path), in a
scene with a medium those inside one and the scatter events, and, for the
mesh scenes, the triangle and box tests their backends make.

`chip_smoke.py` turns these counts into each kernel's bound. They replay
the kernels' walks, not the plain version's (which tests every triangle):

- the small mesh (`csrc/mesh.cuh`) tests all its triangles per closest
  hit, and per shadow ray those up to the first occluder;
- the big mesh (`csrc/bigmesh.cuh`) tests each chunk's box in order, with
  t_far the ray's best t so far (the shadow ray's max_dist); inside an
  admitted chunk, `mt_hit` per triangle, which returns after the
  determinant's guard or u's where they fail. The shadow ray stops at the
  first occluding triangle.

A shadow ray is counted where K1 casts one (`csrc/tracer.cuh` bounce and
direct_light): on a live path that hits the geometry and not an emitter,
with the light sample's surface facing the scatter point.
"""

from __future__ import annotations

from typing import NamedTuple
from unittest import mock

import torch

from ..integrator import tracer as T
from ..models import bigmesh, mesh
from ..models.camera import gen_ray, pixel_coords
from ..models.scene import Scene
from ..ops.intersect import MISS
from ..ops.vecmath import V2, V3, dot, maximum


def count_segments(scene: Scene, key, width: int, height: int, per_bounce=None) -> int:
    """Ray segments of one spp-1 frame, from the plain version on the same
    threefry numbers; per_bounce(alive) is called after each bounce with
    the lanes that entered it."""
    with torch.no_grad():
        cam_u, bounce_u = T.draw_uniforms(key, width * height, scene.recursion_depth, torch.float32, scene.device)
        coords = pixel_coords(width, height, torch.float64, scene.device)
        ro, rd = gen_ray(scene.camera.unpack(), coords, V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height))
        state = T.init_state(ro, rd, T.VERBATIM)
        step = T.make_bounce_step(scene, T.VERBATIM, detach=True)
        alive = []
        for u in bounce_u:
            alive.append(state.alive)
            state = step(state, u)
            if per_bounce is not None:
                per_bounce(alive[-1])
        return int(torch.stack(alive).sum())


def count_media_work(scene: Scene, key, width: int, height: int) -> dict:
    """The segments of one spp-1 frame of a scene with a medium: all of
    them, those that enter their bounce inside a medium, and the scatter
    events (a free flight that ends before the hit, where K1 runs the HG
    phase's NEE and sample instead of the surface's Disney BSDF). A scatter
    event is a lane inside a Scatter medium whose next ray starts at its
    free flight's end, as the plain version computes it."""
    out = dict(segments=0, medium=0, scatter=0)
    with torch.no_grad():
        cam_u, bounce_u = T.draw_uniforms(key, width * height, scene.recursion_depth, torch.float32, scene.device)
        coords = pixel_coords(width, height, torch.float64, scene.device)
        ro, rd = gen_ray(scene.camera.unpack(), coords, V2(cam_u[:, 0], cam_u[:, 1]), float(width), float(height))
        state = T.init_state(ro, rd, T.VERBATIM)
        step = T.make_bounce_step(scene, T.VERBATIM, detach=True)
        for u in bounce_u:
            nxt = step(state, u)
            s_free = -torch.log(maximum(1.0 - u[..., 7], 1e-12)) / maximum(state.med_density, 1e-12)
            end = state.ro + state.rd * s_free
            scat = state.alive & (state.med_type == 2) & (state.med_density > 0.0)
            scat &= (nxt.ro.x == end.x) & (nxt.ro.y == end.y) & (nxt.ro.z == end.z)
            out["segments"] += int(state.alive.sum())
            out["medium"] += int((state.alive & (state.med_type != 0)).sum())
            out["scatter"] += int(scat.sum())
            state = nxt
    return out


def chunk_cull(aabb: torch.Tensor, o, d, t_far) -> torch.Tensor:
    """[N, nchunk] bool: can a ray (columns o, d of [N, 1]) meet chunk c's
    box inside (EPS, t_far)? The JAX kernel's robust slab test, per ray
    where the TPU tile tests any lane; t_far is [N, nchunk] or broadcasts."""
    t_near = torch.full_like(t_far, bigmesh.EPS)
    for k in range(3):
        invd = 1.0 / torch.where(torch.abs(d[k]) > 1e-20, d[k], 1e-20)
        t0 = (aabb[:, k][None, :] - o[k]) * invd
        t1 = (aabb[:, 3 + k][None, :] - o[k]) * invd
        t_near = torch.maximum(t_near, torch.minimum(t0, t1))
        t_far = torch.minimum(t_far, torch.maximum(t0, t1))
    return t_near <= t_far


class Walk(NamedTuple):
    """Per ray, what the big mesh backend tests: box tests, and the pairs
    that enter mt_hit, pass the determinant's guard and pass u's."""

    boxes: torch.Tensor  # [N] int64
    pairs: torch.Tensor
    det_ok: torch.Tensor
    u_ok: torch.Tensor
    admitted: torch.Tensor  # [N, nchunk] bool, the chunks whose triangles are tested


def _walk_block(coef, aabb, d, m, o, max_dist) -> Walk:
    det, u_num, v_num, t_num = bigmesh.mt_terms([coef[:, k][None, :] for k in range(bigmesh.FEAT)], d, m, o)
    t = bigmesh.mt_hit_t(det, u_num, v_num, t_num)
    det_ok = torch.abs(det) > bigmesh.EPS
    u_ok = det_ok & (u_num * torch.where(det_ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0) >= 0.0)
    n, n_chunks = t.shape[0], aabb.shape[0]
    per_chunk = lambda x: x.reshape(n, n_chunks, bigmesh.CHUNK)
    o32, d32 = [c.float() for c in o], [c.float() for c in d]
    if max_dist is None:
        # the closest hit: chunk c's box up to the best t of the chunks before it
        chunk_t = per_chunk(t).amin(dim=2).float()
        before = torch.cummin(chunk_t, dim=1).values
        t_far = torch.cat([torch.full_like(chunk_t[:, :1], MISS), before[:, :-1]], dim=1)
        admitted = chunk_cull(aabb, o32, d32, t_far)
        tested = admitted[:, :, None].expand(n, n_chunks, bigmesh.CHUNK)
        boxes = torch.full((n,), n_chunks, dtype=torch.int64, device=t.device)
    else:
        # the shadow ray: every box up to max_dist, until the first occluding triangle
        admitted = chunk_cull(aabb, o32, d32, max_dist.float())
        occ = per_chunk(t < max_dist) & admitted[:, :, None]
        occ_flat = occ.reshape(n, -1)
        stop = torch.where(occ_flat.any(dim=1), occ_flat.int().argmax(dim=1), occ_flat.shape[1])
        pos = torch.arange(occ_flat.shape[1], device=t.device)[None, :]
        tested = per_chunk(pos <= stop[:, None]) & admitted[:, :, None]
        boxes = torch.clamp(stop // bigmesh.CHUNK + 1, max=n_chunks)
        admitted = admitted & (torch.arange(n_chunks, device=t.device)[None, :] <= (stop // bigmesh.CHUNK)[:, None])
    count = lambda mask: (tested & per_chunk(mask)).reshape(n, -1).sum(dim=1)
    return Walk(boxes, tested.reshape(n, -1).sum(dim=1), count(det_ok), count(u_ok), admitted)


def bigmesh_walk(p: bigmesh.BigMeshParams, ro: V3, rd: V3, max_dist=None) -> Walk:
    """The big mesh backend's walk over its chunks for each ray: the
    closest hit's, or with max_dist the shadow ray's."""
    with torch.no_grad():
        coef, _, aabb = bigmesh.coef_tables(p)
        d, m, o = bigmesh._ray_rows(ro, rd)
        if max_dist is not None:
            max_dist = torch.broadcast_to(torch.as_tensor(max_dist, device=rd.x.device), rd.x.shape).reshape(-1, 1)
        blocks = [
            _walk_block(coef, aabb, [c[b] for c in d], [c[b] for c in m], [c[b] for c in o],
                        None if max_dist is None else max_dist[b])
            for b in bigmesh._blocks(d[0].shape[0], coef.shape[0])
        ]
        return Walk(*(torch.cat(parts) for parts in zip(*blocks)))


def mesh_shadow_tests(p: mesh.MeshParams, ro: V3, rd: V3, max_dist) -> torch.Tensor:
    """[N] triangle tests of the small mesh's shadow rays: up to and with
    the first occluder, or all of them."""
    occ = mesh._tri_ts(p, ro, rd) < torch.as_tensor(max_dist)[..., None]
    return torch.where(occ.any(dim=-1), occ.int().argmax(dim=-1) + 1, occ.shape[-1]).reshape(-1)


def count_mesh_work(scene: Scene, key, width: int, height: int) -> dict:
    """What one spp-1 frame of a mesh scene tests, from the plain version on
    the same threefry numbers: `segments`, `shadow_rays` (those K1 casts),
    and for the small mesh the triangle tests `closest_tests` and
    `shadow_tests`; for the big mesh `closest_boxes`, `shadow_boxes`, and
    per walk the pairs entering mt_hit (`*_pairs`), passing the
    determinant's guard (`*_det_ok`) and u's (`*_u_ok`)."""
    if bool((scene.params.materials.alpha_mode != 0).any()):
        raise ValueError("count_mesh_work counts scenes of opaque materials (no alpha pass-through)")
    big = scene.closest_hit_fn is bigmesh.closest_hit
    seen, total = {}, {}
    sample_light, sample_lights_emitter = T.sample_light, T.sample_lights_emitter

    def add(name, values, mask):
        total[name] = total.get(name, 0) + int(values.reshape(-1)[mask.reshape(-1)].sum())

    def closest(p, ro, rd):
        hit = (bigmesh if big else mesh).closest_hit(p, ro, rd)
        seen["geo_hit"] = torch.isfinite(hit.t)
        seen["closest"] = bigmesh_walk(p, ro, rd) if big else None
        return hit

    def shadow(p, ro, rd, max_dist):
        seen["shadow"] = bigmesh_walk(p, ro, rd, max_dist) if big else mesh_shadow_tests(p, ro, rd, max_dist)
        return (bigmesh if big else mesh).any_hit(p, ro, rd, max_dist)

    def emitter(*args, **kw):
        em = sample_lights_emitter(*args, **kw)
        seen["em_hit"] = em.hit
        return em

    def light(*args, **kw):
        ls = sample_light(*args, **kw)
        seen["facing"] = dot(ls.direction, ls.normal) < 0.0
        return ls

    def tally(alive):
        cast = alive & seen["geo_hit"] & ~seen["em_hit"] & seen.pop("facing", torch.zeros_like(alive))
        add("shadow_rays", torch.ones_like(alive, dtype=torch.int64), cast)
        if big:
            for walk, mask, name in ((seen["closest"], alive, "closest"), (seen.pop("shadow", None), cast, "shadow")):
                if walk is None:
                    continue
                add(f"{name}_boxes", walk.boxes, mask)
                for field in ("pairs", "det_ok", "u_ok"):
                    add(f"{name}_{field}", getattr(walk, field), mask)
        else:
            add("closest_tests", torch.full_like(alive, scene.params.tri_idx.shape[0], dtype=torch.int64), alive)
            if "shadow" in seen:
                add("shadow_tests", seen.pop("shadow"), cast)

    counting = scene.replace(closest_hit_fn=closest, any_hit_fn=shadow)
    with mock.patch.object(T, "sample_light", light), mock.patch.object(T, "sample_lights_emitter", emitter):
        total["segments"] = count_segments(counting, key, width, height, tally)
    return total
