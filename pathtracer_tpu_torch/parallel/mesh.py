"""Sharding over torch.distributed: pixel ranges over ranks, samples over
groups of them.

Port of `pathtracer_tpu/parallel/mesh.py`. The JAX package shards over a
("tiles", "spp") device mesh: "tiles" splits the frame's flat ray batch
into contiguous blocks, "spp" splits the samples, whose mean is a psum.
Here a rank is one process with one device, and the mesh is the ranks of
the initialised process group laid out as JAX lays out its devices
(`np.asarray(devices).reshape(n_tiles, n_spp)`): rank r is tile r //
n_spp and sample group r % n_spp, and `Mesh` holds the process groups of
both axes.

- `render_frame_sharded` (the eager tier): rays over "tiles", samples over
  "spp"; the sample groups' sums are all-reduced over the spp axis and
  divided by spp, the tiles' frames over the tiles axis.
- `render_frame_sharded_megakernel` (the port of
  `render_frame_sharded_pallas`): every rank of the mesh, both axes
  flattened, is one range of the pixel axis and runs K1 on its range with
  all spp samples (`ops/megakernel`'s `pixels=`); each pixel's random
  numbers are drawn at its global counters, so the sharded frame is the
  single launch's bit for bit.
- `make_train_step_sharded`: each rank's loss is its pixels' squared
  error over the whole frame's count, its gradient that loss's (K2 over
  its range through the megakernel), and the gradients are summed over
  the ranks, as DDP sums them, before the Adam step.

A frame is assembled by an all-reduce (SUM) of a zeroed [H, W, 4] frame
in which each rank wrote only its pixels: x + 0 is x, so the sum is exact.
The collectives run outside autograd (torch.distributed's are not
differentiable, and no rank needs another's pixels in its graph): a sharded
frame is not differentiable, the training step differentiates each rank's
share. Ranges start on K2's 128-pixel blocks, whose chunks start on one
(K1 takes a range at any pixel); a rank past the frame's last pixel gets
an empty range, launches nothing, and still joins every collective, as
JAX's surplus tiles do.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from ..integrator.inverse import KERNELS, make_adam, select_leaves
from ..integrator.tracer import VERBATIM, Quirks, frame_of, sample_radiance
from ..models.scene import Scene
from ..ops import rng
from ..ops.megakernel import render_frame_megakernel
from ..ops.vecmath import V3

# A range's alignment: K2's block (csrc/megakernel_bwd.cuh BWD_THREADS),
# on which its record and adjoint chunks start
RANGE_ALIGN = 128


def shard_ranges(n_pixels: int, n_ranks: int) -> list[tuple[int, int]]:
    """Contiguous (p_begin, p_count) ranges of a frame's n_pixels flat
    pixels for n_ranks ranks: each holds ceil(n / n_ranks) pixels rounded up
    to a multiple of RANGE_ALIGN, the last one the rest; a rank past the
    last pixel gets (n_pixels, 0)."""
    if n_ranks < 1:
        raise ValueError(f"{n_ranks} ranks: need at least one")
    per = -(-(-(-n_pixels // n_ranks)) // RANGE_ALIGN) * RANGE_ALIGN
    return [(min(r * per, n_pixels), max(0, min(per, n_pixels - r * per))) for r in range(n_ranks)]


def rank_layout(n_tiles: int, n_spp: int = 1) -> np.ndarray:
    """The ranks of an (n_tiles, n_spp) mesh as [n_tiles, n_spp]: rank r is
    tile r // n_spp and sample group r % n_spp, as JAX's make_mesh reshapes
    its device list."""
    return np.arange(n_tiles * n_spp).reshape(n_tiles, n_spp)


def factor(n_ranks: int, n_spp: int | None = None) -> tuple[int, int]:
    """(n_tiles, n_spp) of factor_mesh: n_spp=None gives the spp axis 2
    where n is even, else 1, and the tiles the rest; an explicit n_spp must
    be a positive divisor of n."""
    if n_spp is None:
        n_spp = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    if n_spp < 1 or n_ranks % n_spp != 0:
        raise ValueError(f"n_spp={n_spp} must be a positive divisor of {n_ranks}")
    return n_ranks // n_spp, n_spp


def world() -> tuple[int, int]:
    """(rank, world size) of the initialised process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_tiles, n_spp) mesh and the process groups
    it reduces over: `spp_group` (its tile's sample groups), `tiles_group`
    (its sample group's tiles) and `world_group` (every rank); a group is
    None where its axis has one rank, and its reductions are no-ops."""

    n_tiles: int
    n_spp: int = 1
    rank: int = 0
    tiles_group: object = None
    spp_group: object = None
    world_group: object = None

    @property
    def size(self) -> int:
        return self.n_tiles * self.n_spp

    @property
    def tile(self) -> int:
        return self.rank // self.n_spp

    @property
    def sample_group(self) -> int:
        return self.rank % self.n_spp

    def tile_pixels(self, n_pixels: int) -> tuple[int, int]:
        """This rank's tile's range of the frame's pixels (the tiles axis)."""
        return shard_ranges(n_pixels, self.n_tiles)[self.tile]

    def flat_pixels(self, n_pixels: int) -> tuple[int, int]:
        """This rank's range of the pixel axis over both axes flattened."""
        return shard_ranges(n_pixels, self.size)[self.rank]


def make_mesh(n_tiles: int, n_spp: int = 1) -> Mesh:
    """An (n_tiles, n_spp) mesh over the ranks of the initialised process
    group, its axes' groups made (every rank calls this, in the same
    order). Its size must be the world size, which raises naming both; a
    1x1 mesh needs no process group."""
    rank, size = world()
    if n_tiles < 1 or n_spp < 1 or n_tiles * n_spp != size:
        raise ValueError(f"a {n_tiles}x{n_spp} mesh needs {n_tiles * n_spp} ranks, the process group has {size}")
    if size == 1:
        return Mesh(n_tiles, n_spp)
    layout = rank_layout(n_tiles, n_spp)
    groups = {}
    for axis, lines in (("spp", layout), ("tiles", layout.T)):
        for line in lines:  # every rank makes every group, in the same order
            ranks = [int(r) for r in line]
            if len(ranks) == 1:
                continue
            group = dist.group.WORLD if len(ranks) == size else dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(n_tiles, n_spp, rank, groups.get("tiles"), groups.get("spp"), dist.group.WORLD)


def factor_mesh(n_ranks: int, n_spp: int | None = None) -> Mesh:
    """make_mesh over `factor(n_ranks, n_spp)`."""
    return make_mesh(*factor(n_ranks, n_spp))


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over `group` (no-op for None); returns t."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _sample_keys(key, spp: int, mesh: Mesh) -> list:
    """The sample keys of this rank's sample group: render_frame's key (spp
    1) or split(key, spp)[s] for its share of s."""
    if spp % mesh.n_spp != 0:
        raise ValueError(f"spp={spp} not divisible by mesh spp axis {mesh.n_spp}")
    if spp == 1:
        return [key]
    per = spp // mesh.n_spp
    return list(rng.split(key, spp))[mesh.sample_group * per:(mesh.sample_group + 1) * per]


def _eager_rows(scene: Scene, key, mesh: Mesh, width: int, height: int, spp: int, quirks: Quirks,
                detach: bool) -> tuple[torch.Tensor, tuple[int, int]]:
    """The eager tier's radiance [count, 3] of this rank's tile, the mean of
    all spp samples, and the range. The rank traces its sample group's
    samples; with one group their mean is render_frame's, with more the
    groups' sums are all-reduced over the spp axis outside autograd and
    the rows carry the gradient of this group's samples only (their sum
    over spp), which the gradients' reduction over the ranks completes."""
    pixels = mesh.tile_pixels(width * height)
    acc = [sample_radiance(scene, k, width, height, quirks, detach, pixels=pixels)
           for k in _sample_keys(key, spp, mesh)]
    if mesh.n_spp == 1:  # render_frame's arithmetic
        mean = acc[0] if spp == 1 else [torch.stack([a[c] for a in acc]).mean(dim=0) for c in range(3)]
        return torch.stack(list(mean), dim=-1), pixels
    local = torch.stack([torch.stack([a[c] for a in acc]).sum(dim=0) for c in range(3)], dim=-1)
    total = all_reduce(local.detach().clone(), mesh.spp_group) / spp
    return total + (local - local.detach()) / spp, pixels


def render_frame_sharded(
    scene: Scene, key, mesh: Mesh, width: int, height: int, spp: int = 1, quirks: Quirks = VERBATIM,
    detach: bool = False,
) -> torch.Tensor:
    """Sharded render_frame (the eager tier): rays over "tiles", samples
    over "spp" -> the [H, W, 4] frame on every rank, render_frame's (bit
    for bit with one sample group; with more, its spp mean summed in
    another order). Every rank of the mesh calls it."""
    with torch.no_grad():
        rows, pixels = _eager_rows(scene, key, mesh, width, height, spp, quirks, detach)
        frame = frame_of(V3(*rows.unbind(-1)), width, height, pixels)
        all_reduce(frame, mesh.tiles_group)
        frame[..., 3] = 1.0
    return frame


def render_frame_sharded_megakernel(
    scene: Scene, key, mesh: Mesh, width: int, height: int, spp: int = 1, quirks: Quirks = VERBATIM,
) -> torch.Tensor:
    """The sharded megakernel render: every rank of the mesh (both axes
    flattened) renders its range of the pixel axis with all spp samples,
    on the card one launch of K1 (none for an empty range), on the CPU its
    plain version; the frames are summed over the mesh -> the [H, W, 4]
    frame on every rank, the single launch's bit for bit. Every rank of the
    mesh calls it."""
    with torch.no_grad():
        frame = render_frame_megakernel(scene, key, width, height, spp, quirks,
                                        mesh.flat_pixels(width * height))
        all_reduce(frame, mesh.world_group)
        frame[..., 3] = 1.0
    return frame


def rank_rows(scene: Scene, key, mesh: Mesh, width: int, height: int, spp: int, quirks: Quirks,
              kernel: str) -> tuple[torch.Tensor, tuple[int, int]]:
    """This rank's share of a differentiable render (the detached-sampling
    estimator): its pixels' RGB [count, 3] and their range. kernel=
    "megakernel": the flattened range through render_frame_megakernel (K1,
    and K2 in its backward, on a CUDA scene); kernel="eager": the tile's
    range through the eager tier, its spp mean over the sample groups."""
    if kernel == "megakernel":
        begin, count = pixels = mesh.flat_pixels(width * height)
        img = render_frame_megakernel(scene, key, width, height, spp, quirks, pixels)
        return img.reshape(-1, 4)[begin:begin + count, :3], pixels
    if kernel == "eager":
        return _eager_rows(scene, key, mesh, width, height, spp, quirks, detach=True)
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


def loss_group(mesh: Mesh, kernel: str):
    """The group over which the ranks' losses add up to the frame's: every
    rank for the megakernel's disjoint ranges; the tiles axis for the eager
    tier, whose sample groups of one tile hold the same loss."""
    return mesh.world_group if kernel == "megakernel" else mesh.tiles_group


def reduce_grads(train: list, mesh: Mesh) -> None:
    """Sum the leaves' gradients over the mesh, in one flat buffer (a
    leaf without a gradient adds zeros); every rank calls it."""
    if mesh.world_group is None:
        return
    grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in train]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh.world_group)
    for t, g in zip(train, flat.split([g.numel() for g in grads])):
        t.grad = g.reshape(t.shape).clone()


def paired_step_sharded(train, rebuild, projection, opt, mesh: Mesh, kernel: str, width: int, height: int,
                        spp: int, quirks: Quirks, target: torch.Tensor, key) -> torch.Tensor:
    """integrator/inverse.paired_step over the mesh: the two renders of the
    keys split from `key` are this rank's share (rank_rows, the first with
    grad), the paired loss is taken on its pixels over the frame's 3 W H
    values, the gradients are summed over the mesh before opt.step(), and
    the loss is summed over loss_group. Returns the detached loss, the same
    on every rank."""
    ka, kb = rng.split(key)
    opt.zero_grad(set_to_none=True)
    s = rebuild(train)
    if projection is not None:
        s = projection(s)
    rows_a, (begin, count) = rank_rows(s, ka, mesh, width, height, spp, quirks, kernel)
    with torch.no_grad():
        rows_b, _ = rank_rows(s, kb, mesh, width, height, spp, quirks, kernel)
    t = target[..., :3].reshape(-1, 3)[begin:begin + count].to(rows_a)
    loss = ((rows_a - t) * (rows_b - t)).sum() / (3 * width * height)
    if loss.requires_grad:
        loss.backward()
    reduce_grads(train, mesh)
    opt.step()
    return all_reduce(loss.detach().clone(), loss_group(mesh, kernel))


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's `obj` on every rank of the mesh (the viewer's controls)."""
    if mesh.world_group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def parse_mesh(text: str) -> tuple[int, int]:
    """(tiles, spp) of a `--mesh TILESxSPP` argument, as the JAX CLIs parse
    it ("4x2", "4" for 4x1)."""
    parts = text.lower().split("x")
    return int(parts[0]), int(parts[1]) if len(parts) > 1 else 1


def make_train_step_sharded(
    mesh: Mesh,
    select: Iterable[str],
    scene_template: Scene,
    width: int,
    height: int,
    spp: int,
    lr: float = 2e-2,
    quirks: Quirks = VERBATIM,
    kernel: str = "eager",
):
    """A full inverse-rendering training step over the mesh: each rank
    renders its share (rank_rows: kernel="eager" the tiles' ranges and the
    sample groups through the eager tier, kernel="megakernel" the flattened
    ranges through K1 forward and K2 backward), takes its pixels' squared
    error against the target over the frame's 3 W H values, the gradient
    of that, the gradients summed over the mesh, then one step of the
    port's optax-compatible Adam (`integrator/inverse.make_adam`). The loss
    is summed over the mesh (loss_group), the frame's MSE on every rank.

    Returns (step_fn, (train, opt), names) with step_fn(train, opt,
    target, key) -> (train, opt, loss), `target` the frame's RGB as [W H,
    3] (or [H, W, >= 3]), the same on every rank."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    train0, rebuild, names = select_leaves(scene_template, select)
    n = width * height

    def step(train, opt, target, key):
        opt.zero_grad(set_to_none=True)
        rows, (begin, count) = rank_rows(rebuild(train), key, mesh, width, height, spp, quirks, kernel)
        err = rows - target[..., :3].reshape(-1, 3)[begin:begin + count].to(rows)
        loss = (err * err).sum() / (3 * n)
        if loss.requires_grad:
            loss.backward()
        reduce_grads(train, mesh)
        opt.step()
        return train, opt, all_reduce(loss.detach().clone(), loss_group(mesh, kernel))

    return step, (train0, make_adam(train0, lr)), names


__all__ = [
    "Mesh",
    "paired_step_sharded",
    "parse_mesh",
    "RANGE_ALIGN",
    "factor",
    "factor_mesh",
    "make_mesh",
    "make_train_step_sharded",
    "rank_layout",
    "render_frame_sharded",
    "render_frame_sharded_megakernel",
    "shard_ranges",
]
