"""The traffic generator: every input a run feeds the program, from the
seed and the mix's parameters (`traffic/<mix>.json`).

Keys are threefry2x32 keys as `jax.random` makes them (`reference/rng.py`,
a frozen copy of the port's `ops/rng.py`), split as the port's CLIs split
them:

- `frames` (app/render's loop): key = PRNGKey(seed); each frame
  `key, sub = split(key)` and the frame renders `sub`;
- `train` (recover_demo): the target renders the keys
  split(fold_in(PRNGKey(seed), 17), target_frames); step i renders the
  keys split from fold_in(fold_in(PRNGKey(seed), 29), i).

Every seed gives the same work: the same frame size, spp, depth and step
count, on other random numbers. Which frames of a window are compared
with the reference is drawn from the seed too (`Reservoir`).
"""

from __future__ import annotations

import random
from typing import Iterator

import torch

from .reference import rng


def base_key(seed: int) -> torch.Tensor:
    return rng.prng_key(seed)


def frame_keys(seed: int) -> Iterator[torch.Tensor]:
    """The key of each progressive frame, in order, without end."""
    key = base_key(seed)
    while True:
        key, sub = rng.split(key)
        yield sub


def target_keys(seed: int, frames: int) -> torch.Tensor:
    """[frames, 2] keys of the training target's renders."""
    return rng.split(rng.fold_in(base_key(seed), 17), frames)


def step_key(seed: int, step: int) -> torch.Tensor:
    """The key of optimizer step `step` (0-based, counted over the run)."""
    return rng.fold_in(rng.fold_in(base_key(seed), 29), step)


def warmup_key(seed: int) -> torch.Tensor:
    """A key no timed frame or step uses, for the set-up's warm-up."""
    return rng.fold_in(base_key(seed), 101)


class Reservoir:
    """Which frames of a stream of unknown length are kept for the check:
    the first, a uniform sample of `size` of the others drawn from the seed
    (Algorithm R), and the last. `offer` says in which of the `size + 1`
    slots to keep an item (0 for the first), or None; the caller keeps the
    last item itself."""

    def __init__(self, size: int, seed: int):
        self.size, self.rand = size, random.Random(int(seed) * 7919 + 1)
        self.seen = 0
        self.slots: dict = {}  # slot -> (index, key)

    def offer(self, index: int, key) -> int | None:
        self.seen += 1
        if index == 0:
            slot = 0
        elif len(self.slots) <= self.size:
            slot = len(self.slots)
        else:
            j = self.rand.randrange(self.seen - 1)
            if j >= self.size:
                return None
            slot = j + 1
        self.slots[slot] = (index, key)
        return slot


def check_traffic(traffic: dict, kinds) -> None:
    """A mix of a kind that has a driver, and sizes of at least 1."""
    if traffic.get("kind") not in kinds:
        raise ValueError(f"traffic kind {traffic.get('kind')!r}, not one of {sorted(kinds)}")
    for k in ("width", "height", "spp"):
        if int(traffic[k]) < 1:
            raise ValueError(f"traffic {k} {traffic[k]}")
