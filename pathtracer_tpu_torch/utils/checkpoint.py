"""Checkpoint/resume for progressive renders and inverse-rendering runs.

Port of `pathtracer_tpu/utils/checkpoint.py`. A state is a nested
structure of tuples and lists whose leaves are tensors or numbers. It is
saved as one `.npz`: the leaves depth first as `leaf_0, leaf_1, ...` (the
order `jax.tree_util.tree_flatten` gives the same structure) and the
structure as a string beside them. Saving is atomic (a temporary file,
then `os.replace`); loading enforces the structure, so a checkpoint of
another shape never loads with its leaves misassigned.

A render's state crosses from the JAX package too: `render_state_from_jax`
reads the checkpoint the JAX render CLI writes, and `load_render_state`
takes either package's.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

STRUCTURE_KEY = "__structure__"
# the JAX render CLI's state, (ColorBuffer(pixels, frames), key, frame), as
# `jax.tree_util` describes it in the checkpoint's __treedef__
JAX_TREEDEF_KEY = "__treedef__"
JAX_RENDER_TREEDEF = "PyTreeDef((CustomNode(namedtuple[ColorBuffer], [*, *]), *, *))"


def _flatten(tree: Any) -> tuple[list, str]:
    """Leaves depth first, and the structure: (...) a tuple, [...] a list,
    * a leaf."""
    if isinstance(tree, (tuple, list)):
        leaves, parts = [], []
        for child in tree:
            sub, desc = _flatten(child)
            leaves += sub
            parts.append(desc)
        open_, close = ("(", ")") if isinstance(tree, tuple) else ("[", "]")
        return leaves, open_ + ",".join(parts) + close
    return [tree], "*"


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, (tuple, list)):
        out = [_unflatten(child, leaves) for child in like]
        return tuple(out) if isinstance(like, tuple) else out
    return next(leaves)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state: Any) -> None:
    """Atomically save a state (nested tuples/lists of tensors) to `path`."""
    leaves, structure = _flatten(state)
    payload = {f"leaf_{i}": _as_numpy(leaf) for i, leaf in enumerate(leaves)}
    payload[STRUCTURE_KEY] = np.frombuffer(json.dumps(structure).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, like: Any) -> Any:
    """Load a checkpoint saved by save_checkpoint into the structure of
    `like`. The structure and every leaf's shape must match; a tensor leaf
    of `like` gives its dtype and device to the loaded leaf."""
    leaves_like, structure = _flatten(like)
    with np.load(path) as data:
        n_saved = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_saved != len(leaves_like):
            raise ValueError(f"checkpoint has {n_saved} leaves, expected {len(leaves_like)}")
        if STRUCTURE_KEY not in data.files:
            raise ValueError(f"{path} holds no structure record")
        saved = json.loads(bytes(data[STRUCTURE_KEY]).decode())
        if saved != structure:
            raise ValueError(f"checkpoint structure mismatch:\n  saved:    {saved}\n  expected: {structure}")
        arrays = [data[f"leaf_{i}"] for i in range(len(leaves_like))]
    out = []
    for i, (arr, want) in enumerate(zip(arrays, leaves_like)):
        if arr.shape != tuple(np.shape(_as_numpy(want))):
            raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != expected {np.shape(_as_numpy(want))}")
        if isinstance(want, torch.Tensor):
            out.append(torch.as_tensor(arr, dtype=want.dtype, device=want.device))
        else:
            out.append(arr)
    return _unflatten(like, iter(out))


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> str | None:
    """The newest checkpoint path in `directory` (by name), or None."""
    if not os.path.isdir(directory):
        return None
    cands = sorted(f for f in os.listdir(directory) if f.startswith(prefix) and f.endswith(".npz"))
    return os.path.join(directory, cands[-1]) if cands else None


def render_state_from_jax(path: str, like: tuple) -> tuple:
    """Read a checkpoint of the JAX render CLI, `(ColorBuffer(pixels,
    frames), key, frame)` with a uint32[2] key, into the port's render
    state of the structure of `like` = (ColorBuffer, key, frame): the
    buffer on like's device, the key as the port's int64 pair of uint32
    words (ops/rng), the frame an int. Another structure, another pixel
    shape or float dtype, or a key that is not uint32[2] raises ValueError."""
    like_buf = like[0]
    with np.load(path) as data:
        if JAX_TREEDEF_KEY not in data.files:
            raise ValueError(f"{path} holds no JAX tree structure")
        treedef = json.loads(bytes(data[JAX_TREEDEF_KEY]).decode())
        if treedef != JAX_RENDER_TREEDEF:
            raise ValueError(f"{path} is not a JAX render checkpoint: {treedef}")
        pixels, frames, key, frame = (data[f"leaf_{i}"] for i in range(4))
    want = like_buf.pixels
    if pixels.shape != tuple(want.shape) or torch.from_numpy(pixels).dtype != want.dtype:
        raise ValueError(f"{path}: pixels {pixels.shape} {pixels.dtype}, expected {tuple(want.shape)} {want.dtype}")
    if key.dtype != np.uint32 or key.shape != (2,):
        raise ValueError(f"{path}: key {key.shape} {key.dtype}, expected uint32[2]")
    buf = type(like_buf)(
        torch.as_tensor(pixels, device=want.device),
        torch.as_tensor(frames, dtype=like_buf.frames.dtype, device=like_buf.frames.device),
    )
    return buf, torch.as_tensor(key.astype(np.int64)), int(frame)


def load_render_state(path: str, like: tuple) -> tuple:
    """A render state (ColorBuffer, key, frame) from a checkpoint that the
    port's render CLI or the JAX package's wrote."""
    with np.load(path) as data:
        jax_written = JAX_TREEDEF_KEY in data.files
    if jax_written:
        return render_state_from_jax(path, like)
    buf, key, frame = load_checkpoint(path, like)
    return type(like[0])(*buf), key, int(frame)
