# Frozen copy of pathtracer_tpu_torch/utils/tree.py for the benchmark's plain reference:
# imports rewritten to this package; it imports nothing of the port.
"""NamedTuple trees of tensors: the port's stand-in for `jax.tree_util`."""

from __future__ import annotations


def tree_map(fn, *trees):
    """Map `fn` over the tensor leaves of matching NamedTuple trees."""
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*[tree_map(fn, *leaves) for leaves in zip(*trees)])
    return fn(*trees)
