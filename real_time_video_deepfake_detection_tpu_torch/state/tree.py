"""Map a function over the tensor leaves of nested state dataclasses — the
port's counterpart of jax.tree.map for the per-stream state."""

from __future__ import annotations

import dataclasses


def tree_map(fn, state, *rest):
    """Apply `fn` leaf-wise to one or more dataclasses of the same type whose
    fields are tensors or further such dataclasses; returns a new one."""
    if dataclasses.is_dataclass(state):
        return type(state)(**{
            f.name: tree_map(fn, getattr(state, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(state)})
    return fn(state, *rest)


def tree_leaves(state) -> list:
    """The tensor leaves in field order."""
    if dataclasses.is_dataclass(state):
        out = []
        for f in dataclasses.fields(state):
            out.extend(tree_leaves(getattr(state, f.name)))
        return out
    return [state]
