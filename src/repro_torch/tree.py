"""Trees of tensors: nested dicts, lists and dataclasses (the port's
counterpart of the ``jax.tree`` functions its reference uses).

A leaf is anything that is not a dict, list, tuple or dataclass: a
tensor, a ``Stacked`` group, a number.  ``None`` is an empty tree, as in
JAX.  Dicts are walked in sorted key order, as JAX flattens them, so two
trees with the same keys flatten alike whatever their insertion order.
Leaf names follow ``jax.tree_util.keystr``: ``['key']`` for a dict entry,
``[i]`` for a list item, ``.field`` for a dataclass field.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class Stacked:
    """Same-shape per-layer tensors that the reference holds as one leaf
    stacked on a leading axis.  The port keeps one dict per layer; a tree
    of ``Stacked`` leaves is its view in the reference's layout, made
    without a copy, so that what the reference computes over a whole leaf
    (a decay rule on ``ndim``, a factored moment, a quantisation scale)
    spans the same tensors here."""

    members: list[Tensor]

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.members),) + tuple(self.members[0].shape)

    def dim(self) -> int:
        return 1 + self.members[0].dim()

    def stack(self) -> Tensor:
        """The stacked tensor (a copy)."""
        return torch.stack(self.members)

    def write(self, stacked: Tensor) -> None:
        """Copy ``stacked[r]`` into member ``r``."""
        for r, m in enumerate(self.members):
            m.copy_(stacked[r])


def zeros_f32(leaf: Tensor | Stacked, shape=None,
              dims: tuple[int, ...] | None = None) -> Tensor:
    """f32 zeros of ``shape`` (default the leaf's, a ``Stacked`` leaf's
    stacked shape) on the leaf's device.  For a DTensor leaf (or members)
    the zeros are a DTensor placed as the leaf is: ``dims`` names the
    leaf's dimensions that ``shape`` keeps, in order (default all), and a
    dimension that is dropped is no longer sharded."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    lead = leaf.members[0] if isinstance(leaf, Stacked) else leaf
    z = torch.zeros(tuple(leaf.shape if shape is None else shape),
                    dtype=torch.float32, device=lead.device)
    if not isinstance(lead, DTensor):
        return z
    off = 1 if isinstance(leaf, Stacked) else 0
    dims = tuple(range(len(leaf.shape))) if dims is None else tuple(dims)
    pl = []
    for q in lead.placements:
        d = q.dim + off if isinstance(q, Shard) else None
        pl.append(Shard(dims.index(d)) if d in dims else Replicate())
    return distribute_tensor(z, lead.device_mesh, pl, src_data_rank=None)


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple)) or (
        dataclasses.is_dataclass(x) and not isinstance(x, (type, Stacked)))


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); dicts come back as dicts,
    lists and tuples as lists, dataclasses as copies.  ``is_leaf`` marks
    further nodes as leaves."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)

    def sub(v, *r):
        return tree_map(fn, v, *r, is_leaf=is_leaf)

    if isinstance(tree, dict):
        return {k: sub(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [sub(v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if _is_node(tree):
        return dataclasses.replace(tree, **{
            f.name: sub(getattr(tree, f.name),
                        *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def named_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(name, leaf)`` in the tree's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    elif _is_node(tree):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, v in items:
        out.extend(named_leaves(v, prefix + key))
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in its order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tensors(tree: Any) -> list[Tensor]:
    """Every tensor of the tree, a ``Stacked`` leaf's members in order."""
    out = []
    for leaf in tree_leaves(tree):
        out.extend(leaf.members if isinstance(leaf, Stacked) else [leaf])
    return out
