"""Flat views of trees of tensors (dicts, lists and tuples).

Port of ``stochastic_gradient_push_tpu/utils/flatten.py`` (the original's
``gossip/utils/helpers.py:21-88``): one 1-D buffer for a tree
(:func:`flatten_tensors`, :func:`unflatten_tensors`), its leaves grouped
by dtype (:func:`group_by_dtype`), a collective applied through one flat
buffer per dtype (:func:`communicate`), the L2 norm over every leaf
(:func:`global_norm`) and :func:`is_power_of`.  :func:`flat_by_dtype`
and :func:`unflatten_by_dtype` are the one per-dtype raveling that
:func:`communicate`, the transports' grouped means
(``parallel/collectives.py``) and ``parallel/averaging.py`` share; on
rank-stacked leaves they keep the leading rank dim.

Leaf order is the reference's: ``jax.tree.flatten`` visits a dict's keys
sorted, where a Python dict keeps insertion order, so a dict's leaves
are taken in sorted key order, and a flat buffer equals the reference's
``ravel_pytree`` element for element (its dtype the leaves' promoted
one; unflattening casts each leaf back).  Lists and tuples keep their
order; None is an empty subtree, as in JAX.
"""

from __future__ import annotations

import functools
import math
import typing as tp

import torch

__all__ = ["tree_leaves", "tree_unflatten", "flatten_tensors",
           "unflatten_tensors", "flat_by_dtype", "unflatten_by_dtype",
           "group_by_dtype", "communicate", "global_norm", "is_power_of"]


def tree_leaves(tree) -> list:
    """The tree's leaves in the reference's order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves) -> tp.Any:
    """A tree of ``tree``'s structure (its dicts in their own key order)
    holding ``leaves``, given in :func:`tree_leaves`' order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def flatten_tensors(tree) -> tuple[torch.Tensor, tp.Callable]:
    """The tree as one 1-D buffer, and the closure that rebuilds the
    tree from such a buffer (``ravel_pytree``)."""
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]
    if not leaves:
        return torch.zeros(0), lambda flat: tree_unflatten(tree, [])
    dtype = functools.reduce(torch.promote_types,
                             (leaf.dtype for leaf in leaves))
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    shapes = [(leaf.shape, leaf.dtype) for leaf in leaves]

    def unravel(buf: torch.Tensor):
        pieces = buf.split([math.prod(s) for s, _ in shapes])
        return tree_unflatten(tree, [p.reshape(s).to(d)
                                     for p, (s, d) in zip(pieces, shapes)])

    return flat, unravel


def unflatten_tensors(flat: torch.Tensor, unravel: tp.Callable):
    """Inverse of :func:`flatten_tensors`."""
    return unravel(flat)


def _dtype_indices(leaves) -> dict:
    """``{dtype: [leaf index, ...]}``, dtypes in first-seen order."""
    order: dict = {}
    for j, leaf in enumerate(leaves):
        order.setdefault(leaf.dtype, []).append(j)
    return order


def flat_by_dtype(leaves, stacked: bool = True) -> list:
    """The leaves raveled and concatenated per dtype: a list of ``(flat,
    [(leaf index, n), ...])``, ``flat`` ``[R, N]`` for rank-stacked
    leaves (``stacked``: the leading dim kept) or ``[N]``, so a grouped
    operation is a few launches (and one collective) over all leaves."""
    keep = 1 if stacked else 0
    return [(torch.cat([leaves[j].reshape(*leaves[j].shape[:keep], -1)
                        for j in js], -1),
             [(j, math.prod(leaves[j].shape[keep:])) for j in js])
            for js in _dtype_indices(leaves).values()]


def unflatten_by_dtype(out: list, leaves, flat, index) -> None:
    """Views of one of :func:`flat_by_dtype`'s buffers back into
    ``out``, shaped like ``leaves``."""
    off = 0
    for j, n in index:
        out[j] = flat[..., off:off + n].reshape(leaves[j].shape)
        off += n


def group_by_dtype(tree) -> dict:
    """``{dtype: [leaves]}``, each list in leaf order."""
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]
    return {dtype: [leaves[j] for j in js]
            for dtype, js in _dtype_indices(leaves).items()}


def communicate(tree, communication_op: tp.Callable):
    """``communication_op`` (a buffer to a buffer) applied to the tree
    through one flat buffer per dtype."""
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]
    out = list(leaves)
    for flat, index in flat_by_dtype(leaves, stacked=False):
        unflatten_by_dtype(out, leaves, communication_op(flat), index)
    return tree_unflatten(tree, out)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf, a float32 scalar: per-leaf sums of
    squares, added in leaf order."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(0.0)
    return torch.sqrt(sum(torch.as_tensor(leaf).float().square().sum()
                          for leaf in leaves))


def is_power_of(n: int, k: int) -> bool:
    """Whether ``n`` is a power of ``k``."""
    if not (isinstance(n, int) and isinstance(k, int)) or k < 0 or n <= 0:
        raise ValueError("n must be a positive int, k a non-negative int")
    if k <= 1:
        return n == 1
    return k ** int(round(math.log(n, k))) == n
