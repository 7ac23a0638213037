"""Helpers for the port's state: NamedTuples (nested or not) of tensors
with the batch axis first."""

from __future__ import annotations

import torch


def _like(t: tuple, vals: list):
    """A tuple of ``t``'s type (a NamedTuple or a plain tuple) holding vals."""
    return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)


def select_where(cond: torch.Tensor, new, old):
    """Per scenario, ``new`` where ``cond`` (B,) holds, else ``old``: two
    trees of the same structure, every leaf (B, ...)."""
    if isinstance(new, tuple):
        return _like(new, [select_where(cond, a, b) for a, b in zip(new, old)])
    return torch.where(cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim())), new, old)


def pick(index: torch.Tensor, options: list):
    """``options[index[b]]`` for each scenario b, from trees of the same
    structure: each leaf stacked across the options and gathered by
    ``index`` (B,), on the device."""
    first = options[0]
    if isinstance(first, tuple):
        return _like(first, [pick(index, [o[i] for o in options]) for i in range(len(first))])
    stacked = torch.stack(options)  # (n, B, ...)
    ix = index.reshape((1,) + index.shape + (1,) * (stacked.dim() - 2)).expand((1,) + stacked.shape[1:])
    return torch.gather(stacked, 0, ix)[0]


def named_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(dotted path, leaf) of every leaf of nested NamedTuples, tuples,
    lists and dicts, fields (and keys) in order."""
    if isinstance(tree, dict):
        return [pair for k, v in tree.items() for pair in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", None) or [str(i) for i in range(len(tree))]
        return [pair for n, v in zip(names, tree) for pair in named_leaves(v, f"{prefix}{n}.")]
    return [(prefix[:-1], tree)]


def to_device(tree, device):
    """``tree`` (nested tuples of tensors and plain values) with every
    tensor moved to ``device``; a tensor already there is returned as is."""
    if isinstance(tree, tuple):
        return _like(tree, [to_device(v, device) for v in tree])
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
