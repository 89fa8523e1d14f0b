"""Maps over nested tuples, lists and dicts of tensors (the pools' values,
the mesh's batches), and a tensor's memory order (the pools and the mesh
keep each leaf in the order its strides give)."""
from __future__ import annotations

from typing import Callable

import torch


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of tuples, lists and dicts (and of trees of the
    same structure in `rest`); any other object is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def memory_order(t: torch.Tensor) -> list:
    """t's dims from the outermost in memory to the innermost."""
    return sorted(range(t.dim()), key=lambda d: -t.stride(d))


def inverse_perm(perm: list) -> list:
    return sorted(range(len(perm)), key=perm.__getitem__)
