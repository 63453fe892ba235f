"""Record utilities for VCProg property/message records, on tensors.

A *record* is a pytree (typically a flat dict) of scalar values — the unit
the user's VCProg methods are written against (paper §III-B: vertex
properties, edge properties and messages are records with a fixed schema).
A *record batch* is the same pytree of tensors with a leading axis
(vertices or edges).

torch defaults to int64 and float64 for Python numbers; the reference keeps
int32 ids and payloads and f32 floats, so every leaf a user method returns
goes through :func:`as_leaf`, which narrows 64-bit leaves to 32 bits.
Records are also put in sorted-key order (:func:`canonical`), as JAX
flattens dicts, so two records with the same fields flatten alike
whatever order the user wrote them in.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def tree_map(fn, tree, *rest):
    return pytree.tree_map(fn, tree, *rest)


def tree_leaves(tree):
    return pytree.tree_leaves(tree)


def tree_flatten(tree):
    return pytree.tree_flatten(tree)


def tree_unflatten(leaves, spec):
    return pytree.tree_unflatten(leaves, spec)


def as_leaf(x, device=None) -> torch.Tensor:
    """A record leaf as a tensor in the reference's 32-bit dtypes."""
    t = torch.as_tensor(x, device=device)
    narrow = _NARROW.get(t.dtype)
    if narrow is not None:
        t = t.to(narrow)
    if device is not None and t.device != torch.device(device):
        t = t.to(device)
    return t


def canonical(tree):
    """The same pytree with every dict's keys in sorted order."""
    if isinstance(tree, dict):
        return {k: canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(canonical(x) for x in tree)
    return tree


def as_record(record, device=None):
    """A record (or tuple of records) with tensor leaves on `device` in
    32-bit dtypes and dict keys in sorted order."""
    return tree_map(lambda x: as_leaf(x, device), canonical(record))


def tree_gather(batch, idx):
    """Gather rows `idx` from every leaf of a record batch."""
    return tree_map(lambda a: torch.index_select(a, 0, idx), batch)


def tree_where(mask, a, b):
    """Row-wise select between two record batches; mask has the leading dim."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return torch.where(m, x, y)
    return tree_map(sel, a, b)


def tree_tile(record, n):
    """Tile a scalar record into a batch of n identical rows (a view)."""
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)), record)


def tree_concat(batches, axis=0):
    leaves0, spec = tree_flatten(batches[0])
    cols = [tree_leaves(b) for b in batches]
    return tree_unflatten([torch.cat([c[i] for c in cols], dim=axis)
                           for i in range(len(leaves0))], spec)


def tree_equal(a, b):
    """Structural + numerical equality of two record batches (host-side)."""
    la, ta = tree_flatten(canonical(a))
    lb, tb = tree_flatten(canonical(b))
    if ta != tb:
        return False
    return all(np.array_equal(_np(x), _np(y)) for x, y in zip(la, lb))


def tree_allclose(a, b, rtol=1e-5, atol=1e-6):
    la, ta = tree_flatten(canonical(a))
    lb, tb = tree_flatten(canonical(b))
    if ta != tb:
        return False
    return all(np.allclose(_np(x), _np(y), rtol=rtol, atol=atol)
               for x, y in zip(la, lb))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
