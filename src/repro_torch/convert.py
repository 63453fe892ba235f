"""Carry graphs and vertex state between numpy and the port.

The JAX package and the port each have their own `PropertyGraph` class,
with the same fields. Neither imports the other, so data crosses between
them as plain numpy: :func:`graph_arrays` reads the fields of either
class into a dict of numpy arrays, and :func:`graph_from_arrays` builds the
port's graph from such a dict. Vertex records cross as ``{name: ndarray}``
through :func:`record_to_torch` and :func:`to_numpy`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import records
from .core.graph import PropertyGraph

#: the PropertyGraph fields, in declaration order
GRAPH_FIELDS = tuple(f.name for f in dataclasses.fields(PropertyGraph))


def graph_arrays(graph) -> dict:
    """The fields of a PropertyGraph (of either package) as numpy values:
    arrays for the edge/vertex data, dicts of arrays for the property
    records, and plain Python values for `num_vertices`/`directed`."""
    out = {}
    for name in GRAPH_FIELDS:
        v = getattr(graph, name)
        if isinstance(v, dict):
            out[name] = {k: np.asarray(a) for k, a in v.items()}
        elif isinstance(v, np.ndarray):
            out[name] = np.asarray(v)
        else:
            out[name] = v
    return out


def graph_from_arrays(fields: dict) -> PropertyGraph:
    """The port's PropertyGraph from a :func:`graph_arrays` dict (copied,
    so later edits to the source arrays do not reach it)."""
    kw = {}
    for name in GRAPH_FIELDS:
        v = fields[name]
        if isinstance(v, dict):
            kw[name] = {k: np.array(a) for k, a in v.items()}
        elif isinstance(v, np.ndarray):
            kw[name] = np.array(v)
        else:
            kw[name] = v
    return PropertyGraph(**kw)


def record_to_torch(record: dict, device="cpu") -> dict:
    """``{name: ndarray}`` vertex record -> ``{name: tensor}`` on `device`
    (copied), keeping int32/f32 leaves as they are."""
    return {k: records.as_leaf(np.array(v), device)
            for k, v in record.items()}


def to_numpy(tree):
    """Every tensor leaf of a pytree (or a bare tensor) as a numpy array."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x
    return records.tree_map(leaf, tree)
