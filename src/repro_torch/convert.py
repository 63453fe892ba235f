"""Carry graphs and vertex state between numpy and the port.

The JAX package and the port each have their own `PropertyGraph` class,
with the same fields. Neither imports the other, so data crosses between
them as plain numpy: :func:`graph_arrays` reads the fields of either
class into a dict of numpy arrays, and :func:`graph_from_arrays` builds the
port's graph from such a dict. Vertex records cross as ``{name: ndarray}``
through :func:`record_to_torch` and :func:`to_numpy`; the [V, Q] leaves
of a batched run split into Q per-lane records with :func:`split_lanes`
and stack back with :func:`stack_lanes`. A distributed partition (the
`build_sharded_graph` dict of either package) becomes the port's
:class:`~repro_torch.core.engines.distributed.ShardedGraph`, whose
per-rank device tensors the engine builds, with
:func:`sharded_graph_from_arrays`. A language model's parameter tree
crosses through :func:`model_params_from_numpy`, and a training state
(parameters, AdamW moments, step) through :func:`train_state_from_numpy`.
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


def sharded_graph_from_arrays(fields: dict, reorder: str = "none"):
    """The port's ShardedGraph of a `build_sharded_graph` dict of either
    package (arrays copied to numpy): pass it as `gdev=` to run the
    port's distributed engine on that exact partition, or take one
    rank's device tensors with `.part(rank, device, schedule,
    prefetch_on)`. `reorder` names the relabeling the dict was built
    with (its `vertex_perm` / `inv_perm` carry it)."""
    from .core.engines.distributed import ShardedGraph

    def copy(v):
        if isinstance(v, dict):
            return {k: np.array(a) for k, a in v.items()}
        if v is None or isinstance(v, (int, np.integer)):
            return v
        return np.array(v)
    return ShardedGraph.from_arrays({k: copy(v) for k, v in fields.items()},
                                    reorder=reorder)


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


def split_lanes(record: dict) -> list:
    """A batched run's ``{name: [V, Q] array or tensor}`` vertex record
    (either package's) -> Q numpy records ``{name: [V]}``, lane order."""
    host = {k: np.asarray(to_numpy(v)) for k, v in record.items()}
    q = {a.shape[-1] for a in host.values()}
    if len(q) != 1:
        raise ValueError(f"leaves carry different lane counts {q}")
    return [{k: a[..., i] for k, a in host.items()} for i in range(q.pop())]


def stack_lanes(lanes: list) -> dict:
    """Q per-lane ``{name: [V]}`` records (numpy or tensors) -> one
    ``{name: [V, Q]}`` numpy record, the layout a batched run returns."""
    host = [{k: np.asarray(to_numpy(v)) for k, v in r.items()}
            for r in lanes]
    return {k: np.stack([r[k] for r in host], axis=-1) for k in host[0]}


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def model_params_from_numpy(tree: dict, cfg) -> dict:
    """The reference's LM parameter tree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) -> a state dict of
    ``models.Transformer(cfg)`` (CPU tensors, the arrays' dtypes).

    Scanned layouts stack the pattern's blocks ``"groups"/"blk{j}"`` on a
    leading [n_groups] axis: group g's block j becomes layer
    ``g * len(pattern) + j``. The unrolled layout's ``"layer{i}"`` is
    layer i, and the remainder ``"rem{i}"`` follows the body's layers."""
    pat = cfg.block_pattern
    n_body = (cfg.num_layers // len(pat)) * len(pat)
    out = {}
    for key, val in tree.items():
        if key == "groups":
            for j in range(len(pat)):
                for name, arr in _flatten(val[f"blk{j}"]):
                    for g in range(arr.shape[0]):
                        out[f"layers.{g * len(pat) + j}.{name}"] = \
                            torch.from_numpy(np.array(arr[g]))
        elif isinstance(val, dict):
            if key.startswith("layer"):
                layer = int(key[len("layer"):])
            elif key.startswith("rem"):
                layer = n_body + int(key[len("rem"):])
            else:
                layer = None
            prefix = f"layers.{layer}." if layer is not None else f"{key}."
            for name, arr in _flatten(val):
                out[prefix + name] = torch.from_numpy(np.array(arr))
        else:
            out[key] = torch.from_numpy(np.array(val))
    return out


def _field(tree, name: str, index: int):
    """A NamedTuple field of either package (or a dict entry)."""
    if isinstance(tree, dict):
        return tree[name]
    return getattr(tree, name) if hasattr(tree, name) else tree[index]


def train_state_from_numpy(tree, cfg, device="cuda", layout=None):
    """The reference's `TrainState(params, opt=AdamWState(step, m, v),
    step)` as numpy (e.g. ``jax.tree.map(np.asarray, state)``, or what its
    CheckpointManager restores) -> the port's `train.step.TrainState` on
    `device`: a Transformer holding the converted parameters (in their
    arrays' dtype, requiring grad), the moments through the same name
    mapping as f32 tensors, and both steps as int32 scalars. Given a
    `layout` of several ranks, on its device, this rank keeps only its
    shards (`train.step.Placement.state`)."""
    from . import models
    from .core.graph_device import resolve_device
    from .optim.adamw import AdamWState
    from .train.step import Placement, TrainState, trainable

    sharded = layout is not None and layout.size > 1
    device = resolve_device(layout.device if sharded else device)
    params = model_params_from_numpy(_field(tree, "params", 0), cfg)
    opt = _field(tree, "opt", 1)
    dtype = next(iter(params.values())).dtype
    model = models.Transformer(
        cfg, torch.Generator(device=device).manual_seed(0), device=device,
        dtype=dtype)
    model.load_state_dict(params, strict=True)

    def moments(t):
        return {k: v.to(device=device, dtype=torch.float32)
                for k, v in model_params_from_numpy(t, cfg).items()}

    def step(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32)

    state = TrainState(params=trainable(model),
                       opt=AdamWState(step(_field(opt, "step", 0)),
                                      moments(_field(opt, "m", 1)),
                                      moments(_field(opt, "v", 2))),
                       step=step(_field(tree, "step", 2)))
    return Placement(cfg, layout).state(state) if sharded else state
