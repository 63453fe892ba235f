"""Logical-axis sharding rules with divisibility-aware fallback, and the
pieces that make a model's parameters live sharded over a rank layout.

The reference's `repro/distributed/sharding.py`, on a
`launch.mesh.RankLayout` (or anything with `axis_names` and a shape:
`shape`, or `devices.shape` as a `jax.sharding.Mesh` has). Model code
names array dims with *logical* axes ("vocab", "mlp", "batch", ...); this
module resolves them to partition specs. Resolution walks the rule's
candidate list and picks the first candidate whose rank-axis product
divides the dim size — so starcoder2's 36 heads fall back off a 16-way
"model" axis, granite's 49155 vocab falls back off "model", and batch=1
(long_500k) falls back to replicated. A spec is a tuple with one entry a
dim: None (replicated), an axis name, or a tuple of axis names fused
row-major (`RankLayout.axis_index`).

Two rule tables: PARAM_RULES (weights; includes the FSDP "embed"→data
rule) and ACT_RULES (activations / caches / inputs).

The reference hands the specs to `jax.jit`, whose SPMD partitioner
places the arrays and inserts the collectives. Eager PyTorch has no
partitioner, so the port does it explicitly (`train/step.py`):

  * The tokens: a batch of B rows of T tokens splits its rows over the
    axes the "batch" rule resolves to and its sequence over those the
    "seq" rule resolves to ("model" under the default profile when T
    divides, the reference's sequence parallelism; `token_axes_for`).
    The token axes are both; this rank holds one block of T / n_seq
    positions of its rows (`TokenSplit`), and no two ranks hold the same
    token. Under the "dp" profile the batch spans every axis and the
    sequence is whole.
  * `shard_tensor` keeps this rank's block of a whole tensor;
  * `gather_param` / `gather_params` (an autograd Function) all-gather
    parameters' shards to whole tensors where they are used (a block's
    tensors split along one dim over the same axes in one buffer, one
    collective); the backward sums each whole gradient back onto its
    shard: a reduce-scatter over the spec's axes that split the tokens,
    this rank's block over the spec's axes that do not (their ranks
    computed the same gradient), and an all-reduce over the token axes
    the spec does not use, a buffer each. A dim whose axes are in
    `keep` stays sharded (the MoE layer's own experts under expert
    parallelism, `ShardPlan.gather`): its ranks compute other work, so
    nothing is summed over them;
  * `gather_seq` (an all-gather along a dim whose backward
    reduce-scatters) and `scatter_seq` (a reduce-scatter whose backward
    all-gathers) move activations between sequence blocks: k and v
    gathered per attention layer, the MoE layer's inputs gathered and
    its partial outputs scattered, a recurrent block's input gathered
    for its whole-sequence scan;
  * `psum` is an all-reduce whose backward is an all-reduce too (the
    MoE aux loss's global means, over the token axes; a sum of partials
    that each rank then uses for its own channels, as a norm's sum of
    squares);
  * A decode step (one token a row) has no sequence to split: its
    split (`ShardPlan.decode_split`, `decode_axes`) takes the
    rows over the "batch" axes and, over the axes the reference's decode
    rules give "act_heads", "act_kv_heads", "act_mlp", "act_vocab",
    "act_experts" and "cache_seq" once "batch" has taken its own (the
    tensor-parallel axes: "model" under the default profile), the
    heads, the MLP width, the vocabulary, the experts and the caches'
    positions, each where its size divides (`TokenSplit.over`; a
    recurrent block's state names are resolved on that block's own
    sizes, `decode_dims`). The weights then keep those dims sharded
    (`ShardPlan._keep`; a recurrent block's "rnn" dims where all of them
    split) and the layers run Megatron-style: column- then row-parallel
    products whose partial sums cross in f32, a vocab-parallel embedding
    and LM head, attention over the rank's block of the cache
    (`models/layers.py`), the MoE layer's own experts on the global
    batch's one token group (`models/moe.py`), and each recurrent
    block's own channels or heads (`models/recurrent.py`);
  * A training or prefill step whose T the "seq" rule cannot split (the
    tensor-parallel arm) resolves its split like a decode step's, with
    T positions: every rank of the tensor-parallel axes holds the same
    tokens and computes its share of the heads, MLP width, vocabulary,
    experts and recurrent channels. Its ends are Megatron's pair:
    `tp_enter` (identity forward, all-reduce backward) where a
    replicated activation, or a replicated weight, enters a rank's
    share of the work (`ShardPlan.gather` passes such weights through
    it), `tp_exit` (all-reduce forward, identity backward) where the
    ranks' partial sums become one replicated activation, and
    `tp_gather` (all-gather forward, this rank's block backward) for the
    vocab-parallel logits and the router's;
  * `ShardPlan` holds a model's specs and the split of the current
    batch, and `shard_model` turns a whole `models.Transformer` into
    this rank's shards with the plan attached (`Transformer.forward`
    gathers each block's weights through it and hands the split to the
    blocks; the gathers are tallied under the tag "weights").

`logical_constraint` computes nothing in eager PyTorch (there is no
partitioner to constrain), so it returns `x` unchanged, as the reference
does outside a mesh.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

log = logging.getLogger("repro_torch.sharding")

Candidate = Tuple[str, ...]          # rank axes fused for one dim
RuleTable = Dict[str, Sequence[Candidate]]

# Weights. "embed" on a param is the FSDP axis (gathered at use);
# "mlp"/"heads"/"vocab"/"experts" are the TP/EP axes.
PARAM_RULES: RuleTable = {
    "vocab": [("model",), ()],
    "embed": [("data",), ()],              # FSDP / ZeRO-3
    "heads": [("model",), ()],
    "kv_heads": [("model",), ()],
    "head_dim": [()],
    "mlp": [("model",), ()],
    "experts": [("model",), ()],           # EP
    "expert_mlp": [()],                    # within-expert width under EP
    "rnn": [("model",), ()],
    "conv": [()],
    "layers": [()],                        # scan-stacked dim, never sharded
    None: [()],
}

# Activations / inputs / caches.
ACT_RULES: RuleTable = {
    "batch": [("pod", "data"), ("data",), ()],
    # sequence parallelism over the TP axis: each rank along it computes
    # its own block of positions, k/v gathered per attention layer
    "seq": [("model",), ()],
    "act_embed": [()],
    "act_heads": [("model",), ()],
    "act_kv_heads": [("model",), ()],
    "act_mlp": [("model",), ()],
    "act_experts": [("model",), ()],
    "cache_seq": [("model",), ()],          # sequence-sharded KV cache
    "act_vocab": [("model",), ()],
    None: [()],
}


# Per-arch activation profiles:
#   default  sequence parallelism over the TP axis (general fallback)
#   dp       pure data parallelism: batch shards over EVERY rank axis,
#            seq unsharded
def rules_for_profile(profile: str) -> RuleTable:
    if profile == "dp":
        rules = dict(ACT_RULES)
        rules["batch"] = [("pod", "data", "model"), ("data", "model"),
                          ("pod", "data"), ("data",), ()]
        rules["seq"] = [()]
        return rules
    return ACT_RULES


def _axis_sizes(mesh) -> Dict[str, int]:
    shape = mesh.devices.shape if hasattr(mesh, "devices") else mesh.shape
    return dict(zip(mesh.axis_names, shape))


def resolve_dim(logical: Optional[str], size: int, mesh, rules: RuleTable,
                taken: set):
    """First divisible candidate whose axes exist in the layout and are not
    already used by another dim of the same array."""
    sizes = _axis_sizes(mesh)
    for cand in rules.get(logical, [()]):
        axes = tuple(a for a in cand if a in sizes)
        if not axes:
            if cand == () or cand is None:
                return None
            continue
        if any(a in taken for a in axes):
            continue
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if size % prod == 0:
            taken.update(axes)
            return axes if len(axes) > 1 else axes[0]
    return None


def spec_for(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh, rules: RuleTable) -> tuple:
    taken: set = set()
    entries = [resolve_dim(a, s, mesh, rules, taken)
               for a, s in zip(logical_axes, shape)]
    fell_back = [a for a, e in zip(logical_axes, entries)
                 if a is not None and rules.get(a, [()])[0] != () and e is None]
    if fell_back:
        log.debug("sharding fallback to replicated for logical axes %s "
                  "(shape %s)", fell_back, tuple(shape))
    return tuple(entries)


def param_spec(logical_axes, shape, mesh) -> tuple:
    return spec_for(logical_axes, shape, mesh, PARAM_RULES)


def act_spec(logical_axes, shape, mesh) -> tuple:
    return spec_for(logical_axes, shape, mesh, ACT_RULES)


def tree_param_specs(spec_tree: dict, shape_tree: dict, mesh) -> dict:
    """Resolve {name: logical axes} against {name: shape (or anything
    with `.shape`)} -> {name: spec}."""
    return {k: param_spec(axes, getattr(shape_tree[k], "shape",
                                        shape_tree[k]), mesh)
            for k, axes in spec_tree.items()}


# ---------------------------------------------------------------------------
# Layout context: model code calls logical_constraint() without a layout
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def mesh_rules(mesh, act_rules: RuleTable = None):
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, act_rules or ACT_RULES)
    try:
        yield
    finally:
        _CTX.state = prev


def logical_constraint(x, *logical_axes):
    """The reference's with_sharding_constraint by logical names. Eager
    PyTorch has no partitioner to constrain, so this returns `x` as it
    is, inside `mesh_rules` or not (the reference's own behaviour
    outside a mesh)."""
    return x


# ---------------------------------------------------------------------------
# Shards of whole tensors
# ---------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis a spec uses, in dim order."""
    return tuple(a for e in spec for a in entry_axes(e))


def shard_shape(shape, spec, layout) -> tuple:
    """The shape of one rank's block of a tensor of `shape`."""
    return tuple(n // layout.axis_size(entry_axes(e)) if e is not None
                 else n for n, e in zip(shape, spec))


def shard_tensor(full: torch.Tensor, spec, layout) -> torch.Tensor:
    """This rank's block of `full` under `spec` (a copy)."""
    x = full
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if not axes:
            continue
        n = layout.axis_size(axes)
        x = torch.chunk(x, n, dim=d)[layout.axis_index(axes)]
    return x.clone()


def _gathered(spec, layout, keep=()):
    """[(dim, axes)] of the dims `spec` splits over more than one rank,
    but those whose axes all lie in `keep` (left sharded)."""
    return [(d, entry_axes(e)) for d, e in enumerate(spec)
            if entry_axes(e) and layout.axis_size(entry_axes(e)) > 1
            and not all(a in keep for a in entry_axes(e))]


def _gather_dim(x, comm, d):
    parts = comm.all_gather(x.contiguous())
    return torch.cat(list(parts.unbind(0)), dim=d)


def _scatter_dim(x, comm, d):
    """The sum over `comm`'s ranks of `x`, cut along dim d to this rank's
    block (a reduce-scatter)."""
    moved = x.movedim(d, 0).contiguous()
    return comm.psum_scatter(moved).movedim(0, d)


def _buckets(tensors, specs, layout, keeps):
    """Tensors split along exactly one dim, by (axes, dtype): {key:
    [(index, dim)]}, each bucket one collective."""
    out = {}
    for i, (t, spec, keep) in enumerate(zip(tensors, specs, keeps)):
        dims = _gathered(spec, layout, keep)
        if len(dims) == 1:
            d, axes = dims[0]
            out.setdefault((axes, t.dtype), []).append((i, d))
    return out


class _Gather(torch.autograd.Function):
    """shards -> whole tensors (but the dims kept sharded); the backward
    sums each whole gradient back onto its shard (module docstring). The
    tensors split along one dim over the same axes travel in one buffer,
    a collective a bucket."""

    @staticmethod
    def forward(ctx, layout, token_axes, specs, keeps, *shards):
        ctx.layout, ctx.token_axes = layout, token_axes
        ctx.specs, ctx.keeps = specs, keeps
        outs = []
        for s, spec, keep in zip(shards, specs, keeps):
            x = s
            dims = _gathered(spec, layout, keep)
            if len(dims) > 1:       # the vocab x embed tables
                for d, axes in dims:
                    x = _gather_dim(x, layout.comm(axes), d)
            outs.append(x if x is not s else s.view_as(s))
        for (axes, _), members in _buckets(shards, specs, layout,
                                           keeps).items():
            comm = layout.comm(axes)
            parts = comm.all_gather(torch.cat(
                [shards[i].movedim(d, 0).reshape(-1) for i, d in members]))
            off = 0
            for i, d in members:
                moved = shards[i].movedim(d, 0)
                n = moved.numel()
                full = parts[:, off:off + n].reshape(
                    (comm.size * moved.shape[0],) + tuple(moved.shape[1:]))
                outs[i] = full.movedim(0, d).contiguous()
                off += n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        layout, batch, specs = ctx.layout, ctx.token_axes, ctx.specs
        gin = list(grads)
        for i, (spec, keep) in enumerate(zip(specs, ctx.keeps)):
            dims = _gathered(spec, layout, keep)
            if len(dims) > 1:
                for d, axes in reversed(dims):
                    gin[i] = _cut(gin[i], d, axes, layout, batch)
        for (axes, _), members in _buckets(grads, specs, layout,
                                           ctx.keeps).items():
            if not all(a in batch for a in axes):
                for i, d in members:
                    gin[i] = _cut(grads[i], d, axes, layout, batch)
                continue
            # row r of the bucket: rank r's block of every member
            P = layout.axis_size(axes)
            mine = layout.comm(axes).psum_scatter(torch.cat(
                [grads[i].movedim(d, 0).reshape(P, -1) for i, d in members],
                dim=1)).reshape(-1)
            off = 0
            for i, d in members:
                moved = grads[i].movedim(d, 0)
                shape = (moved.shape[0] // P,) + tuple(moved.shape[1:])
                n = moved.numel() // P
                gin[i] = mine[off:off + n].reshape(shape).movedim(0, d)
                off += n
        # the token axes a spec does not use: an all-reduce a bucket
        rest = {}
        for i, spec in enumerate(specs):
            axes = tuple(a for a in layout.axis_names
                         if a in batch and a not in spec_axes(spec))
            if axes and layout.axis_size(axes) > 1:
                rest.setdefault((axes, gin[i].dtype), []).append(i)
        for (axes, _), idx in rest.items():
            tot = layout.comm(axes).psum(torch.cat(
                [gin[i].reshape(-1) for i in idx]))
            off = 0
            for i in idx:
                n = gin[i].numel()
                gin[i] = tot[off:off + n].reshape(gin[i].shape)
                off += n
        return (None, None, None, None) + tuple(g.contiguous() for g in gin)


def _cut(g, d, axes, layout, batch):
    """The gradient of dim d's gather over `axes`: summed and scattered
    over token axes (`batch`), this rank's block over the others."""
    inb = [a in batch for a in axes]
    if all(inb):
        moved = g.movedim(d, 0).contiguous()
        return layout.comm(axes).psum_scatter(moved).movedim(0, d)
    if not any(inb):
        return torch.chunk(g, layout.axis_size(axes),
                           dim=d)[layout.axis_index(axes)]
    raise ValueError(f"spec entry {axes} mixes token axes {batch} with "
                     "others")


def gather_params(shards, specs, layout,
                  token_axes: Tuple[str, ...] = (), keeps=None) -> tuple:
    """The whole parameters from this rank's shards: an all-gather along
    every dim their specs split (but a dim whose axes all lie in the
    tensor's `keeps` entry), one collective for all the tensors split
    along one dim over the same axes. Differentiable: the gradient
    reaching a whole tensor comes back summed over the ranks that split
    the tokens (`token_axes`) and cut to this rank's shard (module
    docstring)."""
    keeps = tuple(tuple(k) for k in keeps) if keeps is not None \
        else ((),) * len(specs)
    return _Gather.apply(layout, tuple(token_axes),
                         tuple(tuple(s) for s in specs), keeps, *shards)


def gather_param(shard: torch.Tensor, spec, layout,
                 token_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """`gather_params` of one tensor."""
    return gather_params([shard], [spec], layout, token_axes)[0]


# ---------------------------------------------------------------------------
# Activations between sequence blocks
# ---------------------------------------------------------------------------

class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, tag):
        ctx.comm, ctx.dim, ctx.tag = comm, dim, tag
        with comm.tagged(tag):
            return _gather_dim(x, comm, dim)

    @staticmethod
    def backward(ctx, g):
        with ctx.comm.tagged(ctx.tag):
            return _scatter_dim(g, ctx.comm, ctx.dim), None, None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, tag):
        ctx.comm, ctx.dim, ctx.tag = comm, dim, tag
        with comm.tagged(tag):
            return _scatter_dim(x, comm, dim)

    @staticmethod
    def backward(ctx, g):
        with ctx.comm.tagged(ctx.tag):
            return _gather_dim(g, ctx.comm, ctx.dim), None, None, None


def gather_seq(x: torch.Tensor, comm, dim: int = 1,
               tag: Optional[str] = None) -> torch.Tensor:
    """The ranks' blocks of `x` concatenated along `dim` in `comm`'s rank
    order (an all-gather). Differentiable: every rank's gradient of the
    whole comes back summed onto each block (a reduce-scatter). An
    integer `x` is gathered without autograd. `tag` names the
    collectives in the Comm's `by_tag` tally."""
    if comm is None or comm.size == 1:
        return x
    if not x.is_floating_point():
        with comm.tagged(tag):
            return _gather_dim(x, comm, dim)
    return _GatherSeq.apply(x, comm, dim, tag)


def scatter_seq(x: torch.Tensor, comm, dim: int = 1,
                tag: Optional[str] = None) -> torch.Tensor:
    """The sum over `comm`'s ranks of `x`, cut along `dim` to this rank's
    block (a reduce-scatter): the ranks' partial sums of every block, each
    rank keeping its own. Differentiable: the backward all-gathers the
    blocks' gradients."""
    if comm is None or comm.size == 1:
        return x
    return _ScatterSeq.apply(x, comm, dim, tag)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.psum(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.psum(g.contiguous()), None


def psum(x: torch.Tensor, comm) -> torch.Tensor:
    """Sum over `comm`'s ranks, differentiable: every rank's loss reads
    the sum, so each input's gradient is the sum of the ranks' gradients
    of it (an all-reduce both ways)."""
    if comm is None or comm.size == 1:
        return x
    return _Psum.apply(x, comm)


class _TpEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with ctx.comm.tagged("tp"):
            return ctx.comm.psum(g.contiguous()), None


class _TpExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.psum(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return _gather_dim(x, comm, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.chunk(g, ctx.comm.size, dim=ctx.dim)[
            ctx.comm.rank].contiguous(), None, None


def tp_enter(x: torch.Tensor, comm) -> torch.Tensor:
    """Megatron's f: `x` (replicated over `comm`'s ranks, which hold the
    same tokens) as it enters each rank's share of the work. Identity
    forward; the backward sums the ranks' partial gradients of it (an
    all-reduce)."""
    if comm is None or comm.size == 1 or not torch.is_grad_enabled():
        return x
    return _TpEnter.apply(x, comm)


def tp_exit(x: torch.Tensor, comm) -> torch.Tensor:
    """Megatron's g: the sum over `comm`'s ranks of their partials (an
    all-reduce), a replicated activation whose gradient every rank
    already holds whole: the backward passes it through."""
    if comm is None or comm.size == 1:
        return x
    if not torch.is_grad_enabled():
        return comm.psum(x.contiguous())
    return _TpExit.apply(x, comm)


def tp_gather(x: torch.Tensor, comm, dim: int) -> torch.Tensor:
    """The ranks' blocks of `x` concatenated along `dim` (an all-gather)
    into a replicated tensor whose gradient every rank holds whole: the
    backward keeps this rank's block of it."""
    if comm is None or comm.size == 1:
        return x
    dim %= x.ndim
    if not torch.is_grad_enabled():
        return _gather_dim(x, comm, dim)
    return _TpGather.apply(x, comm, dim)


# ---------------------------------------------------------------------------
# A model's parameters over a layout
# ---------------------------------------------------------------------------

def batch_axes_for(shape, layout, rules: RuleTable) -> Tuple[str, ...]:
    """The rank axes that split a batch of `shape` (dim 0, the "batch"
    rule), in layout order; () when it falls back to replicated."""
    spec = spec_for(("batch",) + (None,) * (len(shape) - 1), shape, layout,
                    rules)
    return entry_axes(spec[0])


def token_axes_for(rows: int, seq_len: Optional[int], layout,
                   rules: RuleTable) -> Tuple[Tuple[str, ...],
                                              Tuple[str, ...]]:
    """(batch axes, seq axes) of a batch of `rows` sequences of
    `seq_len` positions: the "batch" and "seq" rules resolved together
    (an axis serves one of them), the seq axes without those of size 1.
    No sequence (`seq_len` None: a decode step's one token) splits
    none."""
    if seq_len is None:
        return batch_axes_for((rows,), layout, rules), ()
    spec = spec_for(("batch", "seq"), (rows, seq_len), layout, rules)
    seq = tuple(a for a in entry_axes(spec[1]) if layout.axis_size(a) > 1)
    return entry_axes(spec[0]), seq


#: a tensor-parallel name (the reference's act rules) -> the logical axis
#: of the weights' dims it splits; a recurrent block's state names carry
#: its kind ("mlstm.act_heads") and name no weight dim (its "rnn" dims
#: follow their own rule, `ShardPlan._keep`)
TP_NAMES = {"act_heads": "heads", "act_kv_heads": "kv_heads",
            "act_mlp": "mlp", "act_vocab": "vocab",
            "act_experts": "experts", "cache_seq": None}


def decode_dims(cfg) -> Dict[str, int]:
    """The sizes the tensor-parallel names resolve against, each on its
    own array (as the reference's `spec_for` resolves each array): the
    attention layers' heads and kv heads, the MLP's width (`d_ff`, where
    a block has an MLP), the experts and the padded vocabulary; the
    mLSTM states' heads and conv width (`mlstm_proj_factor` x d), the
    sLSTM states' heads and the RG-LRU width (`rnn_width_`), of the
    block kinds the config has."""
    kinds = set(cfg.layer_types)
    dims = {"act_vocab": cfg.padded_vocab}
    if kinds & {"attn", "local", "moe"}:
        dims.update(act_heads=cfg.num_heads, act_kv_heads=cfg.num_kv_heads)
    if kinds & {"attn", "local"} or ("rglru" in kinds and cfg.d_ff):
        dims["act_mlp"] = cfg.d_ff
    if "moe" in kinds:
        dims["act_experts"] = cfg.num_experts
    if "mlstm" in kinds:
        dims["mlstm.act_heads"] = cfg.num_heads
        dims["mlstm.act_mlp"] = int(cfg.mlstm_proj_factor * cfg.d_model)
    if "slstm" in kinds:
        dims["slstm.act_heads"] = cfg.num_heads
    if "rglru" in kinds:
        dims["rglru.act_mlp"] = cfg.rnn_width_
    return {k: v for k, v in dims.items() if v}


def decode_axes(rows: int, dims: Dict[str, int], cache_len: Optional[int],
                layout, rules: RuleTable, seq_len: int = 1):
    """(batch axes, tensor-parallel axes, the names that split over them)
    of a step of `rows` rows of `seq_len` positions, as the reference
    resolves its activations: q/k/v `("batch", "seq", "act_heads" |
    "act_kv_heads", None)`, the MLP's hidden `("batch", "seq",
    "act_mlp")`, the logits `("batch", "seq", "act_vocab")` (a decode
    step's T = 1, or a T the "seq" rule cannot split: "seq" falls back
    and these take its axes), a recurrent block's states by their own
    names, and the caches `("batch", "cache_seq", None, None)` of
    `cache_len` positions (None: the caches are whole, or there are
    none). Each name is resolved on its own array against its real size
    (`dims`, `decode_dims`), so each falls back by divisibility alone;
    the tensor-parallel axes are the axes they take (axes of size 1
    dropped), which must be one set."""
    batch = batch_axes_for((rows,), layout, rules)
    got = {}
    for key, size in dims.items():
        name = key.rpartition(".")[2]
        spec = spec_for(("batch", "seq", name), (rows, seq_len, size),
                        layout, rules)
        got[key] = entry_axes(spec[2])
    if cache_len:
        spec = spec_for(("batch", "cache_seq"), (rows, cache_len), layout,
                        rules)
        got["cache_seq"] = entry_axes(spec[1])
    got = {k: tuple(a for a in v if layout.axis_size(a) > 1)
           for k, v in got.items()}
    tp = tuple(a for a in layout.axis_names
               if any(a in v for v in got.values()))
    odd = {k: v for k, v in got.items() if v and v != tp}
    if odd:
        raise ValueError(f"the decode rules split {odd} over other axes "
                         f"than {tp}")
    return batch, tp, frozenset(k for k, v in got.items() if v)


class TokenSplit(NamedTuple):
    """How this rank's tokens sit in a global batch: `batch_comm` over
    the ranks that split its rows, `seq_comm` over those that split its
    sequence (`seq_axes`; each rank holds `length` positions from `q0`
    on), `token_comm` over both (`token_axes`, in layout order): the
    loss's and the MoE aux loss's means run over it, and the parameters'
    gradients are summed over it. A decode step's split (`decode`) has
    no sequence; `tp_comm` runs over its tensor-parallel axes
    (`tp_axes`), and `tp` names what splits over them (`decode_axes`,
    `over`). A training or prefill split with `tp` (and no sequence
    split) is the tensor-parallel arm: its ranks along `tp_axes` hold
    the same tokens."""
    batch_comm: Any
    seq_comm: Any
    token_comm: Any
    token_axes: Tuple[str, ...]
    seq_axes: Tuple[str, ...] = ()
    q0: int = 0
    length: Optional[int] = None
    decode: bool = False
    tp_comm: Any = None
    tp_axes: Tuple[str, ...] = ()
    tp: frozenset = frozenset()

    @property
    def seq(self) -> bool:
        """Whether the sequence is split over more than one rank."""
        return self.seq_comm.size > 1

    @property
    def n(self) -> int:
        """The number of token shards (ranks holding distinct tokens)."""
        return self.token_comm.size

    def own(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of a whole sequence along `dim`."""
        if not self.seq:
            return x
        return x.narrow(dim, self.q0, self.length)

    def over(self, name: str):
        """The Comm over the ranks that split `name` (TP_NAMES) between
        them on a decode step or the tensor-parallel arm, or None where it
        is whole on every rank."""
        return self.tp_comm if name in self.tp else None


def counts_once(spec, layout) -> bool:
    """Whether this rank's shard of a tensor under `spec` counts in a
    global sum: a shard replicated along an axis its spec does not use
    counts on that axis's index 0 only, so each element counts once."""
    used = spec_axes(spec)
    return all(layout.axis_index(a) == 0
               for a in layout.axis_names if a not in used)


class ShardPlan:
    """How a model lives on this rank: `specs` {parameter name: spec}
    over `layout`, `logical` {name: logical axes}, the sizes a decode
    step resolves (`dims`, `decode_dims`), and the `TokenSplit` of the
    current batch (`set_batch`). The MoE layers' expert weights (leading
    "experts" dim) stay sharded where the sequence splits over the same
    axes (expert parallelism, `models/moe.py`). `rnn` holds the axes of
    each recurrent block's weights whose "rnn" dims all split over one
    set of axes ({name: axes}): those blocks run on their own channels
    under any split over those axes (`models/recurrent.py`); a block
    with a dim that does not divide runs whole."""

    def __init__(self, layout, specs: Dict[str, tuple], rules: RuleTable,
                 logical: Dict[str, tuple], dims: Dict[str, int]):
        self.layout, self.specs, self.rules = layout, dict(specs), rules
        self.logical, self.dims = dict(logical), dict(dims)
        self.experts = frozenset(k for k, v in self.logical.items()
                                 if v and v[0] == "experts")
        self.rnn = self._rnn_blocks()
        one = layout.comm(())
        self.split = TokenSplit(one, one, one, ())
        self.world_comm = layout.comm(layout.axis_names)

    def _rnn_blocks(self) -> Dict[str, Tuple[str, ...]]:
        """{parameter name: axes} of the recurrent blocks (a layer's
        "mlstm" / "slstm" / "rglru" module) whose every "rnn" dim splits
        over the same axes of more than one rank."""
        blocks: Dict[str, set] = {}
        for name, axes in self.logical.items():
            for logical, e in zip(axes, self.specs[name]):
                if logical == "rnn":
                    blocks.setdefault(_module(name), set()).add(
                        entry_axes(e))
        split = {m: next(iter(a)) for m, a in blocks.items()
                 if len(a) == 1 and self.layout.axis_size(next(iter(a))) > 1}
        return {name: split[_module(name)]
                for name, axes in self.logical.items()
                if "rnn" in axes and _module(name) in split}

    def set_batch(self, rows: int,
                  seq_len: Optional[int] = None) -> TokenSplit:
        """Resolve the token split of a global batch of `rows` sequences
        of `seq_len` positions (None: one token each, a decode step's
        split, whose caches `decode_split` sizes), made the plan's."""
        self.split = self._resolve(rows, seq_len, None)
        return self.split

    def _resolve(self, rows, seq_len, cache_len) -> TokenSplit:
        """The split of `set_batch`; a decode split (`seq_len` None)
        resolves its tensor-parallel names by `decode_axes`, with caches
        of `cache_len` positions (None: whole caches), and so does a
        sequence the "seq" rule cannot split (the tensor-parallel arm,
        with its T positions)."""
        lay = self.layout
        tp_axes, tp = (), frozenset()
        if seq_len is None:
            batch, tp_axes, tp = decode_axes(rows, self.dims, cache_len,
                                             lay, self.rules)
            seq = ()
        else:
            batch, seq = token_axes_for(rows, seq_len, lay, self.rules)
            if not seq:
                _, tp_axes, tp = decode_axes(rows, self.dims, None, lay,
                                             self.rules, seq_len)
        tokens = tuple(a for a in lay.axis_names if a in batch + seq)
        length = None if seq_len is None else seq_len // lay.axis_size(seq)
        q0 = lay.axis_index(seq) * length if seq else 0
        # every group the step uses, built here in the same order on every
        # rank rather than first inside autograd
        comms = [lay.comm(batch), lay.comm(seq), lay.comm(tokens)]
        tp_comm = lay.comm(tp_axes)
        for spec in dict.fromkeys(self.specs.values()):
            for e in spec:
                lay.comm(entry_axes(e))
            lay.comm(tuple(a for a in lay.axis_names
                           if a in tokens and a not in spec_axes(spec)))
        return TokenSplit(*comms, tokens, seq, q0, length, seq_len is None,
                          tp_comm, tp_axes, tp)

    def decode_split(self, rows: int,
                     cache_len: Optional[int] = None) -> TokenSplit:
        """The decode split of this rank's `rows` rows (the plan's split
        stays): the global rows are those of the current split's batch
        (a prefill's or a serve step's), the caches hold `cache_len`
        positions."""
        s = self.split
        batch = tuple(a for a in s.token_axes if a not in s.seq_axes)
        return self._resolve(rows * self.layout.axis_size(batch), None,
                             cache_len)

    def for_decode(self, rows: int,
                   cache_len: Optional[int] = None) -> TokenSplit:
        """`decode_split`, made the plan's: a decode step never runs on
        a prefill's split."""
        self.split = self.decode_split(rows, cache_len)
        return self.split

    def rows_only(self) -> TokenSplit:
        """The split without its sequence or tensor-parallel split, made
        the plan's: each rank runs its rows whole (a forward called on a
        decode step's split)."""
        s = self.split
        batch = tuple(a for a in s.token_axes if a not in s.seq_axes)
        self.split = TokenSplit(s.batch_comm, self.layout.comm(()),
                                s.batch_comm, batch)
        return self.split

    def counted(self, name: str) -> bool:
        """`counts_once` of parameter `name`'s shard on this rank."""
        return counts_once(self.specs[name], self.layout)

    def _keep(self, name: str) -> Tuple[str, ...]:
        """The axes along which parameter `name` stays sharded when
        gathered: under a sequence split an expert weight's "experts" dim
        where it is split over exactly the sequence's axes (each rank
        computes its own experts for the whole sequence); under a decode
        split or the tensor-parallel arm the dim whose logical axis
        (heads, kv_heads, mlp, vocab, experts) the split's tensor-parallel
        axes split (each rank computes its own block of it); under either
        a recurrent block's "rnn" dims where all of them split over those
        axes (`rnn`); else none. FSDP's "embed" dim is gathered."""
        s, spec = self.split, self.specs[name]
        axes = s.seq_axes if s.seq else s.tp_axes
        if not axes:
            return ()
        if self.rnn.get(name) == axes:
            return axes
        if s.seq:
            if name in self.experts and entry_axes(spec[0]) == axes:
                return axes
            return ()
        kept = {TP_NAMES.get(n) for n in s.tp} - {None}
        for logical, e in zip(self.logical[name], spec):
            if entry_axes(e) == axes and logical in kept:
                return axes
        return ()

    def gather(self, module, prefix: str = "", recurse: bool = True,
               skip: str = None) -> Dict[str, torch.Tensor]:
        """{relative name: whole tensor} of `module`'s parameters (full
        names `prefix` + relative; the dims `_keep` names stay this
        rank's block), through one `gather_params` whose collectives are
        tallied under the tag "weights"; `skip` leaves out the names
        under that prefix. On the tensor-parallel arm a whole tensor of a
        module (a layer's attention, MLP, MoE or recurrent block) that
        keeps another's dim sharded is used inside the ranks' shares of
        the work, so it is passed through `tp_enter`."""
        named = [(name, p) for name, p in
                 module.named_parameters(recurse=recurse)
                 if skip is None or not name.startswith(skip)]
        keeps = [self._keep(prefix + n) for n, _ in named]
        with contextlib.ExitStack() as tags:
            for comm in self.layout.comms():
                tags.enter_context(comm.tagged("weights"))
            full = gather_params([p for _, p in named],
                                 [self.specs[prefix + n] for n, _ in named],
                                 self.layout, self.split.token_axes, keeps)
        s = self.split
        if s.tp and not s.decode:
            split_mods = {_module(prefix + n)
                          for (n, _), k in zip(named, keeps) if k}
            full = [tp_enter(t, s.tp_comm)
                    if not k and _module(prefix + n) in split_mods else t
                    for (n, _), t, k in zip(named, full, keeps)]
        return {n: t for (n, _), t in zip(named, full)}


def _module(name: str) -> str:
    """The module of a full parameter name whose tensors split together:
    a layer's attention, MLP, MoE, recurrent block or norm
    ("layers.3.mlstm"), else the name's first part."""
    parts = name.split(".")
    return ".".join(parts[:3]) if parts[0] == "layers" else parts[0]


@contextlib.contextmanager
def swapped(module, tensors: Dict[str, torch.Tensor]):
    """Within the block, `module`'s parameters named in `tensors` (dotted
    relative names) read as those tensors; the parameters come back on
    exit. The module's code runs unchanged on the whole weights."""
    saved = []
    try:
        for name, t in tensors.items():
            path, _, attr = name.rpartition(".")
            m = module.get_submodule(path) if path else module
            saved.append((m, attr, m._parameters[attr]))
            m._parameters[attr] = t
        yield
    finally:
        for m, attr, p in reversed(saved):
            m._parameters[attr] = p


@torch.no_grad()
def shard_model(model, layout, specs: Dict[str, tuple], rules: RuleTable,
                logical: Dict[str, tuple]):
    """Replace each of `model`'s parameters by this rank's shard (same
    `requires_grad`) and attach a `ShardPlan` as `model.shard_plan`
    (`logical`: the parameters' logical axes); returns the model."""
    plan = ShardPlan(layout, specs, rules, logical, decode_dims(model.cfg))
    for name, p in list(model.named_parameters()):
        path, _, attr = name.rpartition(".")
        m = model.get_submodule(path) if path else model
        m._parameters[attr] = torch.nn.Parameter(
            shard_tensor(p.detach(), specs[name], layout),
            requires_grad=p.requires_grad)
    model.shard_plan = plan
    return model


@torch.no_grad()
def whole_tensor(shard: torch.Tensor, spec, layout) -> torch.Tensor:
    """A new whole tensor from this rank's shard (every rank takes part;
    no autograd): unlike `gather_param`, never a view of the shard."""
    full = gather_param(shard.detach(), spec, layout)
    if not any(layout.axis_size(entry_axes(e)) > 1 for e in spec):
        full = full.clone()
    return full


def gather_whole(model) -> Dict[str, torch.Tensor]:
    """{name: new whole tensor} of a sharded model's parameters."""
    plan = model.shard_plan
    return {k: whole_tensor(p, plan.specs[k], plan.layout)
            for k, p in model.named_parameters()}
