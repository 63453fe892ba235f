"""train_step / serve_step builders: the functions the dry-run runs and
the launchers execute.

One rank: the state is a `models.Transformer` whose parameters require
grad, its AdamW state (f32 moments keyed like `named_parameters()`) and
the step. A train step is the reference's: `lm_loss`, its gradients
(`torch.autograd.grad`, under `cfg.remat`), `clip_by_global_norm`, the
schedule's learning rate at the state's step, and AdamW, in place.
Nothing is read back to the host: the metrics are 0-d tensors.

Several ranks (a `launch.mesh.RankLayout` of more than one rank, one
process per rank over `torch.distributed`): the reference gets this from
`jax.jit` with the `NamedSharding`s that `train_state_specs` and
`distributed/sharding.py` resolve; the port does it explicitly.

  * Each rank keeps only its shard of every parameter and of both AdamW
    moments, as `param_spec` resolves it over the layout
    (`Placement.state`, `init_train_state(..., layout=)`).
  * The step takes the global batch [B, T+1] and keeps this rank's
    tokens: its rows, along the axes the "batch" rule of the config's
    profile resolves to (`sharding.rules_for_profile`), then, after the
    next-token shift (inputs `tokens[:, :-1]`, targets `tokens[:, 1:]`),
    its block of the T positions along the axes the "seq" rule resolves
    to: "model" under the default profile when T divides, the
    reference's sequence parallelism (`sharding.TokenSplit`). The block
    runs at its global positions q0 + arange(T / M); each attention
    layer gathers k and v along "model", the MoE layers run their own
    experts on the gathered token groups, the recurrent blocks scan the
    gathered sequence on their own channels (`models/`).
  * Each block gathers its parameters whole where they are used
    (`sharding.gather_param`, inside the block's remat region), and the
    gradients come back reduce-scattered to their owners in their own
    dtype (as XLA's all-reduce reduces); the sum over the token shards
    is then divided by their number.
  * nll, z_loss and the loss are averaged over the token shards: they
    hold equal token counts, so the mean of their means is the global
    batch's mean. The MoE aux loss takes global means over the same
    ranks (`models/moe.py`), and the gradient norm counts every element
    once (`optim.clip_by_global_norm`).

So P ranks compute what one rank computes on the global batch, and no
two ranks process the same token: under the default profile the ranks
along "model" hold different positions of the same rows (where T does
not divide, they hold the same rows and split the heads, widths,
vocabulary, experts and recurrent channels instead);
under the "dp" profile the batch spans every axis. A decode step has no
sequence to split: its rows split over the "batch" axes, and the axes
the reference's decode rules give "act_heads", "act_kv_heads",
"act_mlp", "act_vocab", "act_experts" and "cache_seq" ("model" under the
default profile) split the heads, the MLP width, the vocabulary, the
experts and the caches' positions, each where its size divides
(`sharding.decode_axes`), and so do the recurrent blocks' channels and
heads; the weights keep those dims sharded, and the caches and
recurrent states are this rank's blocks (`Placement.decode_state`,
`make_prefill_step`). A training or prefill step whose T the "seq" rule
cannot split takes the same tensor-parallel split over its T positions
(every rank along "model" holds the same tokens: Megatron's pair at each
split layer's ends, `sharding.tp_enter` / `tp_exit`, and the loss on
whole logits gathered vocab-parallel).

The second member of each `build_*` pair, a `Placement`, puts a whole
state, model, batch or decode state onto this rank's shards: the
counterpart of `jit_for`'s `in_shardings` (donation has none). A
one-rank layout runs the one-rank step, bit for bit.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import models as M
from ..core.graph_device import resolve_device
from ..distributed import sharding as S
from ..models.transformer import param_logical_axes
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..optim.adamw import AdamWState


class TrainState(NamedTuple):
    params: M.Transformer       # parameters requiring grad
    opt: AdamWState
    step: torch.Tensor          # int32 scalar (on the CPU)


def named_params(model: M.Transformer) -> dict:
    """{name: parameter}, the key order of every dict the step uses."""
    return dict(model.named_parameters())


def trainable(model: M.Transformer) -> M.Transformer:
    """The model with every parameter requiring grad (construction makes
    them frozen, so serving builds no autograd graph)."""
    return model.requires_grad_(True)


def _sharded(layout) -> bool:
    return layout is not None and layout.size > 1


def init_train_state(cfg, seed: int = 0, device="cuda",
                     dtype=torch.float32, layout=None) -> TrainState:
    """A fresh state: parameters drawn from `torch.Generator(device)
    .manual_seed(seed)` in `dtype` (f32 masters by default, as the
    reference's), zero f32 moments, step 0. With a layout of several
    ranks every rank draws the whole model from the seed on its device
    (`layout.device`) and keeps its shards, so P ranks start where one
    rank starts."""
    if _sharded(layout):
        device = layout.device
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    model = trainable(M.Transformer(cfg, gen, device=device, dtype=dtype))
    if _sharded(layout):
        model = Placement(cfg, layout).params(model)
    return TrainState(params=model, opt=adamw_init(named_params(model)),
                      step=torch.tensor(0, dtype=torch.int32))


# ---------------------------------------------------------------------------
# specs: logical axes and their resolution over a layout
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model_specs_cached(cfg):
    """Shapes + logical axes WITHOUT allocating (a model on "meta") —
    full-size configs (dbrx-132b...) must never materialise."""
    model = M.Transformer(cfg, device="meta")
    shapes = dict(model.named_parameters())
    return param_logical_axes(model), shapes


def model_specs(cfg):
    """({name: "meta" tensor of the parameter's shape, f32}, {name:
    logical axes}), the reference's `_model_specs`."""
    specs, shapes = _model_specs_cached(cfg)
    return shapes, specs


def train_state_specs(cfg) -> TrainState:
    """Logical-axis spec tree matching init_train_state's structure."""
    _, pspecs = model_specs(cfg)
    return TrainState(params=pspecs,
                      opt=AdamWState(step=(), m=pspecs, v=pspecs),
                      step=())


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def _tree_map(fn, spec_tree, template):
    """fn(axes, leaf) over a spec tree (NamedTuples and dicts whose leaves
    are logical-axis tuples) and a template of the same structure."""
    if _is_axes(spec_tree):
        return fn(spec_tree, template)
    if isinstance(spec_tree, dict):
        return {k: _tree_map(fn, v, template[k])
                for k, v in spec_tree.items()}
    return type(spec_tree)(*[_tree_map(fn, a, b)
                             for a, b in zip(spec_tree, template)])


def resolve_param_shardings(cfg, layout, state_template) -> Any:
    """The spec tree of a TrainState (or a {name: tensor} params dict)
    template over `layout`: `param_spec` of each leaf's shape."""
    if isinstance(state_template, TrainState):
        spec_tree = train_state_specs(cfg)
    else:
        _, spec_tree = model_specs(cfg)
    return _tree_map(
        lambda axes, leaf: S.param_spec(axes, leaf.shape, layout),
        spec_tree, state_template)


def resolve_specs(spec_tree, template, layout, rules) -> Any:
    """`spec_for` of every leaf of a spec tree against its template."""
    return _tree_map(
        lambda axes, leaf: S.spec_for(axes, leaf.shape, layout, rules),
        spec_tree, template)


def _lead(batch):
    return batch["labels"] if isinstance(batch, dict) else batch


class Placement:
    """Puts whole states, models, batches and decode states onto this
    rank's shards of `layout` under `cfg`'s rules: the counterpart of the
    reference's `jit_for` in_shardings."""

    def __init__(self, cfg, layout):
        self.cfg, self.layout = cfg, layout
        self.rules = S.rules_for_profile(cfg.sharding_profile)

    def param_specs(self, model) -> dict:
        axes = param_logical_axes(model)
        return {k: S.param_spec(axes[k], p.shape, self.layout)
                for k, p in model.named_parameters()}

    def params(self, model):
        """A whole model -> this rank's shards of it (in place), with its
        `ShardPlan` (which knows the MoE layers' expert weights)."""
        if model.shard_plan is not None:
            raise ValueError("the model is already sharded")
        return S.shard_model(model, self.layout, self.param_specs(model),
                             self.rules, param_logical_axes(model))

    @torch.no_grad()
    def state(self, state: TrainState) -> TrainState:
        """A whole TrainState -> this rank's: parameters and both moments
        sharded by the parameters' specs, the steps kept."""
        specs = self.param_specs(state.params)
        model = self.params(state.params)

        def cut(t):
            return {k: S.shard_tensor(v, specs[k], self.layout)
                    for k, v in t.items()}
        return TrainState(params=model, opt=AdamWState(
            state.opt.step, cut(state.opt.m), cut(state.opt.v)),
            step=state.step)

    def _rows(self, n: int) -> slice:
        axes = S.batch_axes_for((n,), self.layout, self.rules)
        per = n // self.layout.axis_size(axes)
        i = self.layout.axis_index(axes)
        return slice(i * per, (i + 1) * per)

    def batch(self, batch, device=None):
        """This rank's rows of a global batch (tokens [B, ...], or both
        leaves of an embed_inputs config's dict), on `device`."""
        rows = self._rows(_lead(batch).shape[0])
        device = device or self.layout.device
        if isinstance(batch, dict):
            return {k: _as_tensor(v[rows], device) for k, v in batch.items()}
        return _as_tensor(batch[rows], device)

    def decode_state(self, state):
        """This rank's share of a whole decode state, cut by
        `decode_state_specs` resolved with the act rules (the reference's
        resolution): the KV caches' rows and their block along
        "cache_seq", the recurrent states' rows and their blocks along
        "act_heads" / "act_mlp" where those divide; positions are kept.
        Returns a `models.DecodeState` of the whole caches' length (a
        later step never cuts it again)."""
        specs = M.decode_state_specs(self.cfg)
        cache_len = next((st["k"].shape[1] for st in state if "k" in st),
                         None)
        out = []
        for st, axes in zip(state, specs):
            cut = {}
            for k, v in st.items():
                if not isinstance(v, torch.Tensor):
                    cut[k] = v
                    continue
                spec = S.spec_for(axes[k], v.shape, self.layout, self.rules)
                cut[k] = S.shard_tensor(v, spec, self.layout)
            out.append(cut)
        return M.DecodeState(out, cache_len)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _as_tensor(x, device, dtype=None):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype) if dtype is not None \
        else x.to(device)


def _batch_on(batch, device):
    if isinstance(batch, dict):
        return {"inputs": _as_tensor(batch["inputs"], device),
                "labels": _as_tensor(batch["labels"], device)}
    return _as_tensor(batch, device)


def loss_and_grads(model: M.Transformer, batch):
    """(loss, metrics, {name: gradient}) of `lm_loss` on `batch` (tokens
    [B, T+1], or dict(inputs=, labels=) for embed_inputs configs). A
    parameter the loss does not reach gets a zero gradient."""
    params = named_params(model)
    with torch.enable_grad():
        if isinstance(batch, dict):
            loss, metrics = M.lm_loss(model, batch["inputs"],
                                      batch["labels"])
        else:
            loss, metrics = M.lm_loss(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    grads = {k: (g if g is not None else torch.zeros_like(p))
             for (k, p), g in zip(params.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _placed(model, layout, what: str):
    plan = model.shard_plan
    if plan is None or plan.layout is not layout:
        raise ValueError(
            f"{what}: the model is not sharded over this layout; place it "
            "first (the second member of build_*: .state() or .params(), "
            "or init_train_state(..., layout=layout))")
    return plan


def _seq_len(batch) -> int:
    """The positions the model runs on a global training batch: T of
    tokens [B, T+1] (after the shift), of labels [B, T] in a dict."""
    if isinstance(batch, dict):
        return batch["labels"].shape[1]
    return batch.shape[1] - 1


def _own_tokens(rows, split) -> dict:
    """This rank's tokens of its rows of a training batch (tokens [b,
    T+1], or an embed_inputs config's dict), after the next-token shift:
    {"inputs", "labels"}, each its block of the T positions."""
    if isinstance(rows, dict):
        inputs, labels = rows["inputs"], rows["labels"]
    else:
        inputs, labels = rows[:, :-1], rows[:, 1:]
    return {"inputs": split.own(inputs), "labels": split.own(labels)}


def make_train_step(cfg, layout=None, lr_schedule=None,
                    clip_norm: float = 1.0):
    """Returns train_step(state, batch) -> (state, metrics). batch is
    tokens [B, T+1] int32 (or dict(inputs=…, labels=…) for embed archs),
    numpy or tensors: the global batch; on several ranks each keeps its
    rows and the state must be placed (module docstring). The model runs
    under `cfg`. The state's tensors are updated in place, and the
    returned state shares them. metrics: loss, grad_norm, lr, nll,
    z_loss, moe_aux (0-d tensors, the global batch's)."""
    if lr_schedule is None:
        from ..optim import linear_warmup_cosine
        lr_schedule = linear_warmup_cosine(3e-4, 100, 10000)
    sharded = _sharded(layout)
    place = Placement(cfg, layout) if sharded else None

    def train_step(state: TrainState, batch):
        model = state.params
        model.cfg = cfg
        dev = next(model.parameters()).device
        if not sharded:
            loss, metrics, grads = loss_and_grads(model,
                                                  _batch_on(batch, dev))
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            plan = _placed(model, layout, "make_train_step")
            split = plan.set_batch(_lead(batch).shape[0], _seq_len(batch))
            loss, metrics, grads = loss_and_grads(
                model, _own_tokens(place.batch(batch, dev), split))
            if split.n > 1:
                for g in grads.values():
                    g.div_(split.n)
                red = split.token_comm.psum(torch.stack(
                    [loss, metrics["nll"], metrics["z_loss"]])) / split.n
                loss, metrics["nll"], metrics["z_loss"] = red.unbind(0)
            grads, gnorm = clip_by_global_norm(
                grads, clip_norm, {k: plan.counted(k) for k in grads},
                plan.world_comm)
        lr = lr_schedule(state.step)
        _, new_opt = adamw_update(grads, state.opt, named_params(model),
                                  lr=lr)
        new_state = TrainState(params=model, opt=new_opt,
                               step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                           **metrics}

    return train_step


def build_train_step(cfg, layout, lr_schedule=None):
    """(train_step, Placement): `make_train_step` over `layout`, and what
    places a whole state (`.state`) or batch (`.batch`) on this rank."""
    return make_train_step(cfg, layout, lr_schedule), Placement(cfg, layout)


def make_serve_step(cfg, layout=None):
    """serve_step(model, tokens, state) -> (logits, state): `decode_step`
    under `cfg`. On several ranks `tokens` is the global batch (each rank
    keeps its rows) and `state` this rank's share (its rows, and its
    blocks of the caches along "cache_seq": as `make_prefill_step`
    returns it, or `Placement.decode_state` cuts it); the step runs on
    the decode split (module docstring) and the logits are this rank's
    rows, whole along the vocabulary."""
    sharded = _sharded(layout)
    place = Placement(cfg, layout) if sharded else None

    def serve_step(model, tokens, state):
        model.cfg = cfg
        if sharded:
            _placed(model, layout, "make_serve_step").set_batch(
                tokens.shape[0])
            tokens = place.batch(tokens, next(model.parameters()).device)
        return M.decode_step(model, tokens, state)
    return serve_step


def make_prefill_step(cfg, layout=None, max_len: Optional[int] = None):
    """prefill(model, tokens) -> (last logits, decode state):
    `prefill_step` under `cfg`; on several ranks the global batch in
    (each rank runs its rows' block of positions, module docstring),
    this rank's rows of the last logits and its share of the decode
    state out: its rows, and its block of each cache where "cache_seq"
    splits max_len (a `models.DecodeState`)."""
    sharded = _sharded(layout)
    place = Placement(cfg, layout) if sharded else None

    def prefill(model, tokens):
        model.cfg = cfg
        if sharded:
            split = _placed(model, layout, "make_prefill_step").set_batch(
                tokens.shape[0], tokens.shape[1])
            tokens = split.own(place.batch(
                tokens, next(model.parameters()).device))
        return M.prefill_step(model, tokens, max_len=max_len)
    return prefill


def build_serve_step(cfg, layout):
    """(serve_step, Placement): `.params` places a whole model,
    `.decode_state` cuts a whole decode state into this rank's share."""
    return make_serve_step(cfg, layout), Placement(cfg, layout)


def build_prefill_step(cfg, layout, max_len: Optional[int] = None):
    """(prefill, Placement): `.params` places a whole model."""
    return make_prefill_step(cfg, layout, max_len), Placement(cfg, layout)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def state_tree(state: TrainState) -> TrainState:
    """The state as a tree of whole tensors for `CheckpointManager.save`
    (the model's parameters as a {name: tensor} dict, detached). A
    sharded state is gathered into new tensors: every rank takes part and
    gets the whole tree (rank 0 writes it)."""
    plan = state.params.shard_plan
    if plan is None:
        return TrainState(
            params={k: p.detach()
                    for k, p in named_params(state.params).items()},
            opt=state.opt, step=state.step)

    def whole(t):
        return {k: S.whole_tensor(v, plan.specs[k], plan.layout)
                for k, v in t.items()}
    return TrainState(params=S.gather_whole(state.params),
                      opt=AdamWState(state.opt.step, whole(state.opt.m),
                                     whole(state.opt.v)),
                      step=state.step)


def state_template(state: TrainState) -> TrainState:
    """`state_tree`'s structure with None leaves, for
    `CheckpointManager.restore` (which reads only the structure): no
    gather, so a rank can restore without its peers."""
    names = {k: None for k in named_params(state.params)}
    return TrainState(params=names, opt=AdamWState(None, dict(names),
                                                   dict(names)), step=None)


@torch.no_grad()
def load_state_tree(state: TrainState, tree) -> TrainState:
    """Copy a restored `state_tree` (whole numpy arrays or tensors) into
    `state`'s tensors in place — a sharded state keeps its shards of it,
    so a checkpoint written by P ranks restores on any other number of
    ranks; returns the state at the restored step."""
    dev = next(state.params.parameters()).device
    plan = state.params.shard_plan

    def mine(x, k, dtype):
        x = _as_tensor(x, dev, dtype)
        return x if plan is None else S.shard_tensor(x, plan.specs[k],
                                                     plan.layout)
    for k, p in named_params(state.params).items():
        p.copy_(mine(tree.params[k], k, p.dtype))
    for k in state.opt.m:
        state.opt.m[k].copy_(mine(tree.opt.m[k], k, torch.float32))
        state.opt.v[k].copy_(mine(tree.opt.v[k], k, torch.float32))
    step = torch.as_tensor(np.asarray(tree.step), dtype=torch.int32)
    opt_step = torch.as_tensor(np.asarray(tree.opt.step),
                               dtype=torch.int32)
    return TrainState(params=state.params,
                      opt=AdamWState(opt_step, state.opt.m, state.opt.v),
                      step=step)
