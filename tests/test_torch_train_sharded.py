"""Training on several ranks: the sharded train step at P = 2 gloo ranks
on the CPU against the reference's single-device step on the global
batch, the split of the work over "model", the sharded prefill,
checkpoints that reshard, and the error-feedback compressed psum.

One spawn of two ranks runs every case (`_RANK`): the reference's
initial state (JAX, `init_train_state`, converted through `convert` with
the rank's layout, so each rank keeps its shards) takes three steps of
`make_train_step(cfg, layout)` on `SyntheticLMDataset` batches, for a
dense 2-layer smoke config (qwen3-14b, `remat="dots"` under data 2) and
`smoke(granite-moe-1b-a400m)` (B 4 x T 1024: each rank's 2,048 tokens
are one global MoE group; `remat="full"` under data 2), each under
data 2, data 1 x model 2 and the "dp" profile on data 1 x model 2, and
under data 1 x model 2 a local-window config (recurrentgemma-9b: RG-LRU
blocks and a window of 8 across the two sequence blocks), a recurrent
one (xlstm-350m: mLSTM and sLSTM) and granite with 3 experts, which do
not divide the model axis (each rank runs every expert on its gathered
rows). Under model 2 each rank runs its half of the positions (the
sequence split of the default profile; the experts split too where they
divide; a recurrent block scans the gathered sequence on its own
channels). Four cases at T 15, which 2 does not divide, take the
tensor-parallel arm instead (every rank every position, the heads, MLP
width, vocabulary, experts and recurrent channels split, Megatron's pair
at each split layer's ends): dense, MoE, local + RG-LRU and xLSTM smoke
("*_tp"). The reference takes the same three steps here with
`make_train_step(cfg, None, ...)`.

Tolerances, per step: loss 1e-5 relative, grad_norm 1e-4 relative (the
gradients sum in another order), moe_aux 1e-6 relative; after three steps
every parameter and both moments within 1e-5 absolute. The ranks' first
model-2 step runs at their own positions (or, at T 15, on their share
of the heads and widths) and counts at most 0.6 of one rank's FLOPs on
the same global batch (`FlopCounterMode`). A prefill
(`build_prefill_step`) under model 2 (T 32: the sequence split; T 15:
the tensor-parallel arm), and a dense one under data 2, equals the
reference's `prefill_step` on the global batch in each rank's rows: last
logits within 1e-4, caches (each rank's block along "cache_seq" where
the decode split takes one) and recurrent states (each rank's block
along the heads or channels the decode split names) within 1e-5 (bf16
caches within one bf16 step); one `decode_step` after it equals the
reference's within 1e-3 (bf16 caches, as tests/test_torch_models.py
holds a decode). P = 1 is bitwise the one-rank step. A checkpoint saved at
P = 2 resumes bitwise at P = 2 and within 1e-5 at P = 1.

Every rank ends by `collectives.end_rank` once its results are written;
the test checks each rank's exit code and results.
"""
import json
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jcfgs
from repro import models as JM
from repro.optim import linear_warmup_cosine as j_lr
from repro.train import step as JTS
from repro_torch import configs as tcfgs
from repro_torch import convert, envutil
from repro_torch import models as lm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed import collectives
from repro_torch.distributed import compression as C
from repro_torch.launch.mesh import RankLayout
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import step as TS

LOSS_RTOL, GNORM_RTOL, AUX_RTOL, STATE_ATOL = 1e-5, 1e-4, 1e-6, 1e-5
LOGIT_TOL, DECODE_TOL, FLOP_SHARE = 1e-4, 1e-3, 0.6
STEPS, LR = 3, (1e-3, 2, 10)
#: name -> (arch, B, T, remat under data 2)
CONFIGS = {"dense": ("qwen3-14b", 4, 16, "dots"),
           "moe": ("granite-moe-1b-a400m", 4, 1024, "full"),
           "local": ("recurrentgemma-9b", 2, 32, "none"),
           "recurrent": ("xlstm-350m", 2, 32, "none"),
           "moe3": ("granite-moe-1b-a400m", 2, 32, "none"),
           "dense_tp": ("qwen3-14b", 2, 15, "none"),
           "moe_tp": ("granite-moe-1b-a400m", 2, 15, "none"),
           "local_tp": ("recurrentgemma-9b", 2, 15, "none"),
           "recurrent_tp": ("xlstm-350m", 2, 15, "none")}
#: what the tensor-parallel arm splits over "model" (`TokenSplit.tp`), in
#: training and in the prefill, at T 15
TP_SPLITS = {
    "dense_tp": {"act_heads", "act_kv_heads", "act_mlp", "act_vocab"},
    "moe_tp": {"act_heads", "act_kv_heads", "act_vocab", "act_experts"},
    "local_tp": {"act_heads", "act_mlp", "act_vocab", "rglru.act_mlp"},
    "recurrent_tp": {"act_vocab", "mlstm.act_heads", "mlstm.act_mlp",
                     "slstm.act_heads"}}
#: name -> config overrides beyond the smoke's
OVERRIDES = {"moe3": {"num_experts": 3}}
#: name -> (model_parallel, sharding profile)
LAYOUTS = {"data2": (1, "default"), "model2": (2, "default"),
           "dp": (2, "dp")}
CASES = [(c, lay) for c in ("dense", "moe") for lay in LAYOUTS] + [
    ("local", "model2"), ("recurrent", "model2"), ("moe3", "model2")] + [
    (c, "model2") for c in TP_SPLITS]
#: the prefills: name -> (arch, attn_impl, B, T, model_parallel)
PREFILLS = {"dense": ("qwen3-14b", "flash_kernel", 2, 32, 2),
            "moe": ("granite-moe-1b-a400m", "xla", 2, 32, 2),
            "local": ("recurrentgemma-9b", "flash_kernel", 2, 32, 2),
            "dense_data2": ("qwen3-14b", "flash_kernel", 2, 32, 1),
            "dense_tp": ("qwen3-14b", "flash_kernel", 2, 15, 2),
            "moe_tp": ("granite-moe-1b-a400m", "xla", 2, 15, 2),
            "local_tp": ("recurrentgemma-9b", "flash_kernel", 2, 15, 2),
            "recurrent_tp": ("xlstm-350m", "xla", 2, 15, 2)}


def _cfgs(name, layout):
    arch, _, _, remat = CONFIGS[name]
    mp, prof = LAYOUTS[layout]
    kw = dict(sharding_profile=prof,
              remat=remat if layout == "data2" else "none",
              **OVERRIDES.get(name, {}))
    return (jcfgs.smoke(jcfgs.get_config(arch)).replace(**kw),
            tcfgs.smoke(tcfgs.get_config(arch)).replace(**kw))


def _plain(state):
    """The reference's TrainState as plain dicts of numpy arrays."""
    s = jax.tree.map(np.asarray, state)
    return {"params": s.params, "opt": {"step": s.opt.step, "m": s.opt.m,
                                        "v": s.opt.v}, "step": s.step}


_RANK = r"""
import json, pickle, sys
import numpy as np, torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch import configs as tcfgs, convert, models as lm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed import compression as C
from repro_torch.distributed.collectives import end_rank, init_rank
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as TL
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import step as TS
rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
init_rank(rank, world, port, "gloo")
with open(f"{tmp}/job.pkl", "rb") as f:
    job = pickle.load(f)
out = {}

# the positions the model rotates q and k at (RoPE), as (first, last),
# and the shapes of the token blocks it embeds
# (the tensor-parallel arm embeds from its block of the table)
seen, embedded = [], []
real_rope, real_embed = TL.rope, TL.embed_tokens
real_split = TL.embed_tokens_split
def rope(x, positions, theta):
    seen.append((int(positions.min()), int(positions.max())))
    return real_rope(x, positions, theta)
def embed_tokens(model, cfg, tokens, dtype):
    embedded.append(tuple(tokens.shape))
    return real_embed(model, cfg, tokens, dtype)
def embed_tokens_split(model, cfg, tokens, dtype, comm):
    embedded.append(tuple(tokens.shape))
    return real_split(model, cfg, tokens, dtype, comm)
TL.rope, TL.embed_tokens = rope, embed_tokens
TL.embed_tokens_split = embed_tokens_split

def whole(state):
    t = TS.state_tree(state)
    return {"params": {k: v.numpy() for k, v in t.params.items()},
            "m": {k: v.numpy() for k, v in t.opt.m.items()},
            "v": {k: v.numpy() for k, v in t.opt.v.items()}}

for key, c in job["cases"].items():
    cfg = tcfgs.smoke(tcfgs.get_config(c["arch"])).replace(**c["kw"])
    lay = make_host_mesh(c["mp"], "cpu")
    state = convert.train_state_from_numpy(c["init"], cfg, "cpu",
                                           layout=lay)
    step = TS.make_train_step(cfg, lay, linear_warmup_cosine(*job["lr"]))
    data = SyntheticLMDataset(cfg.vocab_size, c["T"], c["B"], seed=0)
    ms = []
    for s in range(job["steps"]):
        seen.clear()
        embedded.clear()
        with FlopCounterMode(display=False) as fc:
            state, m = step(state, data.batch(s))
        if s == 0:
            flops, positions = fc.get_total_flops(), sorted(set(seen))
            blocks = sorted(set(embedded))
            split = state.params.shard_plan.split
        ms.append({k: float(v) for k, v in m.items()})
    w = whole(state)
    out[key] = {"metrics": ms, "shapes": {
        k: list(p.shape) for k, p in state.params.named_parameters()},
        "flops": flops, "positions": positions, "embedded": blocks,
        "q0": split.q0, "length": split.length, "tp": sorted(split.tp)}
    if rank == 0:
        with open(f"{tmp}/{key.replace('/', '__')}.pkl", "wb") as f:
            pickle.dump(w, f)

# the prefills of the reference's weights, then one decode step straight
# after each (on this rank's rows)
for key, c in job["prefills"].items():
    cfg = tcfgs.smoke(tcfgs.get_config(c["arch"])).replace(**c["kw"])
    lay = make_host_mesh(c["mp"], "cpu")
    model = lm.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_numpy(c["params"], cfg),
                          strict=True)
    prefill, place = TS.build_prefill_step(cfg, lay, max_len=c["max_len"])
    place.params(model)
    seen.clear()
    last, state = prefill(model, torch.from_numpy(c["tokens"]))
    rows = place._rows(c["tokens"].shape[0])
    plan = model.shard_plan
    dec = plan.decode_split(rows.stop - rows.start, state.cache_len)
    out[f"prefill/{key}"] = {"positions": sorted(set(seen)),
                             "rows": [rows.start, rows.stop],
                             "q0": plan.split.q0, "tp": sorted(plan.split.tp),
                             "dec_tp": sorted(dec.tp),
                             "tp_rank": dec.tp_comm.rank}
    caches = [{k: (str(v.dtype), v.float().numpy())
               if isinstance(v, torch.Tensor) else v
               for k, v in st.items()} for st in state]
    dec, _ = lm.decode_step(model, torch.from_numpy(c["next"][rows]), state)
    with open(f"{tmp}/prefill__{key}__{rank}.pkl", "wb") as f:
        pickle.dump({"last": last.numpy(), "state": caches,
                     "decode": dec.numpy()}, f)
TL.rope, TL.embed_tokens = real_rope, real_embed
TL.embed_tokens_split = real_split

# a split that breaks the MoE grouping
c = job["cases"]["moe/data2"]
cfg = tcfgs.smoke(tcfgs.get_config(c["arch"])).replace(**c["kw"])
lay = make_host_mesh(1, "cpu")
state = TS.init_train_state(cfg, 0, "cpu", layout=lay)
try:
    TS.make_train_step(cfg, lay)(state, np.zeros((4, 17), np.int32))
    out["moe_split"] = "no error"
except ValueError as e:
    out["moe_split"] = str(e)

# checkpoint: save at step 2, two more steps; restore into a fresh state
c = job["cases"]["dense/data2"]
cfg = tcfgs.smoke(tcfgs.get_config(c["arch"])).replace(**c["kw"])
lay = make_host_mesh(1, "cpu")
step = TS.make_train_step(cfg, lay, linear_warmup_cosine(*job["lr"]))
data = SyntheticLMDataset(cfg.vocab_size, c["T"], c["B"], seed=1)
state = TS.init_train_state(cfg, 0, "cpu", layout=lay)
for s in range(2):
    state, _ = step(state, data.batch(s))
mgr = CheckpointManager(f"{tmp}/ckpt", async_save=False)
tree = TS.state_tree(state)
if rank == 0:
    mgr.save(2, tree)
torch.distributed.barrier()
went_on = []
for s in range(2, 4):
    state, m = step(state, data.batch(s))
    went_on.append(float(m["loss"]))
fresh = TS.init_train_state(cfg, 7, "cpu", layout=lay)
fresh = TS.load_state_tree(fresh, mgr.restore(TS.state_tree(fresh)))
resumed = []
for s in range(2, 4):
    fresh, m = step(fresh, data.batch(s))
    resumed.append(float(m["loss"]))
a, b = TS.named_params(state.params), TS.named_params(fresh.params)
out["ckpt"] = {"went_on": went_on, "resumed": resumed,
               "params_equal": all(torch.equal(a[k], b[k]) for k in a),
               "moments_equal": all(
                   torch.equal(state.opt.m[k], fresh.opt.m[k])
                   and torch.equal(state.opt.v[k], fresh.opt.v[k])
                   for k in a)}
w = whole(state)
if rank == 0:
    pickle.dump(w, open(f"{tmp}/ckpt_final.pkl", "wb"))

# the compressed psum over the two ranks: rank r holds g + (r - 1/2) d,
# whose mean is g
lay = make_host_mesh(1, "cpu")
comm = lay.comm("data")
g = torch.linspace(-1, 1, 64)
d = torch.linspace(0.3, -0.2, 64)
mine = {"w": g + (rank - 0.5) * d}
err = C.init_error_state(mine)
acc = torch.zeros(64)
for _ in range(50):
    mean, err = C.compressed_psum(mine, err, comm)
    acc = acc + mean["w"]
out["compressed"] = (acc / 50).tolist()
out["compressed_bytes"] = comm.by_kind

with open(f"{tmp}/out{rank}.json", "w") as f:
    json.dump(out, f)
end_rank()
"""


def _prefill_jobs():
    """{name: the reference's smoke weights (per-layer layout), a prompt,
    the next tokens and the rank's config overrides} of PREFILLS, and
    {name: the reference's prefill_step on it (last logits, per-layer
    state) and its decode_step on the next tokens (logits)}."""
    jobs, ref = {}, {}
    for name, (arch, impl, B, T, mp) in PREFILLS.items():
        kw = dict(sharding_profile="default", attn_impl=impl)
        jcfg = jcfgs.smoke(jcfgs.get_config(arch)).replace(
            scan_layers=False, **kw)
        params = jax.tree.map(np.asarray, JM.init_model(
            jcfg, jax.random.PRNGKey(1))[0])
        tokens = np.random.default_rng(5).integers(
            0, jcfg.vocab_size, (B, T)).astype(np.int32)
        nxt = np.random.default_rng(6).integers(
            0, jcfg.vocab_size, (B,)).astype(np.int32)
        last, st = jax.jit(JM.prefill_step, static_argnames=(
            "cfg", "max_len", "cache_dtype"))(
            params, jcfg, jnp.asarray(tokens), max_len=T + 4)
        dec, _ = jax.jit(JM.decode_step, static_argnames=("cfg",))(
            params, jcfg, jnp.asarray(nxt), st)
        jobs[name] = dict(arch=arch, kw=dict(kw, scan_layers=False),
                          params=params, tokens=tokens, next=nxt,
                          max_len=T + 4, mp=mp)
        ref[name] = (np.asarray(last), [
            jax.tree.map(lambda a: np.asarray(a, np.float32), x)
            for x in st["layers"] + st["rem"]], np.asarray(dec))
    return jobs, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once; returns (tmp dir, rank 0's JSON, the
    reference's per-case results, rank 1's JSON, the reference's
    prefills)."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases, ref = {}, {}
    for name, lay in CASES:
        arch, B, T, _ = CONFIGS[name]
        jcfg, _ = _cfgs(name, lay)
        jstate = JTS.init_train_state(jcfg, jax.random.PRNGKey(0))
        cases[f"{name}/{lay}"] = dict(
            arch=arch, B=B, T=T, mp=LAYOUTS[lay][0],
            kw=dict(sharding_profile=jcfg.sharding_profile,
                    remat=jcfg.remat, **OVERRIDES.get(name, {})),
            init=_plain(jstate))
        jstep = jax.jit(JTS.make_train_step(jcfg, None, j_lr(*LR)))
        data = SyntheticLMDataset(jcfg.vocab_size, T, B, seed=0)
        ms = []
        for s in range(STEPS):
            jstate, m = jstep(jstate, data.batch(s))
            ms.append({k: float(v) for k, v in m.items()})
        ref[f"{name}/{lay}"] = (ms, _plain(jstate))
    prefills, ref_prefill = _prefill_jobs()
    job = {"cases": cases, "lr": LR, "steps": STEPS, "prefills": prefills}
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    port = collectives.free_port()
    env = envutil.subprocess_env(threads=1)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "2", str(port), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=400)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    outs = [json.loads((tmp / f"out{r}.json").read_text()) for r in range(2)]
    return tmp, outs[0], ref, outs[1], ref_prefill


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("case", [f"{c}/{lay}" for c, lay in CASES])
def test_sharded_step_matches_reference(ranks, case):
    tmp, out, ref = ranks[:3]
    name, lay = case.split("/")
    _, tcfg = _cfgs(name, lay)
    got, (want, jfinal) = out[case]["metrics"], ref[case]
    if name == "moe3":
        # 3 experts do not divide the model axis: no rank's shard splits
        # them, so each runs all three
        ups = [v for k, v in out[case]["shapes"].items()
               if k.endswith("moe.w_up")]
        assert ups and all(v[0] == 3 for v in ups), ups
    for s, (m, jm) in enumerate(zip(got, want)):
        assert _rel(m["loss"], jm["loss"]) <= LOSS_RTOL, (s, m, jm)
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= GNORM_RTOL, (s,)
        assert _rel(m["moe_aux"], jm["moe_aux"]) <= AUX_RTOL, (s,)
        for k in ("nll", "z_loss", "lr"):
            np.testing.assert_allclose(m[k], jm[k], rtol=LOSS_RTOL)
    with open(tmp / f"{name}__{lay}.pkl", "rb") as f:
        final = pickle.load(f)
    for part in ("params", "m", "v"):
        tree = jfinal["params"] if part == "params" else jfinal["opt"][part]
        want_t = convert.model_params_from_numpy(tree, tcfg)
        assert set(want_t) == set(final[part])
        for k, v in want_t.items():
            np.testing.assert_allclose(final[part][k], v.numpy(), rtol=0,
                                       atol=STATE_ATOL,
                                       err_msg=f"{part} {k}")


def _one_rank_step_flops(name):
    """FLOPs of one rank's first step of case `name` on the global
    batch."""
    _, B, T, _ = CONFIGS[name]
    _, cfg = _cfgs(name, "model2")
    state = TS.init_train_state(cfg, 0, "cpu")
    step = TS.make_train_step(cfg, None, linear_warmup_cosine(*LR))
    with FlopCounterMode(display=False) as fc:
        step(state, SyntheticLMDataset(cfg.vocab_size, T, B,
                                       seed=0).batch(0))
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["dense", "moe", "local", "recurrent"])
def test_model_axis_splits_the_tokens(ranks, name):
    """Under data 1 x model 2 each rank runs only its own block of the
    positions: it embeds B x T/2 tokens, the first or the second half,
    and RoPE rotates them at those positions (xlstm has no RoPE); and its
    first step counts at most FLOP_SHARE of one rank's step on the same
    global batch (a recurrent block scans the gathered sequence on its
    own channels)."""
    _, out0, _, out1 = ranks[:4]
    arch, B, T, _ = CONFIGS[name]
    case = f"{name}/model2"
    for r, out in enumerate((out0, out1)):
        blk = [r * T // 2, (r + 1) * T // 2 - 1]
        assert out[case]["embedded"] == [[B, T // 2]]
        assert (out[case]["q0"], out[case]["length"]) == (blk[0], T // 2)
        assert out[case]["positions"] == ([] if name == "recurrent"
                                          else [blk])
        assert out[case]["tp"] == []
    one = _one_rank_step_flops(name)
    for out in (out0, out1):
        assert 0 < out[case]["flops"] <= FLOP_SHARE * one, (
            out[case]["flops"], one)


@pytest.mark.parametrize("name", list(TP_SPLITS))
def test_tensor_parallel_arm_splits_the_work(ranks, name):
    """At T 15 under data 1 x model 2 the "seq" rule falls back: each
    rank embeds every token of its rows, RoPE rotates positions 0..T-1,
    the split names what the reference's act rules give "model"
    (TP_SPLITS), and its first step counts at most FLOP_SHARE of one
    rank's."""
    _, out0, _, out1 = ranks[:4]
    arch, B, T, _ = CONFIGS[name]
    case = f"{name}/model2"
    for out in (out0, out1):
        assert set(out[case]["tp"]) == TP_SPLITS[name], out[case]["tp"]
        assert out[case]["embedded"] == [[B, T]]
        assert (out[case]["q0"], out[case]["length"]) == (0, T)
        assert out[case]["positions"] == ([] if arch == "xlstm-350m"
                                          else [[0, T - 1]])
    one = _one_rank_step_flops(name)
    for out in (out0, out1):
        assert 0 < out[case]["flops"] <= FLOP_SHARE * one, (
            out[case]["flops"], one)


def _prefill_rank(tmp, out, name, rank):
    """(rank's rows, its pickled prefill and decode results)."""
    rows = slice(*out[f"prefill/{name}"]["rows"])
    with open(tmp / f"prefill__{name}__{rank}.pkl", "rb") as f:
        return rows, pickle.load(f)


@pytest.mark.parametrize("name", list(PREFILLS))
def test_sharded_prefill_matches_reference(ranks, name):
    """`build_prefill_step` under data 1 x model 2 (each rank its half of
    the prompt's positions, k/v gathered per attention layer), or under
    data 2 (each rank its rows, every position), against the reference's
    `prefill_step` on the global prompt: each rank's rows of the last
    position's logits and of the caches (bf16 on both sides, the
    default: f32 values 1e-7 apart may round to neighbouring bf16 values,
    so within one bf16 step, at most 2^-7 relative) and recurrent states
    (f32). Under model 2 the caches' T + 4 positions split over "model"
    ("cache_seq", laid out for the decode step): rank r holds its block
    of (T + 4) / 2 positions; under data 2 they are whole."""
    tmp, out0, _, out1, ref = ranks
    arch, _, B, T, mp = PREFILLS[name]
    want_last, want_state, _ = ref[name]
    cfg = tcfgs.smoke(tcfgs.get_config(arch))
    tp = name in TP_SPLITS
    for r, out in enumerate((out0, out1)):
        pre = out[f"prefill/{name}"]
        blk = ([r * T // 2, (r + 1) * T // 2 - 1] if mp == 2 and not tp
               else [0, T - 1])
        assert pre["positions"] == ([] if arch == "xlstm-350m" else [blk])
        # the plan keeps the prefill's split (the decode step makes its own)
        assert pre["q0"] == blk[0]
        assert set(pre["tp"]) == TP_SPLITS.get(name, set()), pre["tp"]
        rows, got = _prefill_rank(tmp, out, name, r)
        assert rows == (slice(0, B) if mp == 2
                        else slice(r * B // 2, (r + 1) * B // 2))
        np.testing.assert_allclose(got["last"], want_last[rows],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert len(got["state"]) == len(want_state)
        n = T + 4                         # the rank's block of positions
        c0 = 0
        if "cache_seq" in pre["dec_tp"]:
            n //= 2
            c0 = pre["tp_rank"] * n
        for i, (g, w) in enumerate(zip(got["state"], want_state)):
            assert set(g) == set(w), i
            for k in g:
                if k == "pos":
                    assert g[k] == int(w[k]) == T
                elif g[k][0] == "torch.bfloat16":   # caches, conv states
                    want = (w[k][rows, c0:c0 + n] if k in ("k", "v") else
                            _state_block(cfg, i, k, w[k][rows], pre))
                    np.testing.assert_allclose(
                        g[k][1], want, rtol=2.0 ** -7, atol=STATE_ATOL,
                        err_msg=f"rank {r} layer {i} {k}")
                else:
                    assert g[k][0] == "torch.float32", (i, k, g[k][0])
                    np.testing.assert_allclose(
                        g[k][1], _state_block(cfg, i, k, w[k][rows], pre),
                        rtol=0, atol=STATE_ATOL,
                        err_msg=f"rank {r} layer {i} {k}")


def _state_block(cfg, i, key, want, pre):
    """The rank's block of the reference's recurrent state `want` (its
    rows) of layer i, as the decode split after the prefill lays it out:
    halved along each dim whose act name (`decode_state_specs`) that
    split names for the layer's kind ("rglru.act_mlp")."""
    kind = cfg.layer_types[i]
    for d, ax in enumerate(lm.decode_state_specs(cfg)[i][key]):
        if ax and f"{kind}.{ax}" in pre["dec_tp"]:
            want = np.split(want, 2, axis=d)[pre["tp_rank"]]
    return want


@pytest.mark.parametrize("name", list(PREFILLS))
def test_decode_after_sharded_prefill_matches_reference(ranks, name):
    """One `decode_step` called straight after the sharded prefill, on the
    decode split the step resolves (never the prefill's split), against
    the reference's decode_step after its prefill: each rank's rows of the
    logits within DECODE_TOL (the caches are bf16)."""
    tmp, out0, _, out1, ref = ranks
    want = ref[name][2]
    for r, out in enumerate((out0, out1)):
        rows, got = _prefill_rank(tmp, out, name, r)
        np.testing.assert_allclose(got["decode"], want[rows],
                                   rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"rank {r}")


def test_shards_are_the_layouts(ranks):
    """Rank 0's parameter shards have the shapes `param_spec` gives: the
    embedding split over model and data under (1, 2)."""
    out = ranks[1]
    _, tcfg = _cfgs("dense", "model2")
    lay = RankLayout((1, 2), ("data", "model"), 0, torch.device("cpu"))
    shapes, _ = TS.model_specs(tcfg)
    specs = TS.resolve_param_shardings(tcfg, lay, shapes)
    from repro_torch.distributed.sharding import shard_shape
    for k, shp in out["dense/model2"]["shapes"].items():
        assert tuple(shp) == shard_shape(shapes[k].shape, specs[k], lay), k
    assert specs["embedding"] == ("model", "data")


def test_moe_split_that_breaks_the_grouping_raises(ranks):
    out = ranks[1]
    msg = out["moe_split"]
    assert msg.startswith("MoE grouping") and "2 ranks" in msg, msg


def test_checkpoint_resumes_bitwise_on_two_ranks(ranks):
    out = ranks[1]
    ck = out["ckpt"]
    assert ck["went_on"] == ck["resumed"]
    assert ck["params_equal"] and ck["moments_equal"]


def test_checkpoint_from_two_ranks_resumes_on_one(ranks):
    """The P = 2 checkpoint restores on one rank (whole tensors); two
    steps there land within 1e-5 of the two ranks' run."""
    tmp, out = ranks[:2]
    _, cfg = _cfgs("dense", "data2")
    step = TS.make_train_step(cfg, None, linear_warmup_cosine(*LR))
    data = SyntheticLMDataset(cfg.vocab_size, CONFIGS["dense"][2],
                              CONFIGS["dense"][1], seed=1)
    state = TS.init_train_state(cfg, 3, "cpu")
    mgr = CheckpointManager(str(tmp / "ckpt"), async_save=False)
    state = TS.load_state_tree(state, mgr.restore(TS.state_tree(state)))
    assert int(state.step) == 2
    losses = []
    for s in range(2, 4):
        state, m = step(state, data.batch(s))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, out["ckpt"]["went_on"], rtol=1e-5)
    with open(tmp / "ckpt_final.pkl", "rb") as f:
        final = pickle.load(f)
    for k, p in TS.named_params(state.params).items():
        np.testing.assert_allclose(p.detach().numpy(), final["params"][k],
                                   rtol=0, atol=STATE_ATOL, err_msg=k)


def test_one_rank_layout_is_bitwise_the_one_rank_step():
    _, cfg = _cfgs("moe", "model2")
    cfg = cfg.replace(remat="full")
    one = RankLayout((1, 1), ("data", "model"), 0, torch.device("cpu"))
    lr = linear_warmup_cosine(*LR)
    a = TS.init_train_state(cfg, 0, "cpu", layout=one)
    b = TS.init_train_state(cfg, 0, "cpu")
    sa, sb = TS.make_train_step(cfg, one, lr), TS.make_train_step(cfg, None,
                                                                   lr)
    data = SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=0)
    for s in range(2):
        a, ma = sa(a, data.batch(s))
        b, mb = sb(b, data.batch(s))
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    pa, pb = TS.named_params(a.params), TS.named_params(b.params)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("world", [1, 2])
def test_compressed_psum_unbiased_over_time(ranks, world):
    """The reference's tests/test_substrate.py case: 50 error-feedback
    int8 all-reduces average to the true mean within 1e-3 (P = 1 in
    process; P = 2 from the ranks, whose gradients differ but average to
    the same g). P = 2 sends int32 sums and f32 maxima."""
    g = torch.linspace(-1, 1, 64)
    if world == 1:
        from repro_torch.distributed.collectives import Comm
        comm = Comm("cpu")
        err = C.init_error_state({"w": g})
        acc = torch.zeros(64)
        for _ in range(50):
            mean, err = C.compressed_psum({"w": g}, err, comm)
            acc = acc + mean["w"]
        got = acc / 50
    else:
        out = ranks[1]
        got = torch.tensor(out["compressed"])
        kinds = out["compressed_bytes"]
        assert kinds["all-reduce"]["count"] == 100
        # 50 f32 maxima and 50 int32 sums of 64 entries
        assert kinds["all-reduce"]["operand_bytes"] == 50 * 4 + 50 * 64 * 4
    np.testing.assert_allclose(got.numpy(), g.numpy(), atol=1e-3)
