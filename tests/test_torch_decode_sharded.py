"""Decode on several ranks: the serve step at P = 2 gloo ranks on the CPU
against the reference's `prefill_step` and `decode_step` on the global
batch, the decode split's FLOPs and collectives, and the decode state's
specs and placement.

One spawn of two ranks runs every case (`_RANK`, its own spawn, so under
`--dist loadfile` it runs beside tests/test_torch_train_sharded.py's).
Each case builds the reference's smoke weights (per-layer layout,
`convert.model_params_from_numpy`), places them over the case's layout
(`build_prefill_step` / `build_serve_step`), prefills a prompt of B 2 x
T 16 into caches of MAX_LEN 40 positions (each rank its rows, and its
block of 20 positions where "cache_seq" splits over "model") and takes
8 serve steps of fixed tokens, so the written position crosses from rank
0's block to rank 1's at 20. `moe/data2` cannot prefill on batch-split
ranks (2 x 16 tokens form one MoE group of 32, `models/moe.py`), so its
state is the reference's whole prefill state cut by
`Placement.decode_state`.

| case | arch (smoke) | layout | what splits |
|---|---|---|---|
| dense/model2 | qwen3-14b | data 1 x model 2 | heads 4, kv 2, d_ff 128, vocab 256, the cache |
| dense_fallback/model2 | qwen3-14b, 1 kv head, MAX_LEN 41 | data 1 x model 2 | heads, d_ff, vocab; kv heads and the cache whole |
| dense/data2 | qwen3-14b | data 2 | rows only |
| dense/dp | qwen3-14b | "dp" profile, data 1 x model 2 | rows over data and model |
| moe/model2 | granite-moe-1b-a400m | data 1 x model 2 | 2 of 4 experts a rank, the rest as dense |
| moe/data2 | granite-moe-1b-a400m | data 2 | rows; one MoE group across the ranks |
| moe3/model2 | granite-moe-1b-a400m, 3 experts | data 1 x model 2 | experts repeat |
| local/model2 | recurrentgemma-9b | data 1 x model 2 | window-8 attention across the blocks; RG-LRU split (32 channels a rank) |
| dense_heads/model2 | qwen3-14b, 3 heads, 1 kv head | data 1 x model 2 | d_ff, vocab, the cache; every head on every rank |
| dense_kv/model2 | qwen3-14b, MAX_LEN 41 | data 1 x model 2 | heads, kv heads (k/v gathered to write every head), d_ff, vocab; the cache whole |
| dense_odd/model2 | qwen3-14b, 6 heads, 3 kv heads, MAX_LEN 41 | data 1 x model 2 | heads (3 a rank: a kv head a query head), d_ff, vocab; kv heads and the cache whole |
| recurrent/model2 | recurrentgemma-9b, RG-LRU width 96 | data 1 x model 2 | the RG-LRU at a width of its own (48 channels a rank), d_ff, vocab, heads, the cache |
| xlstm/model2 | xlstm-350m | data 1 x model 2 | mLSTM and sLSTM: 2 heads a rank, the conv's channels, vocab; no cache |
| xlstm_heads1/model2 | xlstm-350m, 1 head | data 1 x model 2 | the mLSTM's conv channels and row blocks (summed: every rank runs the head), the sLSTM's projections (gathered); heads whole |
| rglru_odd/model2 | recurrentgemma-9b, RG-LRU width 63 | data 1 x model 2 | d_ff, vocab, heads, the cache; the RG-LRU whole |

Tolerances: every step's logits (the rank's rows) within DECODE_TOL
(1e-3 relative and absolute; the caches are bf16), as
tests/test_torch_train_sharded.py holds a decode; after the last step
each rank's caches equal its block of the reference's within one bf16
step (2^-7 relative), its recurrent states (f32) its block of the
reference's (along the heads or channels its split names) within 1e-5.
At data 1 x model 2 a dense, MoE or recurrent step counts at most
FLOP_SHARE of one rank's FLOPs on the same step (`FlopCounterMode`), and
the weight gathers (`ShardPlan.gather`'s collectives, tag "weights")
move no byte.
"""
import json
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jcfgs
from repro import models as JM
from repro.distributed import sharding as JS
from repro_torch import configs as tcfgs
from repro_torch import convert, envutil
from repro_torch import models as lm
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import RankLayout
from repro_torch.train import step as TS

DECODE_TOL, STATE_ATOL, CACHE_RTOL, FLOP_SHARE = 1e-3, 1e-5, 2.0 ** -7, 0.6
B, T, STEPS, MAX_LEN = 2, 16, 8, 40
#: name -> (arch, config overrides, max_len, model_parallel, profile)
CASES = {
    "dense/model2": ("qwen3-14b", {}, MAX_LEN, 2, "default"),
    "dense_fallback/model2": ("qwen3-14b", {"num_kv_heads": 1}, MAX_LEN + 1,
                              2, "default"),
    "dense/data2": ("qwen3-14b", {}, MAX_LEN, 1, "default"),
    "dense/dp": ("qwen3-14b", {}, MAX_LEN, 2, "dp"),
    "moe/model2": ("granite-moe-1b-a400m", {}, MAX_LEN, 2, "default"),
    "moe/data2": ("granite-moe-1b-a400m", {}, MAX_LEN, 1, "default"),
    "moe3/model2": ("granite-moe-1b-a400m", {"num_experts": 3}, MAX_LEN, 2,
                    "default"),
    "local/model2": ("recurrentgemma-9b", {}, MAX_LEN, 2, "default"),
    "dense_heads/model2": ("qwen3-14b", {"num_heads": 3, "num_kv_heads": 1},
                           MAX_LEN, 2, "default"),
    "dense_kv/model2": ("qwen3-14b", {}, MAX_LEN + 1, 2, "default"),
    "dense_odd/model2": ("qwen3-14b", {"num_heads": 6, "num_kv_heads": 3},
                         MAX_LEN + 1, 2, "default"),
    "recurrent/model2": ("recurrentgemma-9b", {"rnn_width": 96}, MAX_LEN, 2,
                         "default"),
    "xlstm/model2": ("xlstm-350m", {}, MAX_LEN, 2, "default"),
    "xlstm_heads1/model2": ("xlstm-350m", {"num_heads": 1}, MAX_LEN, 2,
                            "default"),
    "rglru_odd/model2": ("recurrentgemma-9b", {"rnn_width": 63}, MAX_LEN, 2,
                         "default")}
#: what each case's decode split splits over "model" (`TokenSplit.tp`)
SPLITS = {
    "dense/model2": {"act_heads", "act_kv_heads", "act_mlp", "act_vocab",
                     "cache_seq"},
    "dense_fallback/model2": {"act_heads", "act_mlp", "act_vocab"},
    "dense/data2": set(), "dense/dp": set(),
    "moe/model2": {"act_heads", "act_kv_heads", "act_vocab", "act_experts",
                   "cache_seq"},
    "moe/data2": set(),
    "moe3/model2": {"act_heads", "act_kv_heads", "act_vocab", "cache_seq"},
    "local/model2": {"act_heads", "act_mlp", "act_vocab", "cache_seq",
                     "rglru.act_mlp"},
    "dense_heads/model2": {"act_mlp", "act_vocab", "cache_seq"},
    "dense_kv/model2": {"act_heads", "act_kv_heads", "act_mlp", "act_vocab"},
    "dense_odd/model2": {"act_heads", "act_mlp", "act_vocab"},
    "recurrent/model2": {"act_heads", "act_mlp", "act_vocab", "cache_seq",
                         "rglru.act_mlp"},
    "xlstm/model2": {"act_vocab", "mlstm.act_heads", "mlstm.act_mlp",
                     "slstm.act_heads"},
    "xlstm_heads1/model2": {"act_vocab", "mlstm.act_mlp"},
    "rglru_odd/model2": {"act_heads", "act_mlp", "act_vocab", "cache_seq"}}

#: the layouts of tests/test_torch_sharding.py
LAYOUTS = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
           (2, 2): ("data", "model"), (1, 4): ("data", "model"),
           (4, 1): ("data", "model")}


def _cfgs(name):
    arch, kw, _, _, prof = CASES[name]
    kw = dict(kw, sharding_profile=prof)
    return (jcfgs.smoke(jcfgs.get_config(arch)).replace(scan_layers=False,
                                                        **kw),
            tcfgs.smoke(tcfgs.get_config(arch)).replace(scan_layers=False,
                                                        **kw))


_RANK = r"""
import json, pickle, sys
import numpy as np, torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch import configs as tcfgs, convert, models as lm
from repro_torch.distributed.collectives import end_rank, init_rank
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import step as TS
rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
init_rank(rank, world, port, "gloo")
with open(f"{tmp}/job.pkl", "rb") as f:
    job = pickle.load(f)
out = {}

def plain(state):
    return [{k: (str(v.dtype), v.float().numpy())
             if isinstance(v, torch.Tensor) else v for k, v in st.items()}
            for st in state]

for key, c in job.items():
    cfg = tcfgs.smoke(tcfgs.get_config(c["arch"])).replace(**c["kw"])
    lay = make_host_mesh(c["mp"], "cpu")
    model = lm.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_numpy(c["params"], cfg),
                          strict=True)
    prefill, place = TS.build_prefill_step(cfg, lay, max_len=c["max_len"])
    serve, _ = TS.build_serve_step(cfg, lay)
    place.params(model)
    if c["whole"] is not None:        # the reference's prefill state, cut
        state = place.decode_state([
            {k: torch.from_numpy(v[1]).to(getattr(torch, v[0]))
             if isinstance(v, tuple) else v for k, v in st.items()}
            for st in c["whole"]])
    else:
        _, state = prefill(model, torch.from_numpy(c["tokens"]))
    rows = place._rows(c["tokens"].shape[0])
    logits, flops, tags = [], [], []
    for s in range(len(c["next"])):
        for comm in lay.comms():
            comm.reset_counts()
        with FlopCounterMode(display=False) as fc:
            got, state = serve(model, torch.from_numpy(c["next"][s]), state)
        logits.append(got.numpy())
        flops.append(fc.get_total_flops())
        by = {}
        for comm in lay.comms():
            for tag, kinds in comm.by_tag.items():
                for kind, rec in kinds.items():
                    d = by.setdefault(tag, {}).setdefault(
                        kind, {"count": 0, "operand_bytes": 0})
                    d["count"] += rec["count"]
                    d["operand_bytes"] += rec["operand_bytes"]
        tags.append(by)
    split = model.shard_plan.split
    again = again_step = None
    if c["whole"] is None:
        # a forward straight after the decode steps runs on the rows, its
        # whole recurrent states cut to the decode split's blocks
        again, st = lm.prefill_step(model, torch.from_numpy(
            c["tokens"][rows]), max_len=c["max_len"])
        again = again.numpy()
        again_step = lm.decode_step(model, torch.from_numpy(
            c["next"][0][rows]), st)[0].numpy()
    with open(f"{tmp}/{key.replace('/', '__')}__{rank}.pkl", "wb") as f:
        pickle.dump({"logits": logits, "state": plain(state),
                     "again": again, "again_step": again_step}, f)
    out[key] = {"rows": [rows.start, rows.stop], "flops": flops,
                "tags": tags, "tp": sorted(split.tp),
                "tp_rank": split.tp_comm.rank, "decode": split.decode,
                "cache_len": state.cache_len}

with open(f"{tmp}/out{rank}.json", "w") as f:
    json.dump(out, f)
end_rank()
"""


def _reference(name):
    """(the rank job of case `name`, the reference's results: logits a
    step [STEPS, B, V] and the state after the last step, per layer)."""
    jcfg, _ = _cfgs(name)
    arch, kw, max_len, mp, prof = CASES[name]
    params = jax.tree.map(np.asarray, JM.init_model(
        jcfg, jax.random.PRNGKey(1))[0])
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    nxt = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (STEPS, B)).astype(np.int32)
    last, st = jax.jit(JM.prefill_step, static_argnames=(
        "cfg", "max_len", "cache_dtype"))(params, jcfg, jnp.asarray(tokens),
                                          max_len=max_len)
    whole = None
    if name == "moe/data2":
        whole = [{k: (("bfloat16", np.asarray(v, np.float32))
                      if k in ("k", "v") else
                      ("float32", np.asarray(v, np.float32)))
                  if k != "pos" else int(v) for k, v in x.items()}
                 for x in st["layers"] + st["rem"]]
    dec = jax.jit(JM.decode_step, static_argnames=("cfg",))
    logits = []
    for s in range(STEPS):
        lg, st = dec(params, jcfg, jnp.asarray(nxt[s]), st)
        logits.append(np.asarray(lg))
    state = [jax.tree.map(lambda a: np.asarray(a, np.float32), x)
             for x in st["layers"] + st["rem"]]
    job = dict(arch=arch, kw=dict(kw, sharding_profile=prof,
                                  scan_layers=False),
               params=params, tokens=tokens, next=nxt, max_len=max_len,
               mp=mp, whole=whole)
    return job, (np.stack(logits), state, np.asarray(last))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once; returns (tmp dir, [rank 0's JSON, rank
    1's], the reference's results by case, the ranks' jobs)."""
    tmp = tmp_path_factory.mktemp("decode_sharded")
    jobs, ref = {}, {}
    for name in CASES:
        jobs[name], ref[name] = _reference(name)
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(jobs, f)
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
    return tmp, outs, ref, jobs


def _rank_result(tmp, name, rank):
    with open(tmp / f"{name.replace('/', '__')}__{rank}.pkl", "rb") as f:
        return pickle.load(f)


def _block(name, out):
    """(first position, positions) of the rank's caches."""
    max_len = CASES[name][2]
    if "cache_seq" not in out["tp"]:
        return 0, max_len
    n = max_len // 2
    return out["tp_rank"] * n, n


def _state_block(cfg, i, key, want, out):
    """The rank's block of the reference's recurrent state `want` (its
    rows) of layer i: halved along each dim whose act name
    (`decode_state_specs`, e.g. "act_heads" of an mLSTM's C) the case's
    split names ("mlstm.act_heads")."""
    kind = cfg.layer_types[i]
    for d, ax in enumerate(lm.decode_state_specs(cfg)[i][key]):
        if ax and f"{kind}.{ax}" in out["tp"]:
            want = np.split(want, 2, axis=d)[out["tp_rank"]]
    return want


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_reference(ranks, name):
    """Each rank's rows of every step's logits within DECODE_TOL of the
    reference's decode on the global batch; after the last step its
    caches are its block of the reference's (bf16: within one bf16 step),
    its recurrent states its block of the reference's rows (f32)."""
    tmp, outs, ref, _ = ranks
    want_logits, want_state, _ = ref[name]
    _, cfg = _cfgs(name)
    caches = any(k in lm.transformer.ATTN_KINDS for k in cfg.layer_types)
    for r, out in enumerate(o[name] for o in outs):
        assert out["decode"] and set(out["tp"]) == SPLITS[name], out["tp"]
        assert out["cache_len"] == (CASES[name][2] if caches else None)
        rows = slice(*out["rows"])
        assert rows == (slice(0, B) if name.endswith("model2")
                        else slice(r * B // 2, (r + 1) * B // 2))
        got = _rank_result(tmp, name, r)
        np.testing.assert_allclose(np.stack(got["logits"]),
                                   want_logits[:, rows], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"rank {r}")
        c0, n = _block(name, out)
        assert len(got["state"]) == len(want_state)
        for i, (g, w) in enumerate(zip(got["state"], want_state)):
            assert set(g) == set(w), i
            for k in g:
                if k == "pos":
                    assert g[k] == int(w[k]) == T + STEPS
                elif k in ("k", "v"):
                    assert g[k][0] == "torch.bfloat16"
                    np.testing.assert_allclose(
                        g[k][1], w[k][rows, c0:c0 + n], rtol=CACHE_RTOL,
                        atol=STATE_ATOL, err_msg=f"rank {r} layer {i} {k}")
                else:
                    np.testing.assert_allclose(
                        g[k][1], _state_block(cfg, i, k, w[k][rows], out),
                        rtol=0, atol=STATE_ATOL,
                        err_msg=f"rank {r} layer {i} {k}")


@pytest.mark.parametrize("name", [n for n in CASES if n != "moe/data2"])
def test_prefill_after_decode_runs_on_the_rows(ranks, name):
    """`prefill_step` called straight after the serve steps (no
    `build_prefill_step` to set the batch) never runs on the decode
    step's split: each rank runs its rows whole (`ShardPlan.rows_only`),
    and its last logits equal the reference's prefill within 1e-4, as
    tests/test_torch_train_sharded.py holds a prefill; a decode step from
    that state (its caches and recurrent states cut to the decode split's
    blocks by the prefill) equals the reference's first step within
    DECODE_TOL."""
    tmp, outs, ref, _ = ranks
    want = ref[name][2]
    for r, out in enumerate(o[name] for o in outs):
        got = _rank_result(tmp, name, r)
        rows = slice(*out["rows"])
        np.testing.assert_allclose(got["again"], want[rows],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["again_step"], ref[name][0][0][rows],
                                   rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"rank {r}")


def _one_rank_flops(name, job):
    """FLOPs of each of the STEPS one-rank decode steps on the global
    batch (the port's, on the CPU) of a rank job."""
    _, cfg = _cfgs(name)
    model = lm.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_numpy(job["params"],
                                                          cfg), strict=True)
    _, state = lm.prefill_step(model, torch.from_numpy(job["tokens"]),
                               max_len=job["max_len"])
    flops = []
    for s in range(STEPS):
        with FlopCounterMode(display=False) as fc:
            _, state = lm.decode_step(model, torch.from_numpy(job["next"][s]),
                                      state)
        flops.append(fc.get_total_flops())
    return flops


@pytest.mark.parametrize("name", ["dense/model2", "moe/model2",
                                  "local/model2", "xlstm/model2"])
def test_decode_split_cuts_rank_flops(ranks, name):
    """At data 1 x model 2 each rank's decode steps count at most
    FLOP_SHARE of one rank's on the same global batch, step by step
    (the attention's scores run all heads on the rank's block; the
    recurrent blocks run their own channels and heads)."""
    outs = ranks[1]
    one = _one_rank_flops(name, ranks[3][name])
    for out in outs:
        for s, (f, o) in enumerate(zip(out[name]["flops"], one)):
            assert 0 < f <= FLOP_SHARE * o, (s, f, o)


@pytest.mark.parametrize("name", ["dense/model2", "moe/model2",
                                  "local/model2", "recurrent/model2",
                                  "xlstm/model2", "xlstm_heads1/model2",
                                  "rglru_odd/model2"])
def test_decode_weight_gathers_move_nothing(ranks, name):
    """At data 1 x model 2 every model-sharded dim is kept (a recurrent
    block's "rnn" dims too) and FSDP's data axis has size 1: a decode
    step's weight gathers move no byte, and its other collectives carry
    activations only (their bytes are printed, not bounded: at smoke
    widths the activations are not small beside the weights); the
    attention's, and a split recurrent block's ("rnn"), among them."""
    outs = ranks[1]
    _, cfg = _cfgs(name)
    want = {"logits", "embed"}
    if any(k in lm.transformer.ATTN_KINDS for k in cfg.layer_types):
        want.add("attn")
    if any(n.partition(".")[0] in cfg.layer_types for n in SPLITS[name]):
        want.add("rnn")
    for r, out in enumerate(outs):
        for s, tags in enumerate(out[name]["tags"]):
            moved = sum(d["operand_bytes"]
                        for d in tags.get("weights", {}).values())
            assert moved == 0, (r, s, tags)
            assert want <= set(tags), tags
        print(name, "rank", r, "step 1 collectives by tag:",
              json.dumps(out[name]["tags"][0]))


def test_moe_decode_groups_across_batch_split_ranks(ranks):
    """Under data 2 the ranks gather their decode tokens (and routing)
    into the global batch's one group: one all-gather each of the tokens,
    gates and experts a MoE layer a step, tagged "moe"."""
    outs = ranks[1]
    _, cfg = _cfgs("moe/data2")
    n_moe = sum(k == "moe" for k in cfg.layer_types)
    for out in outs:
        for tags in out["moe/data2"]["tags"]:
            assert tags["moe"]["all-gather"]["count"] == 3 * n_moe, tags


# ---------------------------------------------------------------------------
# the decode state's specs and placement (in process)
# ---------------------------------------------------------------------------

def _ref_state_specs(cfg):
    """The reference's `decode_state_specs(cfg)` per layer, without the
    "layers" axis its scanned configs stack."""
    tree = JM.decode_state_specs(cfg)
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)
    if "groups" in tree:
        per = [None] * (n_groups * len(pat))
        for j, spec in enumerate(tree["groups"]):
            strip = {k: v[1:] for k, v in spec.items()}
            for g in range(n_groups):
                per[g * len(pat) + j] = strip
    else:
        per = list(tree["layers"])
    return per + list(tree["rem"])


@pytest.mark.parametrize("arch", tcfgs.ASSIGNED_ARCHS)
def test_decode_state_specs_match_reference(arch):
    jcfg = jcfgs.get_config(arch)
    got = lm.decode_state_specs(tcfgs.get_config(arch))
    want = _ref_state_specs(jcfg)
    assert len(got) == len(want) == jcfg.num_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == {k: tuple(v) for k, v in w.items()}, i


def _fake_mesh(shape, axes):
    class FakeMesh:
        axis_names = axes
        devices = np.empty(shape, object)
    return FakeMesh()


@pytest.mark.parametrize("shape", list(LAYOUTS), ids=str)
@pytest.mark.parametrize("arch", tcfgs.ASSIGNED_ARCHS)
def test_placement_decode_state_is_the_reference_resolution(arch, shape):
    """`Placement.decode_state` of a whole decode state (full widths, 64
    rows of 128 positions, "meta": nothing allocated) on rank 0 of each
    layout: every KV cache has the shape the reference's `spec_for`
    resolution of its specs gives (rows and the block along
    "cache_seq"), and so has every recurrent state (rows and its blocks
    along "act_heads" / "act_mlp" where they divide)."""
    axes = LAYOUTS[shape]
    cfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    rules = JS.rules_for_profile(jcfg.sharding_profile)
    mesh = _fake_mesh(shape, axes)
    lay = RankLayout(shape, axes, 0, torch.device("cpu"))
    whole = lm.init_decode_state(cfg, 64, 128, device="meta")
    got = TS.Placement(cfg, lay).decode_state(whole)
    caches = any(k in ("attn", "local", "moe") for k in cfg.layer_types)
    assert isinstance(got, lm.DecodeState)
    assert got.cache_len == (128 if caches else None)
    for i, (g, w, spec) in enumerate(zip(got, whole,
                                         _ref_state_specs(jcfg))):
        for k, v in w.items():
            if not isinstance(v, torch.Tensor):
                assert g[k] == v
                continue
            ref = tuple(JS.spec_for(spec[k], v.shape, mesh, rules))
            ref = ref + (None,) * (v.ndim - len(ref))
            assert tuple(g[k].shape) == S.shard_shape(v.shape, ref, lay), (
                i, k, g[k].shape, ref)
