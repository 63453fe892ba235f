"""Training on several ranks: the sharded train step at P = 2 gloo ranks
on the CPU against the reference's single-device step on the global
batch, checkpoints that reshard, and the error-feedback compressed psum.

One spawn of two ranks runs every case (`_RANK`): the reference's
initial state (JAX, `init_train_state`, converted through `convert` with
the rank's layout, so each rank keeps its shards) takes three steps of
`make_train_step(cfg, layout)` on `SyntheticLMDataset` batches, for a
dense 2-layer smoke config (qwen3-14b, `remat="dots"` under data 2) and
`smoke(granite-moe-1b-a400m)` (B 4 x T 1024: each rank's 2,048 tokens
are one global MoE group; `remat="full"` under data 2), each under
data 2, data 1 x model 2 and the "dp" profile on data 1 x model 2. The
reference takes the same three steps here with `make_train_step(cfg,
None, ...)`.

Tolerances, per step: loss 1e-5 relative, grad_norm 1e-4 relative (the
gradients sum in another order), moe_aux 1e-6 relative; after three steps
every parameter and both moments within 1e-5 absolute. P = 1 is bitwise
the one-rank step. A checkpoint saved at P = 2 resumes bitwise at P = 2
and within 1e-5 at P = 1.
"""
import json
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.optim import linear_warmup_cosine as j_lr
from repro.train import step as JTS
from repro_torch import configs as tcfgs
from repro_torch import convert, envutil
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed import collectives
from repro_torch.distributed import compression as C
from repro_torch.launch.mesh import RankLayout
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import step as TS

LOSS_RTOL, GNORM_RTOL, AUX_RTOL, STATE_ATOL = 1e-5, 1e-4, 1e-6, 1e-5
STEPS, LR = 3, (1e-3, 2, 10)
#: name -> (arch, B, T, remat under data 2)
CONFIGS = {"dense": ("qwen3-14b", 4, 16, "dots"),
           "moe": ("granite-moe-1b-a400m", 4, 1024, "full")}
#: name -> (model_parallel, sharding profile)
LAYOUTS = {"data2": (1, "default"), "model2": (2, "default"),
           "dp": (2, "dp")}
CASES = [(c, lay) for c in CONFIGS for lay in LAYOUTS]


def _cfgs(name, layout):
    arch, _, _, remat = CONFIGS[name]
    mp, prof = LAYOUTS[layout]
    kw = dict(sharding_profile=prof,
              remat=remat if layout == "data2" else "none")
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
from repro_torch import configs as tcfgs, convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed import compression as C
from repro_torch.distributed.collectives import init_rank
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import step as TS
rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
init_rank(rank, world, port, "gloo")
job = pickle.load(open(f"{tmp}/job.pkl", "rb"))
out = {}

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
        state, m = step(state, data.batch(s))
        ms.append({k: float(v) for k, v in m.items()})
    w = whole(state)
    out[key] = {"metrics": ms, "shapes": {
        k: list(p.shape) for k, p in state.params.named_parameters()}}
    if rank == 0:
        pickle.dump(w, open(f"{tmp}/{key.replace('/', '__')}.pkl", "wb"))

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

if rank == 0:
    json.dump(out, open(f"{tmp}/out.json", "w"))
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once; returns (tmp dir, their JSON, the
    reference's per-case results)."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases, ref = {}, {}
    for name, (arch, B, T, _) in CONFIGS.items():
        for lay in LAYOUTS:
            jcfg, _ = _cfgs(name, lay)
            jstate = JTS.init_train_state(jcfg, jax.random.PRNGKey(0))
            cases[f"{name}/{lay}"] = dict(
                arch=arch, B=B, T=T, mp=LAYOUTS[lay][0],
                kw=dict(sharding_profile=jcfg.sharding_profile,
                        remat=jcfg.remat),
                init=_plain(jstate))
            jstep = jax.jit(JTS.make_train_step(jcfg, None, j_lr(*LR)))
            data = SyntheticLMDataset(jcfg.vocab_size, T, B, seed=0)
            ms = []
            for s in range(STEPS):
                jstate, m = jstep(jstate, data.batch(s))
                ms.append({k: float(v) for k, v in m.items()})
            ref[f"{name}/{lay}"] = (ms, _plain(jstate))
    job = {"cases": cases, "lr": LR, "steps": STEPS}
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
    return tmp, json.loads((tmp / "out.json").read_text()), ref


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("case", [f"{c}/{lay}" for c, lay in CASES])
def test_sharded_step_matches_reference(ranks, case):
    tmp, out, ref = ranks
    name, lay = case.split("/")
    _, tcfg = _cfgs(name, lay)
    got, (want, jfinal) = out[case]["metrics"], ref[case]
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


def test_shards_are_the_layouts(ranks):
    """Rank 0's parameter shards have the shapes `param_spec` gives: the
    embedding split over model and data under (1, 2)."""
    _, out, _ = ranks
    _, tcfg = _cfgs("dense", "model2")
    lay = RankLayout((1, 2), ("data", "model"), 0, torch.device("cpu"))
    shapes, _ = TS.model_specs(tcfg)
    specs = TS.resolve_param_shardings(tcfg, lay, shapes)
    from repro_torch.distributed.sharding import shard_shape
    for k, shp in out["dense/model2"]["shapes"].items():
        assert tuple(shp) == shard_shape(shapes[k].shape, specs[k], lay), k
    assert specs["embedding"] == ("model", "data")


def test_moe_split_that_breaks_the_grouping_raises(ranks):
    _, out, _ = ranks
    msg = out["moe_split"]
    assert msg.startswith("MoE grouping") and "2 ranks" in msg, msg


def test_checkpoint_resumes_bitwise_on_two_ranks(ranks):
    _, out, _ = ranks
    ck = out["ckpt"]
    assert ck["went_on"] == ck["resumed"]
    assert ck["params_equal"] and ck["moments_equal"]


def test_checkpoint_from_two_ranks_resumes_on_one(ranks):
    """The P = 2 checkpoint restores on one rank (whole tensors); two
    steps there land within 1e-5 of the two ranks' run."""
    tmp, out, _ = ranks
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
        _, out, _ = ranks
        got = torch.tensor(out["compressed"])
        kinds = out["compressed_bytes"]
        assert kinds["all-reduce"]["count"] == 100
        # 50 f32 maxima and 50 int32 sums of 64 entries
        assert kinds["all-reduce"]["operand_bytes"] == 50 * 4 + 50 * 64 * 4
    np.testing.assert_allclose(got.numpy(), g.numpy(), atol=1e-3)
