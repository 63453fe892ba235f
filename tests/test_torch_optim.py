"""The optimizer and the data pipeline of the training path against the
reference's, and the reference's own tests of them ported
(tests/test_substrate.py: adamw, schedules, dataset, prefetcher, the
NamedTuple checkpoint round trip).

Tolerances: the optimizer alone, fed the reference's gradients
converted, holds parameters and moments within 1e-6 (f32; the two
packages evaluate the same formula, `pow` and `sqrt` may round apart by
an ulp); with bf16 parameters within one bf16 step of the parameter
(2^-7 relative), since an f32 update an ulp apart can round to the next
bf16 value. The schedules within two f32 ulps of the base rate (2.4e-7
of it: XLA's cos and the C library's round apart, and the decay's tail
magnifies that relative to the small rates there); the datasets bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro import models as JM
from repro.data import Prefetcher as JPrefetcher
from repro.data import SyntheticLMDataset as JDataset
from repro.data import TokenFileDataset as JTokenFile
from repro.optim import adamw_init as j_init
from repro.optim import adamw_update as j_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import cosine_schedule as j_cos
from repro.optim import linear_warmup_cosine as j_lr
from repro.train import step as JTS
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import Prefetcher, SyntheticLMDataset, TokenFileDataset
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               linear_warmup_cosine)
from repro_torch.train import step as TS

OPT_ATOL = 1e-6
BF16_RTOL = 2.0 ** -7
SCHED_RTOL = 2.4e-7


# ---------------------------------------------------------------------------
# The reference's optimizer tests, on the port
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    target = {"w": torch.tensor([1.0, 1.0]), "b": torch.tensor(0.0)}
    state = adamw_init(params)

    def loss(p):
        return sum(torch.sum((p[k] - target[k]) ** 2) for k in p)

    for _ in range(300):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        params, state = adamw_update(g, state, params, lr=5e-2,
                                     weight_decay=0.0)
    assert float(loss(params)) < 1e-3
    assert int(state.step) == 300


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(gn), 20.0)
    total = float(torch.sqrt(torch.sum(torch.square(clipped["a"]))))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def test_lr_schedule_shape():
    lr = linear_warmup_cosine(1e-3, 10, 100)
    assert float(lr(0)) == 0.0
    np.testing.assert_allclose(float(lr(10)), 1e-3, rtol=1e-5)
    assert float(lr(100)) < float(lr(50))
    assert lr(torch.tensor(5, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (30, 300)])
def test_schedules_match_reference(warmup, total):
    lr, jlr = linear_warmup_cosine(6e-4, warmup, total), \
        j_lr(6e-4, warmup, total)
    cos, jcos = cosine_schedule(1e-3, total), j_cos(1e-3, total)
    for s in range(0, total + 5, 3):
        np.testing.assert_allclose(float(lr(s)), float(jlr(jnp.int32(s))),
                                   rtol=0, atol=SCHED_RTOL * 6e-4)
        np.testing.assert_allclose(float(cos(s)), float(jcos(jnp.int32(s))),
                                   rtol=0, atol=SCHED_RTOL * 1e-3)


# ---------------------------------------------------------------------------
# The optimizer alone against the reference's, on the reference's grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m", "qwen3-14b",
                                  "xlstm-350m"))
def test_adamw_on_reference_gradients(arch):
    """Three updates of the port's AdamW (clipping included) fed the
    reference's own gradients, converted: parameters and moments within
    1e-6 of the reference's AdamW on the same gradients. This holds the
    optimizer apart from the gradients, whose rounding AdamW's
    normalised step would amplify to ±lr."""
    jcfg = jcfgs.smoke(jcfgs.get_config(arch))
    tcfg = tcfgs.smoke(tcfgs.get_config(arch))
    jstate = JTS.init_train_state(jcfg, jax.random.PRNGKey(1))
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, "cpu")
    params = TS.named_params(state.params)
    opt = state.opt
    data = JDataset(jcfg.vocab_size, 16, 2, seed=3)
    grad_fn = jax.jit(jax.grad(lambda p, b: JM.lm_loss(p, jcfg, b)[0]))
    jp, jopt = jstate.params, jstate.opt
    jlr, lr = j_lr(1e-3, 1, 10), linear_warmup_cosine(1e-3, 1, 10)
    # jitted: eager JAX compiles every op of every leaf on its own
    jclip = jax.jit(lambda g: j_clip(g, 1.0))
    jupdate = jax.jit(lambda g, o, p, s: j_update(g, o, p, lr=jlr(s)))
    for s in range(3):
        jg = grad_fn(jp, data.batch(s))
        g = convert.model_params_from_numpy(jax.tree.map(np.asarray, jg),
                                            tcfg)
        jg, jgn = jclip(jg)
        g, gn = clip_by_global_norm(g, 1.0)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        jp, jopt = jupdate(jg, jopt, jp, jnp.int32(s + 1))
        params, opt = adamw_update(g, opt, params, lr=lr(s + 1))
    want = {name: convert.model_params_from_numpy(
        jax.tree.map(np.asarray, tree), tcfg)
        for name, tree in (("p", jp), ("m", jopt.m), ("v", jopt.v))}
    assert int(opt.step) == int(jopt.step) == 3
    for k in params:
        for name, got in (("p", params[k]), ("m", opt.m[k]),
                          ("v", opt.v[k])):
            np.testing.assert_allclose(got.detach().numpy(),
                                       want[name][k].numpy(), rtol=0,
                                       atol=OPT_ATOL, err_msg=f"{name} {k}")


def test_adamw_bf16_parameters_match_reference():
    """bf16 parameters, f32 moments and a strongly typed f32 learning
    rate (as in the train step): the update is taken in f32 and cast to
    bf16, as JAX promotes it."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 32), "b": (32,), "c": (3, 5, 7)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    jopt, opt = j_init(jp), adamw_init(tp)
    for s in range(4):
        g = {k: rng.normal(size=sh).astype(np.float32) * 10 ** -s
             for k, sh in shapes.items()}
        jp, jopt = j_update({k: jnp.asarray(v, jnp.bfloat16)
                             for k, v in g.items()}, jopt, jp,
                            lr=jnp.float32(3e-2))
        tp, opt = adamw_update({k: torch.from_numpy(v).to(torch.bfloat16)
                                for k, v in g.items()}, opt, tp,
                               lr=torch.tensor(3e-2))
    for k in shapes:
        assert tp[k].dtype == torch.bfloat16
        want = np.asarray(jp[k].astype(jnp.float32))
        np.testing.assert_allclose(tp[k].float().numpy(), want,
                                   rtol=BF16_RTOL, atol=0, err_msg=k)
        np.testing.assert_allclose(opt.m[k].numpy(), np.asarray(jopt.m[k]),
                                   rtol=0, atol=OPT_ATOL)
        np.testing.assert_allclose(opt.v[k].numpy(), np.asarray(jopt.v[k]),
                                   rtol=0, atol=OPT_ATOL)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

def test_synthetic_dataset_deterministic_per_step():
    d1 = SyntheticLMDataset(1000, 32, 4, seed=7)
    d2 = SyntheticLMDataset(1000, 32, 4, seed=7)
    np.testing.assert_array_equal(d1.batch(5), d2.batch(5))
    assert not np.array_equal(d1.batch(5), d1.batch(6))
    b = d1.batch(0)
    assert b.shape == (4, 33) and b.min() >= 0 and b.max() < 1000


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_synthetic_dataset_bitwise_reference(seed, hosts):
    for host in range(hosts):
        kw = dict(seed=seed, num_hosts=hosts, host_id=host, zipf_a=1.1)
        a = SyntheticLMDataset(49155, 64, 8, **kw)
        b = JDataset(49155, 64, 8, **kw)
        np.testing.assert_array_equal(a.perm, b.perm)
        for step in (0, 1, 17, 1000):
            x, y = a.batch(step), b.batch(step)
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, y)


def test_token_file_dataset_matches_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 500, 4099).astype(
        np.int32).tofile(path)
    for host in (0, 1):
        a = TokenFileDataset(str(path), 32, 8, num_hosts=2, host_id=host)
        b = JTokenFile(str(path), 32, 8, num_hosts=2, host_id=host)
        for step in (0, 3, 40):
            np.testing.assert_array_equal(a.batch(step), b.batch(step))


def test_prefetcher_order_and_restart():
    d = SyntheticLMDataset(100, 8, 2, seed=1)
    pf = Prefetcher(d, start_step=3)
    s, b = pf.next()
    assert s == 3
    np.testing.assert_array_equal(b, d.batch(3))
    s2, _ = pf.next()
    assert s2 == 4
    pf.close()
    jpf = JPrefetcher(JDataset(100, 8, 2, seed=1), start_step=3)
    np.testing.assert_array_equal(jpf.next()[1], b)
    jpf.close()


def test_host_sharded_batches_disjoint():
    g = SyntheticLMDataset(100, 8, 4, seed=2, num_hosts=2, host_id=0)
    h = SyntheticLMDataset(100, 8, 4, seed=2, num_hosts=2, host_id=1)
    assert g.batch(0).shape == (2, 9)
    assert not np.array_equal(g.batch(0), h.batch(0))


# ---------------------------------------------------------------------------
# Checkpointing the training state
# ---------------------------------------------------------------------------

def test_checkpoint_namedtuple_roundtrip(tmp_path):
    p = {"w": torch.ones((2, 2))}
    st = TS.TrainState(params=p, opt=AdamWState(
        torch.tensor(5, dtype=torch.int32), {"w": torch.zeros((2, 2))},
        {"w": torch.zeros((2, 2))}), step=torch.tensor(5, dtype=torch.int32))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, st)
    back = mgr.restore(st)
    assert isinstance(back, TS.TrainState)
    assert isinstance(back.opt, AdamWState)
    assert int(back.step) == 5
    np.testing.assert_array_equal(back.params["w"], np.ones((2, 2)))


def test_train_state_checkpoint_restores_into_a_fresh_state(tmp_path):
    """state_tree -> save -> restore -> load_state_tree gives back every
    parameter, moment and step bitwise, into another state's tensors."""
    cfg = tcfgs.smoke(tcfgs.get_config("granite-moe-1b-a400m"))
    state = TS.init_train_state(cfg, 0, "cpu")
    step = TS.make_train_step(cfg, None, linear_warmup_cosine(1e-3, 1, 5))
    data = SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=0)
    for s in range(2):
        state, _ = step(state, data.batch(s))
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(2, TS.state_tree(state))
    mgr.wait()
    fresh = TS.init_train_state(cfg, 1, "cpu")
    fresh = TS.load_state_tree(fresh, mgr.restore(TS.state_tree(fresh)))
    assert int(fresh.step) == int(fresh.opt.step) == 2
    a, b = TS.named_params(state.params), TS.named_params(fresh.params)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(state.opt.m[k], fresh.opt.m[k]), k
        assert torch.equal(state.opt.v[k], fresh.opt.v[k]), k
    s1, m1 = step(state, data.batch(2))
    s2, m2 = step(fresh, data.batch(2))
    assert float(m1["loss"]) == float(m2["loss"])
