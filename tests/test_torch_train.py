"""The training path on one rank: the port's train step against the
reference's, and autograd through every block kind.

For each of the ten architectures' `smoke()` config (f32; attention,
MoE, mLSTM, sLSTM, RG-LRU), the reference's `init_train_state` crosses to
the port through `convert.train_state_from_numpy`; both packages then take
three steps of `make_train_step(cfg, None, lr)` on the same
`SyntheticLMDataset` batches (embedding-input configs: the launcher's
normal inputs from `default_rng(step)`).

Tolerances (relative, per step): loss 1e-5, grad_norm 1e-4 (the
gradients sum in another order: the port's autograd against XLA's
transpose), lr 1e-6 (both compute the schedule in f32); after three steps
every parameter within 1e-4 absolute (AdamW's normalised step turns a
near-zero gradient's rounding into up to ±lr, 1e-3 here, so the
parameters agree less tightly than the losses; tests/test_torch_optim.py
holds the optimizer alone to 1e-6). `remat` none/full/dots give bitwise
equal gradients on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.data import SyntheticLMDataset as JDataset
from repro.optim import linear_warmup_cosine as j_lr
from repro.train import step as JTS
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch import models as TM
from repro_torch.models import transformer as TMT
from repro_torch.data import SyntheticLMDataset
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import step as TS

ARCHS = tcfgs.ASSIGNED_ARCHS
LOSS_RTOL, GNORM_RTOL, LR_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6, 1e-4
B, T = 2, 16


def _cfgs(arch, **kw):
    return (jcfgs.smoke(jcfgs.get_config(arch)).replace(**kw),
            tcfgs.smoke(tcfgs.get_config(arch)).replace(**kw))


def _batch(cfg, data, step):
    b = data.batch(step)
    if cfg.embed_inputs:
        rng = np.random.default_rng(step)
        return {"inputs": rng.normal(size=(B, T, cfg.d_model)).astype(
            np.float32), "labels": b[:, :T]}
    return b


def _torch_batch(batch):
    if isinstance(batch, dict):
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return torch.from_numpy(batch)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jstate = JTS.init_train_state(jcfg, jax.random.PRNGKey(0))
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, "cpu")
    jstep = jax.jit(JTS.make_train_step(jcfg, None, j_lr(1e-3, 2, 10)))
    step = TS.make_train_step(tcfg, None, linear_warmup_cosine(1e-3, 2, 10))
    data = SyntheticLMDataset(tcfg.vocab_size, T, B, seed=0)
    for s in range(3):
        batch = _batch(tcfg, data, s)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert _rel(m["loss"], jm["loss"]) <= LOSS_RTOL, (s, m, jm)
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= GNORM_RTOL, (s,)
        assert _rel(m["lr"], jm["lr"]) <= LR_RTOL, (s,)
        for k in ("nll", "z_loss", "moe_aux"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-7)
    assert int(state.step) == int(jstate.step) == 3
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    want = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, jstate.params), tcfg)
    got = TS.named_params(state.params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """One SGD step on the CPU runs and turns nothing into NaN (the
    reference's tests/test_models.py::test_smoke_train_step)."""
    _, cfg = _cfgs(arch)
    state = TS.init_train_state(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    if cfg.embed_inputs:
        batch = {"inputs": torch.from_numpy(rng.normal(
            size=(2, 16, cfg.d_model)).astype(np.float32)),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, 16)).astype(np.int32))}
    else:
        batch = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 17)).astype(np.int32))
    loss, _, grads = TS.loss_and_grads(state.params, batch)
    assert np.isfinite(float(loss))
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                           for g in grads.values()))
    assert np.isfinite(float(gnorm)) and float(gnorm) > 0
    with torch.no_grad():
        for k, p in TS.named_params(state.params).items():
            p -= 1e-3 * grads[k]
    loss2, _, _ = TS.loss_and_grads(state.params, batch)
    assert np.isfinite(float(loss2))


@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m", "xlstm-350m",
                                  "recurrentgemma-9b", "qwen3-14b",
                                  "pixtral-12b"))
def test_remat_modes_give_equal_gradients(arch):
    """cfg.remat "full" and "dots" recompute in the backward pass what
    "none" keeps; on the CPU every recomputation repeats the same
    arithmetic, so the gradients are bitwise equal."""
    _, cfg = _cfgs(arch)
    data = SyntheticLMDataset(cfg.vocab_size, T, B, seed=1)
    batch = _torch_batch(_batch(cfg, data, 0))
    grads = {}
    for remat in ("none", "full", "dots"):
        state = TS.init_train_state(cfg.replace(remat=remat), 0, "cpu")
        loss, _, grads[remat] = TS.loss_and_grads(state.params, batch)
        assert np.isfinite(float(loss))
    for remat in ("full", "dots"):
        for k, g in grads["none"].items():
            assert torch.equal(grads[remat][k], g), (remat, k)


def test_remat_rejects_unknown_mode():
    _, cfg = _cfgs("qwen3-14b")
    state = TS.init_train_state(cfg.replace(remat="some"), 0, "cpu")
    with pytest.raises(ValueError, match="remat"):
        TS.loss_and_grads(state.params, torch.zeros((1, 5), dtype=torch.int32))


def test_frozen_model_forward_skips_remat(monkeypatch):
    """Outside no_grad, a frozen model's forward runs the plain block loop
    (nothing is trained, so nothing is checkpointed); a trainable one runs
    each block through `_block_remat`."""
    _, cfg = _cfgs("qwen3-14b")
    model = TM.Transformer(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    calls = []
    real = TMT._block_remat

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(TMT, "_block_remat", counted)
    tokens = torch.zeros((1, 5), dtype=torch.int32)
    logits, _, _ = model(tokens)
    assert calls == [] and logits.grad_fn is None
    TS.trainable(model)
    logits, _, _ = model(tokens)
    assert len(calls) == cfg.num_layers and logits.grad_fn is not None


@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m", "xlstm-350m",
                                  "recurrentgemma-9b", "qwen3-14b"))
def test_serving_builds_no_graph(arch):
    """A model as constructed has frozen parameters; once trainable, the
    serving entry points still build no autograd graph (no_grad), and
    their outputs need no grad."""
    _, cfg = _cfgs(arch)
    model = TM.Transformer(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    TS.trainable(model)
    assert all(p.requires_grad for p in model.parameters())
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    last, state = TM.prefill_step(model, prompt, max_len=12)
    assert last.grad_fn is None and not last.requires_grad
    for st in state:
        for t in (st.values() if isinstance(st, dict) else ()):
            if isinstance(t, torch.Tensor):
                assert not t.requires_grad
    logits, _ = TM.decode_step(model, prompt[:, -1], state)
    assert logits.grad_fn is None and not logits.requires_grad
    toks = TM.greedy_generate(model, prompt, 3)
    assert not toks.requires_grad
    # and the loss is differentiable
    loss, _ = TM.lm_loss(model, prompt)
    assert loss.requires_grad


def test_flash_plain_version_is_differentiable_on_cpu():
    """attn_impl="flash_kernel" on CPU tensors runs the kernel's plain
    version, which autograd differentiates; its gradients equal the
    einsum path's within f32 rounding (the card's kernel refuses grad
    mode: tests/test_torch_cuda.py)."""
    _, cfg = _cfgs("qwen3-14b")
    batch = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32))
    grads = {}
    for impl in ("xla", "flash_kernel"):
        state = TS.init_train_state(cfg.replace(attn_impl=impl), 0, "cpu")
        _, _, grads[impl] = TS.loss_and_grads(state.params, batch)
    for k, g in grads["xla"].items():
        np.testing.assert_allclose(grads["flash_kernel"][k].numpy(),
                                   g.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_layouts_of_several_ranks_are_refused():
    """A step over several ranks refuses a model that was not placed on
    them (tests/test_torch_train_sharded.py runs the placed ones)."""
    from repro_torch.launch.mesh import RankLayout
    _, cfg = _cfgs("qwen3-14b")
    lay = RankLayout((2, 1), ("data", "model"), 0, torch.device("cpu"))
    state = TS.init_train_state(cfg, 0, "cpu")
    tokens = np.zeros((2, 9), np.int32)
    for make, args in ((TS.make_train_step, (state, tokens)),
                       (TS.make_serve_step, (state.params, tokens, [])),
                       (TS.make_prefill_step, (state.params, tokens))):
        with pytest.raises(ValueError, match="not sharded"):
            make(cfg, lay)(*args)
    one = RankLayout((1, 1), ("data", "model"), 0, torch.device("cpu"))
    TS.make_train_step(cfg, one, linear_warmup_cosine(1e-3, 2, 10))


def test_jax_dataset_is_the_one_fed_to_both():
    """The reference's dataset and the port's give the same batches, so
    the parity test above feeds both packages the same tokens."""
    a = JDataset(255, T, B, seed=0).batch(4)
    b = SyntheticLMDataset(255, T, B, seed=0).batch(4)
    np.testing.assert_array_equal(a, b)
    assert jnp.asarray(a).dtype == jnp.int32
