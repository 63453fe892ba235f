"""The LM serving path: the port's models against the reference.

For each of the ten architectures' `smoke()` config (f32; every block
kind: attention, MoE, mLSTM, sLSTM, RG-LRU), and recurrentgemma-9b's
smoke config again at its full head dim 256 ("recurrentgemma-9b@dh256",
the only CPU case that reaches the flash kernel's Dh 256), the
reference's `init_model` parameters cross to the port through
`convert.model_params_from_numpy`; both packages then run the same numpy
inputs. The reference's flash kernel runs as its Pallas kernel in
interpret mode, the port's as its plain version (CPU tensors).

Tolerances: forward and prefill logits 1e-4 (f32 on both sides; the
einsums sum in another order). Decode with an f32 cache 1e-4. Decode with
the default bf16 cache 1e-3: both sides round q, the new key/value and
the softmax to bf16 before f32 products (the reference's
`preferred_element_type`); an f32 value that lies within ~1e-7 of a bf16
rounding midpoint can round apart on the two sides and move a logit by
~1e-3 at these widths. Greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro import models as M
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch import models as TM
from repro_torch.models import layers as TL

KEY = jax.random.PRNGKey(0)
# the reference's entry points, jitted once per config (eager JAX compiles
# each op on its own, which costs the recurrent configs seconds a call)
J = {name: jax.jit(getattr(M, name), static_argnames=static) for name, static
     in (("forward", ("cfg",)), ("lm_loss", ("cfg",)),
         ("prefill_step", ("cfg", "max_len", "cache_dtype")),
         ("decode_step", ("cfg",)),
         ("greedy_generate", ("cfg", "num_steps", "max_len")))}
# "name@dh256": the smoke config at head_dim 256
ARCHS = ("qwen3-14b", "mistral-nemo-12b", "phi4-mini-3.8b",
         "starcoder2-7b", "pixtral-12b", "musicgen-medium",
         "granite-moe-1b-a400m", "dbrx-132b", "xlstm-350m",
         "recurrentgemma-9b", "recurrentgemma-9b@dh256")
TOKEN_ARCHS = tuple(a for a in ARCHS
                    if not tcfgs.get_config(a.split("@")[0]).embed_inputs)
ATTN_KINDS = ("attn", "local", "moe")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_DECODE_TOL = dict(rtol=1e-3, atol=1e-3)


def _cfgs(arch, **kw):
    name, _, variant = arch.partition("@")
    if variant == "dh256":
        kw = dict(kw, head_dim=256)
    return (jcfgs.smoke(jcfgs.get_config(name)).replace(**kw),
            tcfgs.smoke(tcfgs.get_config(name)).replace(**kw))


_CACHE = {}


def _pair(arch, scan_layers=True):
    """(reference cfg, params, port cfg, port model) with the same
    weights; built once per (arch, layout)."""
    key = (arch, scan_layers)
    if key not in _CACHE:
        jcfg, tcfg = _cfgs(arch, scan_layers=scan_layers)
        params, _ = M.init_model(jcfg, KEY)
        model = TM.Transformer(tcfg, device="cpu")
        sd = convert.model_params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg)
        model.load_state_dict(sd, strict=True)
        _CACHE[key] = (jcfg, params, tcfg, model)
    return _CACHE[key]


def _inputs(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# configs: the port's copy holds the reference's values
# ---------------------------------------------------------------------------

def test_config_registry_matches_reference():
    assert tcfgs.list_archs() == jcfgs.list_archs()
    assert tcfgs.ASSIGNED_ARCHS == jcfgs.ASSIGNED_ARCHS
    assert tcfgs.SHAPES == jcfgs.SHAPES
    assert [f.name for f in dataclasses.fields(tcfgs.ArchConfig)] == \
        [f.name for f in dataclasses.fields(jcfgs.ArchConfig)]
    assert dataclasses.asdict(tcfgs.ArchConfig("x", "dense", 1, 8, 1, 1, 8,
                                               10)) == \
        dataclasses.asdict(jcfgs.ArchConfig("x", "dense", 1, 8, 1, 1, 8, 10))


@pytest.mark.parametrize("arch", jcfgs.ASSIGNED_ARCHS)
def test_config_values_match_reference(arch):
    j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
    for a, b in ((j, t), (jcfgs.smoke(j), tcfgs.smoke(t))):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.head_dim_, a.padded_vocab, a.layer_types, a.rnn_width_,
                a.sub_quadratic, a.is_moe) == \
            (b.head_dim_, b.padded_vocab, b.layer_types, b.rnn_width_,
             b.sub_quadratic, b.is_moe)
        assert jcfgs.param_count(a) == tcfgs.param_count(b)
        assert jcfgs.active_param_count(a) == tcfgs.active_param_count(b)
        assert jcfgs.model_flops(a, 4096) == tcfgs.model_flops(b, 4096)


# ---------------------------------------------------------------------------
# forward, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "xla_chunked", "flash_kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl):
    jcfg, params, tcfg, model = _pair(arch)
    x = _inputs(jcfg, 2, 33)
    a, jaux, _ = J["forward"](params, jcfg.replace(attn_impl=impl),
                           jnp.asarray(x))
    model.cfg = tcfg.replace(attn_impl=impl)
    try:
        b, aux, states = TM.forward(model, torch.from_numpy(x))
    finally:
        model.cfg = tcfg
    assert b.dtype == torch.float32 and b.shape == a.shape
    assert states is None and aux.dtype == torch.float32
    assert (float(aux) == 0.0) == ("moe" not in tcfg.layer_types)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(_np(b), np.asarray(a), **LOGIT_TOL)
    if tcfg.padded_vocab != tcfg.vocab_size:
        assert float(b[..., tcfg.vocab_size:].max()) < -1e29


@pytest.mark.parametrize("arch", ARCHS)
def test_unrolled_layout_matches_reference(arch):
    """scan_layers=False: the reference's "layer{i}" tree converts too."""
    jcfg, params, tcfg, model = _pair(arch, scan_layers=False)
    assert "layer0" in params and "groups" not in params
    x = _inputs(jcfg, 2, 12, seed=1)
    a, _, _ = J["forward"](params, jcfg, jnp.asarray(x))
    b, _, _ = TM.forward(model, torch.from_numpy(x))
    np.testing.assert_allclose(_np(b), np.asarray(a), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    jcfg, params, tcfg, model = _pair(arch)
    rng = np.random.default_rng(2)
    if jcfg.embed_inputs:
        x = _inputs(jcfg, 2, 16, seed=2)
        y = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
        ja, jm = J["lm_loss"](params, jcfg, jnp.asarray(x), jnp.asarray(y))
        ta, tm = TM.lm_loss(model, torch.from_numpy(x), torch.from_numpy(y))
    else:
        x = _inputs(jcfg, 2, 17, seed=2)
        ja, jm = J["lm_loss"](params, jcfg, jnp.asarray(x))
        ta, tm = TM.lm_loss(model, torch.from_numpy(x))
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    for name in ("nll", "z_loss", "moe_aux"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# serving: prefill, decode, greedy generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch, cache):
    jcfg, params, tcfg, model = _pair(arch)
    x = _inputs(jcfg, 2, 21, seed=3)
    T = 20
    jlast, jst = J["prefill_step"](params, jcfg, jnp.asarray(x[:, :T]),
                                max_len=T + 4, cache_dtype=jnp.dtype(cache))
    tlast, tst = TM.prefill_step(model, torch.from_numpy(x[:, :T]),
                                 max_len=T + 4,
                                 cache_dtype=getattr(torch, cache))
    np.testing.assert_allclose(_np(tlast), np.asarray(jlast), **LOGIT_TOL)
    assert len(tst) == tcfg.num_layers
    kinds = tcfg.layer_types
    caches = [c for kind, c in zip(kinds, tst) if kind in ATTN_KINDS]
    assert all(c["pos"] == T and c["k"].shape[1] == T + 4
               and c["k"].dtype == getattr(torch, cache) for c in caches)
    # recurrent states pass through prefill: f32 h/C/n/m
    assert all(st[key].dtype == torch.float32
               for kind, st in zip(kinds, tst) if kind not in ATTN_KINDS
               for key in st if key != "conv")
    tol = BF16_DECODE_TOL if cache == "bfloat16" else LOGIT_TOL
    for t in (T, T):  # two steps: the second reads the first's cache row
        jgot, jst = J["decode_step"](params, jcfg, jnp.asarray(x[:, t]), jst)
        tgot, tst = TM.decode_step(model, torch.from_numpy(x[:, t]), tst)
        np.testing.assert_allclose(_np(tgot), np.asarray(jgot), **tol)
    assert all(c["pos"] == T + 2
               for kind, c in zip(kinds, tst) if kind in ATTN_KINDS)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_decode_matches_forward(arch):
    """Prefill on T tokens plus one decode step equals the forward pass at
    position T+1 (f32 cache), as the reference's test of the same name
    (MoE at its no-drop capacity factor 64: a 17-token forward and a
    one-token decode group their tokens differently, so a capacity that
    drops differs between the two)."""
    _, _, tcfg, model = _pair(arch)
    if tcfg.is_moe:
        model.cfg = tcfg.replace(capacity_factor=64.0)
    x = torch.from_numpy(_inputs(tcfg, 2, 17, seed=4))
    try:
        full, _, _ = TM.forward(model, x)
        _, state = TM.prefill_step(model, x[:, :16], max_len=18,
                                   cache_dtype=torch.float32)
        got, _ = TM.decode_step(model, x[:, 16], state)
    finally:
        model.cfg = tcfg
    np.testing.assert_allclose(_np(got), _np(full[:, -1]), rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_greedy_generate_matches_reference(arch):
    jcfg, params, tcfg, model = _pair(arch)
    x = _inputs(jcfg, 2, 9, seed=5)
    a = J["greedy_generate"](params, jcfg, jnp.asarray(x), 7)
    b = TM.greedy_generate(model, torch.from_numpy(x), 7)
    assert b.dtype == torch.int32 and tuple(b.shape) == (2, 7)
    np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_window_layers_match_reference_past_the_window():
    """starcoder2's smoke window is 8: a 30-token prompt and three decode
    steps reach keys the window drops, on both the flash and einsum
    paths."""
    jcfg, params, tcfg, model = _pair("starcoder2-7b")
    assert tcfg.sliding_window == 8
    x = _inputs(jcfg, 1, 33, seed=6)
    for impl in ("flash_kernel", "xla"):
        model.cfg = tcfg.replace(attn_impl=impl)
        jl, jst = J["prefill_step"](params, jcfg.replace(attn_impl=impl),
                                 jnp.asarray(x[:, :30]), max_len=33,
                                 cache_dtype=jnp.float32)
        tl, tst = TM.prefill_step(model, torch.from_numpy(x[:, :30]),
                                  max_len=33, cache_dtype=torch.float32)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
        for t in (30, 31, 32):
            jg, jst = J["decode_step"](params, jcfg, jnp.asarray(x[:, t]), jst)
            tg, tst = TM.decode_step(model, torch.from_numpy(x[:, t]), tst)
            np.testing.assert_allclose(_np(tg), np.asarray(jg), **LOGIT_TOL)
    model.cfg = tcfg


def test_init_from_generator_is_seeded():
    """Transformer(cfg, gen) draws every weight from the generator: the
    same seed gives the same weights, another seed others; shapes and
    names are the converted reference tree's."""
    _, _, tcfg, model = _pair("qwen3-14b")
    a = TM.Transformer(tcfg, torch.Generator().manual_seed(3), device="cpu")
    b = TM.Transformer(tcfg, torch.Generator().manual_seed(3), device="cpu")
    c = TM.Transformer(tcfg, torch.Generator().manual_seed(4), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert {k: v.shape for k, v in sa.items()} == \
        {k: v.shape for k, v in model.state_dict().items()}
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.attn.wq"], sc["layers.0.attn.wq"])
    assert not any(p.requires_grad for p in a.parameters())
    bf = TM.Transformer(tcfg, torch.Generator().manual_seed(3),
                        device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    d = TM.Transformer(tcfg, device="cpu")
    e = TM.Transformer(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(v, e.state_dict()[k])
               for k, v in d.state_dict().items())


def test_entry_points_default_to_cuda(monkeypatch):
    """The model, its decode state and a KV cache are made on "cuda"
    unless the caller passes device="cpu": without a card they raise
    rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tcfg, _ = _pair("qwen3-14b")
    for make in (lambda: TM.Transformer(tcfg),
                 lambda: TM.init_decode_state(tcfg, 1, 8),
                 lambda: TL.init_kv_cache(tcfg, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    state = TM.init_decode_state(tcfg, 1, 8, device="cpu")
    assert state[0]["k"].device.type == "cpu"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree(arch):
    """The port's own init (from a torch.Generator) has the converted
    reference tree's names, shapes and constant inits (norm scales, the
    mLSTM's forget bias 1, the RG-LRU's lambda 1, zero biases), for every
    block kind."""
    _, params, tcfg, model = _pair(arch)
    own = TM.Transformer(tcfg, torch.Generator().manual_seed(1),
                         device="cpu").state_dict()
    ref = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for name, v in ref.items():
        if bool((v == v.flatten()[0]).all()) and v.numel() > 1:
            assert torch.equal(own[name], v), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_matches_reference(arch):
    """init_decode_state builds each kind's state as the reference does:
    KV caches in the cache dtype, recurrent h/C/n/m in f32 (m at -1e30)
    and the conv state in the cache dtype; then one decode step from it
    matches the reference's."""
    jcfg, params, tcfg, model = _pair(arch, scan_layers=False)
    tst = TM.init_decode_state(tcfg, 2, 6, device="cpu")
    jst = M.init_decode_state(jcfg, 2, 6)
    assert len(tst) == len(jst["layers"]) + len(jst["rem"])
    for t, j in zip(tst, jst["layers"] + jst["rem"]):
        assert set(t) == set(j)
        for key in j:
            if key == "pos":
                assert t[key] == int(j[key])
                continue
            assert str(t[key].dtype).split(".")[-1] == str(j[key].dtype)
            np.testing.assert_array_equal(t[key].float().numpy(),
                                          np.asarray(j[key], np.float32))
    x = _inputs(jcfg, 2, 1, seed=8)[:, 0]
    jgot, _ = J["decode_step"](params, jcfg, jnp.asarray(x), jst)
    tgot, _ = TM.decode_step(model, torch.from_numpy(x), tst)
    np.testing.assert_allclose(_np(tgot), np.asarray(jgot),
                               **BF16_DECODE_TOL)
