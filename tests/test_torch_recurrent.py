"""The recurrent blocks: the port's `models/recurrent.py` against the
reference's, module by module.

Each block's parameters come from the reference's own `init_*` (f32) and
cross to the port by name (`load_state_dict(strict=True)`); both packages
then run the same numpy inputs at the smoke configs' widths (xlstm-350m:
d 64, 4 heads, mLSTM inner 128; recurrentgemma-9b: d 64, RG-LRU width 64).

Tolerance: 1e-5 relative to the largest value of the reference's output
(rtol 1e-5 elementwise plus atol 1e-5 * max|ref|), in f32 on both sides.
The two sum in other orders (the RG-LRU's doubling scan against
`associative_scan`'s tree, torch's matmuls against XLA's dots), which
moves an f32 value by a few units in the last place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.models import recurrent as TR


def _j(fn):
    """A reference block function jitted with its config static (eager JAX
    compiles each op on its own)."""
    return jax.jit(fn, static_argnums=(1,))


def _cfg(arch):
    return jcfgs.smoke(jcfgs.get_config(arch)), \
        tcfgs.smoke(tcfgs.get_config(arch))


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def _pair(init, module, jcfg, tcfg, name, seed=0):
    """(reference params of `name`, the port's module with them)."""
    pb = JL.ParamBuilder(jax.random.PRNGKey(seed))
    init(pb, jcfg, name)
    tree = jax.tree.map(np.asarray, pb.params[name])
    mod = module(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in convert._flatten(tree)}
    mod.load_state_dict(sd, strict=True)
    return pb.params[name], mod


def _x(B, T, D, seed):
    return np.random.default_rng(seed).normal(size=(B, T, D)).astype(
        np.float32)


def _states_close(tst, jst):
    assert set(tst) == set(jst)
    for key in jst:
        if jst[key] is None:
            assert tst[key] is None
        else:
            assert tst[key].dtype == torch.from_numpy(
                np.array(jst[key])).dtype, key
            _close(tst[key], jst[key])


# ---------------------------------------------------------------------------
# conv1d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_reference(width, with_state):
    pb = JL.ParamBuilder(jax.random.PRNGKey(1))
    JR.init_conv1d(pb, "conv", width, 24)
    p = pb.params["conv"]
    p = dict(p, b=jnp.asarray(np.random.default_rng(2).normal(size=24),
                              jnp.float32))   # a bias that is not zero
    mod = TR.Conv1d(width, 24, torch.Generator(), device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()}, strict=True)
    x = _x(2, 9, 24, seed=3)
    state = (_x(2, width - 1, 24, seed=4) if with_state and width > 1
             else None)
    if with_state and width == 1:
        state = np.zeros((2, 0, 24), np.float32)
    jy, jst = JR.conv1d_fwd(p, jnp.asarray(x),
                            None if state is None else jnp.asarray(state))
    ty, tst = TR.conv1d_fwd(mod, torch.from_numpy(x),
                            None if state is None else
                            torch.from_numpy(state))
    _close(ty, jy)
    if jst is None:
        assert tst is None
    else:
        _close(tst, jst)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 7, 300])
def test_mlstm_fwd_matches_reference(T):
    """T = 300 runs chunks of 150 (the chunk shrinks to a divisor of T)."""
    jcfg, tcfg = _cfg("xlstm-350m")
    jp, mod = _pair(JR.init_mlstm, TR.MLSTM, jcfg, tcfg, "mlstm")
    x = _x(2, T, jcfg.d_model, seed=T)
    jy, jst = _j(JR.mlstm_fwd)(jp, jcfg, jnp.asarray(x))
    ty, tst = TR.mlstm_fwd(mod, tcfg, torch.from_numpy(x))
    _close(ty, jy)
    _states_close(tst, jst)


def test_mlstm_small_chunks_match_one_chunk():
    """Chunks of 4 over T = 12 give the one-chunk answer (the cross-chunk
    state carries the rest)."""
    _, tcfg = _cfg("xlstm-350m")
    mod = TR.MLSTM(tcfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(_x(2, 12, tcfg.d_model, seed=5))
    a, sa = TR.mlstm_fwd(mod, tcfg, x, chunk=4)
    b, sb = TR.mlstm_fwd(mod, tcfg, x, chunk=12)
    _close(a, b.numpy())
    for key in ("C", "n", "m"):
        _close(sa[key], sb[key].numpy())


def test_mlstm_decode_after_prefill_matches_reference():
    jcfg, tcfg = _cfg("xlstm-350m")
    jp, mod = _pair(JR.init_mlstm, TR.MLSTM, jcfg, tcfg, "mlstm", seed=1)
    x = _x(2, 11, jcfg.d_model, seed=6)
    _, jst = _j(JR.mlstm_fwd)(jp, jcfg, jnp.asarray(x[:, :8]))
    _, tst = TR.mlstm_fwd(mod, tcfg, torch.from_numpy(x[:, :8]))
    for t in range(8, 11):
        jy, jst = _j(JR.mlstm_decode)(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = TR.mlstm_decode(mod, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                  tst)
        _close(ty, jy)
        _states_close(tst, jst)
    # and from the empty state, as init_decode_state gives it
    j0 = JR.mlstm_init_state(jcfg, 2)
    t0 = TR.mlstm_init_state(tcfg, 2)
    _states_close(t0, j0)
    jy, _ = _j(JR.mlstm_decode)(jp, jcfg, jnp.asarray(x[:, :1]), j0)
    ty, _ = TR.mlstm_decode(mod, tcfg, torch.from_numpy(x[:, :1]), t0)
    _close(ty, jy)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 9])
def test_slstm_matches_reference(T):
    jcfg, tcfg = _cfg("xlstm-350m")
    jp, mod = _pair(JR.init_slstm, TR.SLSTM, jcfg, tcfg, "slstm")
    x = _x(2, T, jcfg.d_model, seed=10 + T)
    jy, jst = _j(JR.slstm_fwd)(jp, jcfg, jnp.asarray(x))
    ty, tst = TR.slstm_fwd(mod, tcfg, torch.from_numpy(x))
    _close(ty, jy)
    _states_close(tst, jst)
    xd = _x(2, 2, jcfg.d_model, seed=20 + T)
    for t in range(2):
        jy, jst = _j(JR.slstm_decode)(jp, jcfg, jnp.asarray(xd[:, t:t + 1]), jst)
        ty, tst = TR.slstm_decode(mod, tcfg, torch.from_numpy(xd[:, t:t + 1]),
                                  tst)
        _close(ty, jy)
        _states_close(tst, jst)
    _states_close(TR.slstm_init_state(tcfg, 3), JR.slstm_init_state(jcfg, 3))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 7, 64])
def test_rglru_fwd_matches_reference(T):
    jcfg, tcfg = _cfg("recurrentgemma-9b")
    jp, mod = _pair(JR.init_rglru, TR.RGLRU, jcfg, tcfg, "rglru")
    x = _x(2, T, jcfg.d_model, seed=30 + T)
    jy, jst = _j(JR.rglru_fwd)(jp, jcfg, jnp.asarray(x))
    ty, tst = TR.rglru_fwd(mod, tcfg, torch.from_numpy(x))
    _close(ty, jy)
    _states_close(tst, jst)


def test_rglru_decode_matches_reference():
    jcfg, tcfg = _cfg("recurrentgemma-9b")
    jp, mod = _pair(JR.init_rglru, TR.RGLRU, jcfg, tcfg, "rglru", seed=2)
    x = _x(2, 10, jcfg.d_model, seed=40)
    _, jst = _j(JR.rglru_fwd)(jp, jcfg, jnp.asarray(x[:, :7]))
    _, tst = TR.rglru_fwd(mod, tcfg, torch.from_numpy(x[:, :7]))
    for t in range(7, 10):
        jy, jst = _j(JR.rglru_decode)(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = TR.rglru_decode(mod, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                  tst)
        _close(ty, jy)
        _states_close(tst, jst)
    _states_close(TR.rglru_init_state(tcfg, 2), JR.rglru_init_state(jcfg, 2))


@pytest.mark.parametrize("T", [1, 2, 5, 64, 100])
def test_linear_scan_matches_the_recurrence(T):
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step
    (f64, so only the order of the products can differ)."""
    rng = np.random.default_rng(T)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, T, 3)))
    b = torch.from_numpy(rng.normal(size=(2, T, 3)))
    h = torch.zeros(2, 3, dtype=torch.float64)
    want = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(TR.linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-12,
                               atol=1e-12)
