"""The MoE layer: the port's `models/moe.py` against the reference's.

The layer's parameters come from the reference's `init_moe` (f32) and
cross to the port by name; both packages run the same numpy inputs at the
smoke configs' widths (granite-moe: 4 experts, top-2, swiglu; dbrx the
same geometry under another config) through both dispatches, both
`moe_ep_gather` / `moe_ep_combine` settings, a capacity that drops and a
single token.

Tolerance: 1e-5 relative to the largest value of the reference's output
(rtol 1e-5 plus atol 1e-5 * max|ref|), f32 on both sides: the routing,
the capacity drops and the slots are exact, only the matmuls and the
combine sums round in another order. The aux loss to rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.models import moe as TMOE


def _pair(arch, seed=0, **kw):
    jcfg = jcfgs.smoke(jcfgs.get_config(arch)).replace(**kw)
    tcfg = tcfgs.smoke(tcfgs.get_config(arch)).replace(**kw)
    pb = JL.ParamBuilder(jax.random.PRNGKey(seed))
    JM.init_moe(pb, jcfg, "moe")
    mod = TMOE.MoE(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         convert._flatten(jax.tree.map(np.asarray,
                                                       pb.params["moe"]))},
                        strict=True)
    return jcfg, pb.params["moe"], tcfg, mod


def _x(B, T, D, seed):
    return np.random.default_rng(seed).normal(size=(B, T, D)).astype(
        np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _run(jcfg, jp, tcfg, mod, x, **kw):
    jy, jaux = JM.moe_fwd(jp, jcfg, jnp.asarray(x), **kw)
    ty, taux = TMOE.moe_fwd(mod, tcfg, torch.from_numpy(x), **kw)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == x.shape
    _close(ty, jy)
    np.testing.assert_allclose(float(taux["moe_aux"]),
                               float(jaux["moe_aux"]), rtol=1e-5)
    return ty


def _drops(tcfg, mod, x, group_size=2048):
    """How many (token, choice) slots the capacity drops, by the port's
    routing (the reference's arithmetic)."""
    B, T, D = x.shape
    N = B * T
    g = max(1, min(group_size, N))
    while N % g:
        g -= 1
    _, _, idx = TMOE._route(mod, tcfg, torch.from_numpy(x).reshape(-1, g, D))
    cap = max(int(np.ceil(tcfg.top_k * g * tcfg.capacity_factor
                          / tcfg.num_experts)), 1)
    counts = torch.stack([torch.bincount(r.reshape(-1),
                                         minlength=tcfg.num_experts)
                          for r in idx])
    return int(torch.clamp(counts - cap, min=0).sum())


# (moe_impl, moe_ep_gather, moe_ep_combine): the EP arms are the sort
# dispatch's
DISPATCHES = [("sort", False, False), ("sort", True, False),
              ("sort", False, True), ("sort", True, True),
              ("einsum", False, False)]


@pytest.mark.parametrize("impl,ep_gather,ep_combine", DISPATCHES)
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "dbrx-132b"])
def test_moe_matches_reference(arch, impl, ep_gather, ep_combine):
    jcfg, jp, tcfg, mod = _pair(arch, moe_impl=impl, moe_ep_gather=ep_gather,
                                moe_ep_combine=ep_combine)
    _run(jcfg, jp, tcfg, mod, _x(2, 13, jcfg.d_model, seed=1))


@pytest.mark.parametrize("impl,ep_combine", [("sort", False),
                                              ("sort", True),
                                              ("einsum", False)])
def test_moe_capacity_drops_match_reference(impl, ep_combine):
    """capacity_factor 0.5 over groups of 10 (group_size=10): every expert
    takes at most 3 of a group's 20 slots, so slots are dropped, the same
    ones on both sides."""
    jcfg, jp, tcfg, mod = _pair("granite-moe-1b-a400m", seed=3,
                                capacity_factor=0.5, moe_impl=impl,
                                moe_ep_combine=ep_combine)
    x = _x(2, 15, jcfg.d_model, seed=2)
    assert _drops(tcfg, mod, x, group_size=10) > 0
    _run(jcfg, jp, tcfg, mod, x, group_size=10)


def test_moe_single_token_and_gelu_experts():
    """T = 1 (a decode step: one group of B tokens), and experts with the
    plain gelu MLP (no w_gate)."""
    for kw in ({}, {"activation": "gelu"}):
        jcfg, jp, tcfg, mod = _pair("granite-moe-1b-a400m", seed=4, **kw)
        assert hasattr(mod, "w_gate") == (kw == {})
        _run(jcfg, jp, tcfg, mod, _x(3, 1, jcfg.d_model, seed=5))


def test_sort_and_einsum_dispatch_agree_when_dropping():
    """The two dispatches drop the same slots and agree (the oracle)."""
    _, _, tcfg, mod = _pair("granite-moe-1b-a400m", seed=6,
                            capacity_factor=0.5)
    x = torch.from_numpy(_x(2, 16, tcfg.d_model, seed=7))
    a, _ = TMOE.moe_fwd(mod, tcfg, x, group_size=8)
    b, _ = TMOE.moe_fwd(mod, tcfg.replace(moe_impl="einsum"), x,
                        group_size=8)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_route_ties_take_the_lowest_expert():
    """Equal router probabilities pick experts in index order, as
    lax.top_k does."""
    _, _, tcfg, mod = _pair("granite-moe-1b-a400m")
    with torch.no_grad():
        mod.router.zero_()
    _, gates, idx = TMOE._route(mod, tcfg, torch.ones(1, 3, tcfg.d_model))
    assert idx.tolist() == [[[0, 1]] * 3]
    np.testing.assert_allclose(gates.numpy(), 0.5)


@pytest.mark.parametrize("impl", ["sort", "einsum"])
def test_moe_without_aux_gives_the_same_output(impl):
    """aux=False (decode, which discards the aux) skips the load-balancing
    loss and leaves the output's bits as they were."""
    _, _, tcfg, mod = _pair("granite-moe-1b-a400m", seed=8, moe_impl=impl)
    x = torch.from_numpy(_x(2, 5, tcfg.d_model, seed=9))
    a, auxa = TMOE.moe_fwd(mod, tcfg, x)
    b, auxb = TMOE.moe_fwd(mod, tcfg, x, aux=False)
    assert auxb["moe_aux"] is None and auxa["moe_aux"].dtype == torch.float32
    assert torch.equal(a, b)
