"""The sharding rules: the port's `param_spec` of every parameter of every
assigned config at full size against the reference's
`train_state_specs(cfg)` resolved on a FakeMesh-style stand-in (the
reference's tests/test_substrate.py), the reference's direct rule cases,
rank layouts, and shards and gathers on a world of one.

The reference's scanned configs stack a pattern group's blocks on a
leading "layers" axis, which never shards; the port's layers are
separate modules, so each reference spec loses that entry. Specs are
compared exactly.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.distributed import sharding as JS
from repro.train import step as JTS
from repro_torch import configs as tcfgs
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import RankLayout
from repro_torch.models.transformer import param_logical_axes
from repro_torch.train import step as TS

LAYOUTS = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
           (2, 2): ("data", "model"), (1, 4): ("data", "model"),
           (4, 1): ("data", "model")}


def _fake_mesh(shape, axes):
    class FakeMesh:
        axis_names = axes
        devices = np.empty(shape, object)
    return FakeMesh()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """{port name: (reference axes, reference shape, stacked)} of the
    reference's full-size `train_state_specs(cfg).params`."""
    cfg = jcfgs.get_config(arch)
    shapes, _ = JTS._model_specs(cfg)
    specs = JTS.train_state_specs(cfg).params
    pat = cfg.block_pattern
    n_body = (cfg.num_layers // len(pat)) * len(pat)
    flat_shapes = dict(_flat(shapes))
    out = {}
    for key, axes in _flat(specs):
        shape = tuple(flat_shapes[key].shape)
        head, _, rest = key.partition(".")
        if head == "groups":
            blk, _, name = rest.partition(".")
            j = int(blk[len("blk"):])
            for g in range(shape[0]):
                out[f"layers.{g * len(pat) + j}.{name}"] = (axes, shape, True)
        elif head.startswith("layer") and rest:
            out[f"layers.{int(head[len('layer'):])}.{rest}"] = (axes, shape,
                                                               False)
        elif head.startswith("rem") and rest:
            out[f"layers.{n_body + int(head[len('rem'):])}.{rest}"] = (
                axes, shape, False)
        else:
            out[key] = (axes, shape, False)
    return out


@pytest.mark.parametrize("shape", list(LAYOUTS), ids=str)
@pytest.mark.parametrize("arch", tcfgs.ASSIGNED_ARCHS)
def test_param_specs_match_reference(arch, shape):
    axes_names = LAYOUTS[shape]
    ref = _reference(arch)
    mesh = _fake_mesh(shape, axes_names)
    lay = RankLayout(shape, axes_names)
    cfg = tcfgs.get_config(arch)
    shapes, logical = TS.model_specs(cfg)
    assert set(shapes) == set(ref)
    got = TS.resolve_param_shardings(cfg, lay, shapes)
    for k, (axes, ref_shape, stacked) in ref.items():
        want = tuple(JS.param_spec(axes, ref_shape, mesh))
        want = want + (None,) * (len(ref_shape) - len(want))
        if stacked:
            assert want[0] is None, (k, want)   # "layers" never shards
            want = want[1:]
        assert got[k] == want, (k, got[k], want)
        assert tuple(shapes[k].shape) == (ref_shape[1:] if stacked
                                          else ref_shape), k
        assert logical[k] == (axes[1:] if stacked else axes), k


def test_train_state_specs_follow_the_parameters():
    cfg = tcfgs.smoke(tcfgs.get_config("granite-moe-1b-a400m"))
    spec = TS.train_state_specs(cfg)
    assert spec.params == spec.opt.m == spec.opt.v
    assert spec.step == () and spec.opt.step == ()
    assert list(spec.params) == [k for k, _ in TS.model_specs(cfg)[0].items()]
    assert spec.params == param_logical_axes(cfg)


# ---------------------------------------------------------------------------
# the reference's direct cases (tests/test_substrate.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["fake", "layout"])
def test_divisibility_fallback(mesh):
    m = (_fake_mesh((2, 2), ("data", "model")) if mesh == "fake"
         else RankLayout((2, 2), ("data", "model")))
    # divisible -> sharded
    assert S.param_spec(("vocab", "embed"), (100, 64), m) == ("model", "data")
    # odd vocab -> falls back to replicated on that dim
    assert S.param_spec(("vocab", "embed"), (49155, 64), m) == (None, "data")
    # same mesh axis never used twice in one spec
    assert S.act_spec(("seq", "act_heads"), (16, 16), m).count("model") <= 1


@pytest.mark.parametrize("mesh", ["fake", "layout"])
def test_batch_rule_prefers_pod_data(mesh):
    m = (_fake_mesh((2, 2, 2), ("pod", "data", "model")) if mesh == "fake"
         else RankLayout((2, 2, 2), ("pod", "data", "model")))
    assert S.act_spec(("batch", None), (8, 3), m)[0] == ("pod", "data")
    # batch=1 (long_500k) falls back to replicated
    assert S.act_spec(("batch", None), (1, 3), m)[0] is None


def test_dp_profile_spans_every_axis():
    lay = RankLayout((2, 4), ("data", "model"))
    dp = S.rules_for_profile("dp")
    assert S.batch_axes_for((16, 5), lay, dp) == ("data", "model")
    assert S.batch_axes_for((16, 5), lay, S.ACT_RULES) == ("data",)
    assert S.batch_axes_for((2, 5), lay, dp) == ("data",)
    assert S.spec_for(("batch", "seq"), (16, 64), lay, dp)[1] is None


def test_acts_resolve_like_the_reference():
    lay = RankLayout((2, 2, 2), ("pod", "data", "model"))
    mesh = _fake_mesh((2, 2, 2), ("pod", "data", "model"))
    for prof in ("default", "dp"):
        for axes, shape in ((("batch", "seq", "act_embed"), (8, 64, 32)),
                            (("batch", "seq", "act_vocab"), (4, 6, 50)),
                            (("batch", "cache_seq", "act_kv_heads", None),
                             (2, 64, 8, 16))):
            want = JS.spec_for(axes, shape, mesh,
                               JS.rules_for_profile(prof))
            got = S.spec_for(axes, shape, lay, S.rules_for_profile(prof))
            assert got == tuple(want) + (None,) * (len(got) - len(want))


def test_logical_constraint_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    lay = RankLayout((2, 2), ("data", "model"))
    with S.mesh_rules(lay):
        assert S.logical_constraint(x, "batch", None) is x
    assert S.logical_constraint(x, "batch", None) is x


def test_tree_param_specs():
    lay = RankLayout((2, 2), ("data", "model"))
    got = S.tree_param_specs({"a": ("vocab", "embed"), "b": (None,)},
                             {"a": (100, 64), "b": torch.zeros(3)}, lay)
    assert got == {"a": ("model", "data"), "b": (None,)}


# ---------------------------------------------------------------------------
# layouts, shards and gathers
# ---------------------------------------------------------------------------

def test_layout_coordinates_and_rows():
    lay = RankLayout((2, 2, 2), ("pod", "data", "model"), 5)
    assert lay.coords() == (1, 0, 1)
    assert lay.axis_index("data") == 0 and lay.axis_index("model") == 1
    assert lay.axis_index(("pod", "data")) == 2
    assert lay.group_ranks(("pod", "data")) == [1, 3, 5, 7]
    assert lay.group_ranks("model") == [4, 5]
    assert lay.axis_size(("data", "model")) == 4
    with pytest.raises(ValueError, match="order"):
        lay.axis_index(("model", "data"))


def test_shard_tensor_blocks_tile_the_whole():
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    spec = (("pod", "data"), "model")
    blocks = {}
    for r in range(8):
        lay = RankLayout((2, 2, 2), ("pod", "data", "model"), r)
        blocks[(lay.axis_index(("pod", "data")), lay.axis_index("model"))] = \
            S.shard_tensor(full, spec, lay)
    rows = [torch.cat([blocks[(i, j)] for j in range(2)], dim=1)
            for i in range(4)]
    assert torch.equal(torch.cat(rows, dim=0), full)
    assert S.shard_shape((8, 6), spec, lay) == (2, 3)


def test_gather_on_one_rank_is_the_identity_both_ways():
    lay = RankLayout((1, 1), ("data", "model"), 0, torch.device("cpu"))
    p = torch.randn(4, 3, requires_grad=True)
    full = S.gather_param(p, ("data", "model"), lay, ("data",))
    assert torch.equal(full, p.detach())
    (full * 3).sum().backward()
    assert torch.equal(p.grad, torch.full((4, 3), 3.0))


def test_shards_count_each_element_once():
    """A shard replicated along an axis its spec does not use counts on
    that axis's index 0 only."""
    specs = {"w": ("data", None), "b": (None,), "e": ("model", "data")}
    counted = {r: {k: S.counts_once(v, RankLayout((2, 2), ("data", "model"),
                                                   r))
                   for k, v in specs.items()} for r in range(4)}
    assert [counted[r]["w"] for r in range(4)] == [True, False, True, False]
    assert [counted[r]["b"] for r in range(4)] == [True, False, False, False]
    assert all(counted[r]["e"] for r in range(4))
