"""The dry-run: `launch/specs.py`'s templates against the reference's in
every (arch × shape) cell, and a smoke cell run on a fake 16 × 16 world
whose JSON the report renders.

Templates: every leaf's shape and dtype equals the reference's
`ShapeDtypeStruct` (the reference's scanned configs stack a pattern
group on a leading axis; the port's per-layer leaves are compared with
each stacked entry). The decode state's position is a host int in the
port (`models.layers.attention_decode`), an int32 scalar in the
reference; it is compared as a value (0).

The cell: its argument bytes equal the sum of rank 0's shard bytes
(parameters, both moments, the two steps) and its rows of the batch, as
`param_spec` resolves them; its counts are rank 0's own. With experts
that divide the model axis, rank 0's counts fall by it (16) against the
same cell run with the "seq" rule and the tensor-parallel names
replicated (a rules table local to the test; with "seq" alone replicated
the step would take the tensor-parallel arm): the sequence split over
"model" shares every layer's work out, the experts too; so does a decode
cell's split of heads, widths, vocabulary, experts and cache positions
over "model", and a recurrent decode cell's split of its blocks'
channels.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as J_SHAPES
from repro.launch import specs as JSP
from repro_torch import configs as tcfgs
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.launch import report
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import RankLayout
from repro_torch.train import step as TS

#: the least factor by which a recurrent decode cell's rank-0 FLOPs fall
#: (xlstm-350m, 16 ranks along "model"; the recurrences' ~2 M MACs a
#: layer repeat on every rank)
RECURRENT_DECODE_CUT = 4.0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree


def _sd(x):
    return tuple(x.shape), np.dtype(x.dtype).name


def _tsd(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _ref_layers(cfg, groups_key, tree):
    """{port name: (shape, dtype)} of a reference per-layer tree (params
    dict, or the decode state's "groups"/"layers"/"rem" lists)."""
    pat = cfg.block_pattern
    n_body = (cfg.num_layers // len(pat)) * len(pat)
    out = {}
    for key, leaf in _flat(tree):
        parts = key.split(".")
        if parts[0] == groups_key:                 # stacked pattern group
            j = int(parts[1][3:]) if parts[1].startswith("blk") \
                else int(parts[1])
            shape, dt = _sd(leaf)
            for g in range(shape[0]):
                out[f"layers.{g * len(pat) + j}." + ".".join(parts[2:])] = \
                    (shape[1:], dt)
        elif parts[0].startswith("layer") and parts[0] != "layers":
            out[f"layers.{int(parts[0][5:])}." + ".".join(parts[1:])] = \
                _sd(leaf)
        elif parts[0] == "layers":
            out[f"layers.{int(parts[1])}." + ".".join(parts[2:])] = _sd(leaf)
        elif parts[0].startswith("rem"):
            i = int(parts[1]) if parts[0] == "rem" else int(parts[0][3:])
            rest = parts[2:] if parts[0] == "rem" else parts[1:]
            out[f"layers.{n_body + i}." + ".".join(rest)] = _sd(leaf)
        else:
            out[key] = _sd(leaf)
    return out


def _port_state(state):
    out = {}
    for i, st in enumerate(state):
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                out[f"layers.{i}.{k}"] = _tsd(v)
            else:
                assert k == "pos" and v == 0
    return out


@pytest.mark.parametrize("shape", list(J_SHAPES))
@pytest.mark.parametrize("arch", tcfgs.ASSIGNED_ARCHS)
def test_input_specs_match_reference(arch, shape):
    ref = JSP.input_specs(arch, shape)
    got = SP.input_specs(arch, shape)
    assert got["kind"] == ref["kind"]
    if ref["kind"] == "skip":
        assert shape == "long_500k" and got["reason"] == ref["reason"]
        return
    cfg = ref["cfg"]
    assert got["cfg"].attn_impl == cfg.attn_impl
    if ref["kind"] == "train":
        rs, gs = ref["state"], got["state"]
        assert _ref_layers(cfg, "groups", rs.params) == {
            k: _tsd(v) for k, v in gs.params.items()}
        for part in ("m", "v"):
            assert _ref_layers(cfg, "groups", getattr(rs.opt, part)) == {
                k: _tsd(v) for k, v in getattr(gs.opt, part).items()}
        assert _sd(rs.step) == _tsd(gs.step) == _sd(rs.opt.step) \
            == _tsd(gs.opt.step) == ((), "int32")
        rb, gb = ref["batch"], got["batch"]
        if isinstance(rb, dict):
            assert {k: _sd(v) for k, v in rb.items()} == \
                {k: _tsd(v) for k, v in gb.items()}
        else:
            assert _sd(rb) == _tsd(gb)
        return
    assert _ref_layers(cfg, "groups", ref["params"]) == {
        k: _tsd(v) for k, v in got["params"].items()}
    assert _sd(ref["tokens"]) == _tsd(got["tokens"])
    if ref["kind"] == "decode":
        want = {k: v for k, v in _ref_layers(cfg, "groups",
                                             ref["state"]).items()
                if not k.endswith(".pos")}
        assert want == _port_state(got["state"])


def test_every_cell_is_covered_with_the_same_skips():
    skips = [(a, s) for a in tcfgs.ASSIGNED_ARCHS for s in tcfgs.SHAPES
             if SP.input_specs(a, s)["kind"] == "skip"]
    assert len(skips) == 8 and all(s == "long_500k" for _, s in skips)
    assert {"xlstm-350m", "recurrentgemma-9b"}.isdisjoint(
        {a for a, _ in skips})


def test_fake_process_group_is_available():
    """The dry-run runs on PyTorch's private fake process group; this
    pins its presence."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert FakeStore is not None
    assert not dist.is_initialized()
    try:
        D.fake_world(16)
        assert dist.get_backend() == "fake" and dist.get_world_size() == 16
    finally:
        dist.destroy_process_group()


def _smoke_overrides(arch):
    full, small = tcfgs.get_config(arch), tcfgs.smoke(tcfgs.get_config(arch))
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
            if f.name != "name" and getattr(small, f.name)
            != getattr(full, f.name)}


def test_smoke_cell_on_a_fake_pod(tmp_path, monkeypatch, capsys):
    """granite's smoke widths: its 4 experts do not divide the model axis
    (16), so each rank runs every expert on its gathered rows (the
    repeated-experts arm of `moe_fwd`, forward and backward)."""
    arch, shape = "granite-moe-1b-a400m", "train_4k"
    ov = _smoke_overrides(arch)
    assert not dist.is_initialized()
    try:
        res = D.run_cell(arch, shape, "pod", ov, verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert res["status"] == "OK", res.get("traceback")
    assert res["chips"] == 256 and res["cost_source"] == "fake_tensor"
    assert "corrected_costs" in res["scan_correction"]

    cfg = tcfgs.get_config(arch).replace(**ov)
    lay = RankLayout((16, 16), ("data", "model"), 0)
    shapes, _ = TS.model_specs(cfg)
    specs = TS.resolve_param_shardings(cfg, lay, shapes)
    shard = sum(int(np.prod(S.shard_shape(v.shape, specs[k], lay))) * 4
                for k, v in shapes.items())
    sh = tcfgs.SHAPES[shape]
    rows = sh["global_batch"] // 16 * (sh["seq_len"] + 1) * 4
    assert res["memory"]["argument_size_in_bytes"] == 3 * shard + 2 * 4 + rows

    rf = res["roofline"]
    assert rf["flops"] > 0 and rf["hbm_bytes"] > 0
    kinds = rf["collectives"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(kinds)
    assert rf["wire_bytes_per_chip"] == sum(v["wire_bytes"]
                                            for v in kinds.values())

    D.save_result(res, out_dir=str(tmp_path))
    monkeypatch.setattr(report, "OUT_DIRS", (str(tmp_path),))
    report.main()
    text = capsys.readouterr().out
    assert f"| {arch} | {shape} | OK |" in text
    assert "fake_tensor" in text


#: the act rules with every tensor-parallel name replicated
_NO_TP = dict(S.ACT_RULES, **{
    k: [()] for k in ("act_heads", "act_kv_heads", "act_mlp", "act_vocab",
                      "act_experts", "cache_seq")})


def test_seq_split_cuts_rank_flops_by_the_model_axis(monkeypatch):
    """granite's smoke widths with its own 32 experts, top 8 (they divide
    the model axis): rank 0's FLOPs fall by the model axis (16) against
    the same cell with the "seq" rule replicated (a rules table local to
    the test, which replicates the tensor-parallel names as well: with
    "seq" alone replicated the step takes the tensor-parallel arm), the
    experts split over "model" too."""
    arch, shape = "granite-moe-1b-a400m", "train_4k"
    ov = {k: v for k, v in _smoke_overrides(arch).items()
          if k not in ("num_experts", "top_k")}
    assert not dist.is_initialized()
    no_seq = dict(_NO_TP, seq=[()])
    try:
        res = D.run_cell(arch, shape, "pod", ov, verbose=False)
        with monkeypatch.context() as m:
            m.setattr(S, "rules_for_profile", lambda profile: no_seq)
            whole = D.run_cell(arch, shape, "pod", ov, verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert res["status"] == "OK", res.get("traceback")
    assert whole["status"] == "OK", whole.get("traceback")
    np.testing.assert_allclose(whole["roofline"]["flops"]
                               / res["roofline"]["flops"], 16, rtol=0.1)


def test_decode_split_cuts_rank_flops_by_the_model_axis(monkeypatch):
    """granite's `decode_32k` cell at smoke widths with 16 heads, 16 kv
    heads and its own 32 experts, top 8 (with d_ff 128 and the padded
    vocab 256, all divide the model axis): rank 0's FLOPs fall by at
    least 12 of the axis's 16 against the same cell with "act_heads",
    "act_kv_heads", "act_mlp", "act_vocab", "act_experts" and
    "cache_seq" replicated (a rules table local to the test, under which
    every rank along model repeats the step on its rows)."""
    arch, shape = "granite-moe-1b-a400m", "decode_32k"
    ov = {k: v for k, v in _smoke_overrides(arch).items()
          if k not in ("num_experts", "top_k")}
    ov.update(num_heads=16, num_kv_heads=16)
    assert not dist.is_initialized()
    try:
        res = D.run_cell(arch, shape, "pod", ov, verbose=False)
        with monkeypatch.context() as m:
            m.setattr(S, "rules_for_profile", lambda profile: _NO_TP)
            whole = D.run_cell(arch, shape, "pod", ov, verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert res["status"] == "OK", res.get("traceback")
    assert whole["status"] == "OK", whole.get("traceback")
    ratio = whole["roofline"]["flops"] / res["roofline"]["flops"]
    assert 12 <= ratio <= 16, ratio


def test_recurrent_decode_split_cuts_rank_flops(monkeypatch):
    """xlstm-350m's `decode_32k` cell at full size: its mLSTM and sLSTM
    blocks run on their own channels over "model" (their 4 heads do not
    divide 16, so every rank runs every head on the mLSTM's summed row
    blocks and the sLSTM's gathered projection): rank 0's FLOPs fall by
    at least RECURRENT_DECODE_CUT against the same cell with the
    tensor-parallel names replicated, under which every rank runs every
    block whole."""
    arch, shape = "xlstm-350m", "decode_32k"
    assert not dist.is_initialized()
    try:
        res = D.run_cell(arch, shape, "pod", None, verbose=False)
        with monkeypatch.context() as m:
            m.setattr(S, "rules_for_profile", lambda profile: _NO_TP)
            whole = D.run_cell(arch, shape, "pod", None, verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert res["status"] == "OK", res.get("traceback")
    assert whole["status"] == "OK", whole.get("traceback")
    ratio = whole["roofline"]["flops"] / res["roofline"]["flops"]
    assert ratio >= RECURRENT_DECODE_CUT, ratio


def test_cli_writes_a_skip_record(tmp_path, monkeypatch):
    """`--set` values parse as JSON where they can (the reference's
    CLI); a skipped cell writes a SKIP record and exits 0."""
    monkeypatch.setattr(D, "OUT_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "qwen3-14b", "--shape", "long_500k", "--set",
                "remat=\"dots\""])
    assert e.value.code == 0
    rec = (tmp_path / "qwen3-14b__long_500k__pod.json").read_text()
    assert '"SKIP"' in rec and '"remat": "dots"' in rec
    assert not dist.is_initialized()
