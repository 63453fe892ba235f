"""Multi-pod dry-run: run rank 0's sharded step of every (architecture ×
input shape × layout) cell on fake tensors, measure what it does, and
emit the roofline terms as JSON under experiments/dryrun_torch/.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch granite-moe-1b-a400m --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference (`repro/launch/dryrun.py`) lowers and compiles each cell
with XLA against 512 placeholder devices and reads XLA's cost and memory
analyses. The port cannot lower to XLA. Instead this process joins a
`fake` process group of 256 or 512 ranks as rank 0
(`torch.testing._internal.distributed.fake_pg.FakeStore`: collectives
return at once and move nothing) and runs the very step a rank runs
(`train.step.build_train_step` / `build_prefill_step` /
`build_serve_step`) under `FakeTensorMode`, which allocates nothing and
needs no card. Measured for rank 0:

  flops       `torch.utils.flop_counter.FlopCounterMode` over the step;
  hbm_bytes   the bytes every aten op reads and writes (operands plus
              outputs, views free): XLA's "bytes accessed" convention on
              unfused ops, so an upper bound of the card's HBM traffic;
  arguments   exactly, from this rank's shards of the state (parameters,
              moments, steps) and its rows of the batch or decode state;
  temp        the peak bytes of live storages over the step
              (`_PeakBytes`, MemTracker's technique) less the arguments;
  wire bytes  the `Comm` tallies of every group the step used, under the
              roofline's ring conventions (`roofline.wire_bytes`).

The roofline uses `launch/roofline.py`'s H100 rates. The port unrolls its
layers in Python, so every layer is counted as it runs: the reference's
scan trip-count correction (`corrected_costs`) has no counterpart. The
flops are rank 0's own. Train and prefill cells whose sequence divides
the model axis split it there (`sharding.TokenSplit`): rank 0 runs the
first block of positions, k/v gathered per attention layer, its own
experts of each MoE layer, and each recurrent block on its own channels
of the gathered sequence; its einsum attention scores its block against
every key. Decode cells, and train or prefill cells whose sequence the
axis does not divide (the tensor-parallel arm), split the work over
"model" as the reference's act rules do (`sharding.decode_axes`): each
rank its share of the heads, kv heads, MLP width, vocabulary, experts and
recurrent channels (RG-LRU width, mLSTM inner width and heads, sLSTM
heads) where they divide the axis, and in a decode cell its block of the
caches along "cache_seq" (rank 0 scores every head against the first
max_len / 16 positions); the MoE layers gather their rows' tokens into
the global batch's one group. What still repeats along "model"
(`flops_note`): the MoE layers' routing bookkeeping, experts that do not
divide the axis, the recurrences of heads that do not (xlstm-350m's 4
over 16: ~2 M MACs a layer a token), and in a decode cell the
projections of attention heads that do not (qwen3-14b's 40 heads and 8
kv heads over 16). `useful_compute_ratio` shows what repeats.

`torch.testing._internal` is a private module of PyTorch; this is the
only module of the port that imports it, and only when a cell runs.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from .. import models as M
from ..configs import ASSIGNED_ARCHS, SHAPES, get_config, model_flops
from ..train import step as TS
from . import roofline as RL
from . import specs as SP
from .mesh import make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

SCAN_NOTE = ("none: the port unrolls its layers, so each layer's cost is "
             "counted as it runs (the reference's corrected_costs has no "
             "counterpart)")
FLOPS_NOTE = ("rank 0's own FLOPs; train and prefill cells whose sequence "
              "divides the model axis split it there (rank 0 the first "
              "block, k/v gathered per attention layer, its own experts, "
              "the recurrent blocks on their own channels of the gathered "
              "sequence); decode cells, and train and prefill cells whose "
              "sequence does not divide, split heads, kv heads, MLP width, "
              "vocab, experts, recurrent channels and (decode) the "
              "cache's positions over model where each divides; MoE "
              "experts, attention heads and recurrent heads that do not "
              "divide the axis repeat")


def _cell_model_flops(cfg, shape_name: str) -> float:
    """6·N·D already includes fwd+bwd (train); inference is the 2·N·D
    forward share."""
    sh = SHAPES[shape_name]
    if sh["kind"] == "train":
        return model_flops(cfg, sh["global_batch"] * sh["seq_len"])
    if sh["kind"] == "prefill":
        return model_flops(cfg, sh["global_batch"] * sh["seq_len"]) / 3.0
    return model_flops(cfg, sh["global_batch"]) / 3.0  # decode: 1 tok/seq


def fake_world(world: int):
    """Make this process rank 0 of a `fake` process group of `world`
    ranks (replacing a group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _nbytes(x) -> int:
    """Bytes of the tensors in a tree (dicts, sequences, modules)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, torch.nn.Module):
        return _nbytes(list(x.parameters()))
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class _BytesAccessed(TorchDispatchMode):
    """Sums every aten op's operand and output bytes (views and the
    collectives, which the Comm tallies count, excluded)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace == "aten":
            self.bytes += _nbytes(list(args)) + _nbytes(
                list((kwargs or {}).values())) + _nbytes(out)
        return out


class _PeakBytes(TorchDispatchMode):
    """The peak of the bytes held by live tensor storages: `live` starts
    at the arguments' bytes, each new storage an op makes adds its bytes
    until the storage is freed (the technique of
    `torch.distributed._tools.mem_tracker.MemTracker`, whose module and
    gradient hooks refuse a block's gathered, non-leaf weights)."""

    def __init__(self, live: int):
        super().__init__()
        self.live = self.peak = int(live)
        self._seen = WeakIdKeyDictionary()

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
        self.peak = max(self.peak, self.live)
        return out


def _fake(template):
    """A fake tensor of a "meta" template's shape and dtype."""
    return torch.zeros(template.shape, dtype=template.dtype)


def _tally(layout) -> dict:
    """{kind: {count, operand_bytes, output_bytes, wire_bytes}} over every
    Comm the layout built."""
    out = {}
    for comm in layout.comms():
        for kind, rec in comm.by_kind.items():
            d = out.setdefault(kind, {"count": 0, "operand_bytes": 0,
                                      "output_bytes": 0})
            for k in d:
                d[k] += rec[k]
    for kind, d in out.items():
        d["wire_bytes"] = RL.wire_bytes(kind, d["operand_bytes"],
                                        d["output_bytes"])
    return out


def _prepare(spec, layout):
    """(step thunk, argument bytes) of one cell, on fake tensors."""
    cfg = spec["cfg"]
    if spec["kind"] == "train":
        step, place = TS.build_train_step(cfg, layout)
        state = TS.init_train_state(cfg, 0, "cpu", layout=layout)
        batch = (_fake(spec["batch"]) if not isinstance(spec["batch"], dict)
                 else {k: _fake(v) for k, v in spec["batch"].items()})
        args = _nbytes(state) + _nbytes(place.batch(batch, "cpu"))
        return (lambda: step(state, batch)), args
    model = M.Transformer(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    if spec["kind"] == "prefill":
        step, place = TS.build_prefill_step(cfg, layout)
        place.params(model)
        tokens = _fake(spec["tokens"])
        args = _nbytes(model) + _nbytes(place.batch(tokens, "cpu"))
        return (lambda: step(model, tokens)), args
    step, place = TS.build_serve_step(cfg, layout)
    place.params(model)
    tokens = _fake(spec["tokens"])
    T = SHAPES[spec["shape"]]["seq_len"]
    whole = [{k: (_fake(v) if isinstance(v, torch.Tensor) else T - 1)
              for k, v in st.items()} for st in spec["state"]]
    state = place.decode_state(whole)   # decode at the cache's last row
    del whole
    args = (_nbytes(model) + _nbytes(state)
            + _nbytes(place.batch(tokens, "cpu")))
    return (lambda: step(model, tokens, state)), args


def run_cell(arch: str, shape: str, mesh_kind: str,
             overrides: dict | None = None, verbose: bool = True) -> dict:
    """One cell on a fake world of 256 ("pod") or 512 ("multipod")
    ranks; the reference's JSON keys, plus `cost_source`, `scan_correction`
    and `flops_note`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    multi = mesh_kind == "multipod"
    fake_world(512 if multi else 256)
    layout = make_production_mesh(multi_pod=multi, require_ranks=True,
                                  device="cpu")
    chips = layout.size
    t0 = time.time()
    result = {"arch": arch, "shape": shape, "mesh": mesh_kind,
              "chips": chips, "overrides": overrides or {},
              "cost_source": "fake_tensor", "scan_correction": SCAN_NOTE,
              "flops_note": FLOPS_NOTE}
    try:
        spec = SP.input_specs(arch, shape, overrides)
        if spec["kind"] == "skip":
            result.update(status="SKIP", reason=spec["reason"])
            return result
        spec["shape"] = shape
        with FakeTensorMode():
            run, args = _prepare(spec, layout)
            t_lower = time.time() - t0
            for comm in layout.comms():
                comm.reset_counts()
            fc, nb = FlopCounterMode(display=False), _BytesAccessed()
            mt = _PeakBytes(args)
            with fc, nb, mt:
                out = run()
            t_run = time.time() - t0 - t_lower
            peak = mt.peak
        mem_d = {"argument_size_in_bytes": float(args),
                 "output_size_in_bytes": float(_nbytes(out)),
                 "temp_size_in_bytes": float(max(peak - args, 0)),
                 "generated_code_size_in_bytes": 0.0}
        colls = _tally(layout)
        rf = RL.Roofline(flops=float(fc.get_total_flops()),
                         hbm_bytes=float(nb.bytes),
                         wire_bytes=float(sum(d["wire_bytes"]
                                              for d in colls.values())),
                         chips=chips,
                         model_flops=_cell_model_flops(spec["cfg"], shape),
                         collectives=colls)
        result.update(status="OK", lower_s=t_lower, compile_s=0.0,
                      run_s=t_run, memory=mem_d, roofline=rf.to_dict())
        if verbose:
            per_dev = (mem_d["argument_size_in_bytes"]
                       + mem_d["temp_size_in_bytes"]) / 1e9
            print(f"[{arch} × {shape} × {mesh_kind}] OK "
                  f"args+temp={per_dev:.2f} GB/rank "
                  f"compute={rf.compute_s*1e3:.2f}ms "
                  f"memory={rf.memory_s*1e3:.2f}ms "
                  f"coll={rf.collective_s*1e3:.2f}ms "
                  f"bottleneck={rf.bottleneck} "
                  f"roofline_frac={rf.roofline_fraction:.3f}", flush=True)
    except Exception as e:  # a failed cell is reported, the sweep goes on
        result.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[{arch} × {shape} × {mesh_kind}] FAIL: {e}", flush=True)
    return result


def save_result(res: dict, tag: str = "", out_dir: str | None = None):
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    name = f"{res['arch']}__{res['shape']}__{res['mesh']}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(res, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (e.g. remat=dots)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    try:
        for arch in archs:
            get_config(arch)
            for shape in shapes:
                for mk in meshes:
                    res = run_cell(arch, shape, mk, overrides or None)
                    save_result(res, args.tag)
                    n_fail += res["status"] == "FAIL"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done; {n_fail} failures", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
