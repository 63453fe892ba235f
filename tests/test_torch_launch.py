"""The launchers: roofline terms with the H100's rates, rank layouts, the
analytic graph_job cell against the reference's templates and against
real distributed runs, the report, the training launcher's preemption
and resume, and a reference checkpoint resumed in the port.

The reference's `repro.launch.graph_job` forces 512 host devices when it
is imported (`XLA_FLAGS` at module top), so its `graph_templates` run in
a subprocess with one device. The real runs are P = 2 and P = 4 gloo
ranks on the CPU, spawned here.

Tolerances: the roofline terms within 1e-9 s (1e-6 for ratios), as the
reference's tests; shapes, dtypes and byte counts exactly; the resumed
launcher's final loss and the resumed reference checkpoint's step 3
bitwise against the uninterrupted port run, and the port's step 3
against the reference's as tests/test_torch_train.py holds them (loss
1e-5, grad_norm 1e-4 relative).
"""
import json
import pathlib
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.envutil import subprocess_env as jax_env
from repro.optim import linear_warmup_cosine as j_lr
from repro.train import step as JTS
from repro_torch import configs as tcfgs
from repro_torch import convert, envutil
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed import collectives
from repro_torch.launch import graph_job as G
from repro_torch.launch import report
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (RankLayout, make_host_mesh,
                                     make_production_mesh)
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import step as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# roofline and layouts (the reference's tests, on the H100's rates)
# ---------------------------------------------------------------------------

def test_h100_rates():
    """The data sheet's dense rates of one H100 SXM; NVLink 4 per
    direction is half the sheet's 900 GB/s."""
    assert RL.PEAK_FLOPS == 989e12 and RL.TF32_FLOPS == 494.7e12
    assert RL.F32_FLOPS == 67e12 and RL.HBM_BW == 3.35e12
    assert RL.LINK_BW == 450e9


def test_roofline_terms_and_bottleneck():
    rf = RL.Roofline(flops=RL.PEAK_FLOPS * 0.01, hbm_bytes=RL.HBM_BW * 0.05,
                     wire_bytes=RL.LINK_BW * 0.002, chips=256,
                     model_flops=RL.PEAK_FLOPS * 0.008 * 256, collectives={})
    assert abs(rf.compute_s - 0.01) < 1e-9
    assert abs(rf.memory_s - 0.05) < 1e-9
    assert abs(rf.collective_s - 0.002) < 1e-9
    assert rf.bottleneck == "memory"
    assert abs(rf.useful_compute_ratio - 0.8) < 1e-6
    assert abs(rf.roofline_fraction - 0.16) < 1e-6


def test_roofline_overlap_and_codec_model():
    rf = RL.Roofline(flops=1e12, hbm_bytes=1e11, wire_bytes=1e10, chips=8,
                     model_flops=8e12, collectives={})
    assert rf.wire_codec_ratio == 1.0 and rf.overlap is True
    assert rf.step_s == max(rf.compute_s, rf.memory_s, rf.collective_s)
    rf_ser = RL.Roofline(flops=1e12, hbm_bytes=1e11, wire_bytes=1e10,
                         chips=8, model_flops=8e12, collectives={},
                         overlap=False)
    assert rf_ser.step_s == max(rf.compute_s, rf.memory_s) + rf.collective_s
    assert rf_ser.step_s > rf.step_s
    rf_q8 = RL.Roofline(flops=1e12, hbm_bytes=1e11, wire_bytes=1e10,
                        chips=8, model_flops=8e12, collectives={},
                        wire_codec_ratio=0.3)
    assert rf_q8.collective_s == pytest.approx(rf.collective_s * 0.3)
    d = rf_q8.to_dict()
    assert d["wire_codec_ratio"] == 0.3 and d["overlap"] is True
    assert set(d) == {"flops", "hbm_bytes", "wire_bytes_per_chip", "chips",
                      "model_flops", "compute_s", "memory_s",
                      "collective_s", "wire_codec_ratio", "overlap",
                      "step_s", "bottleneck", "useful_compute_ratio",
                      "roofline_fraction", "collectives"}


def test_exchange_collectives_ring_conventions():
    info = {"per_superstep": 800}
    ag = RL.exchange_collectives(info, "allgather", 4, supersteps=3)
    assert ag == {"all-gather": {"count": 3, "operand_bytes": 600.0,
                                 "output_bytes": 2400.0,
                                 "wire_bytes": 2400.0}}
    ring = RL.exchange_collectives(info, "ring", 4, count=7)
    assert ring["collective-permute"]["wire_bytes"] == 800.0
    assert ring["collective-permute"]["count"] == 7
    assert RL.wire_bytes("all-reduce", 100, 100) == 200


def test_mesh_shapes():
    with pytest.raises(RuntimeError):
        make_production_mesh(require_ranks=True)
    m = make_production_mesh()
    assert m.shape == (16, 16) and m.axis_names == ("data", "model")
    assert m.rank is None and m.size == 256
    mm = make_production_mesh(multi_pod=True)
    assert mm.shape == (2, 16, 16) and mm.size == 512
    assert mm.as_dict() == {"pod": 2, "data": 16, "model": 16}


def test_host_mesh_is_one_rank_on_the_cpu():
    lay = make_host_mesh(4, device="cpu")
    assert lay.shape == (1, 1) and lay.rank == 0 and lay.size == 1
    assert lay.device == torch.device("cpu")
    assert lay.as_dict() == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()
    assert RankLayout((2, 4), ("data", "model")).size == 8


# ---------------------------------------------------------------------------
# graph_job: the reference's templates, real runs' bytes, the report
# ---------------------------------------------------------------------------

_REF_TEMPLATES = r"""
import json, sys
import numpy as np
from repro.launch import graph_job as G
from repro.core.operators import PageRankProgram, SSSPProgram
out = {}
def flat(tree, prefix=""):
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return {prefix: [list(tree.shape), np.dtype(tree.dtype).name]}
    res = {}
    for k, v in tree.items():
        res.update(flat(v, f"{prefix}/{k}"))
    return res
for P in (256, 512):
    for op in ("pagerank", "sssp"):
        prog = PageRankProgram(G.V_SCALE, 20) if op == "pagerank" \
            else SSSPProgram(0)
        t = G.graph_templates(P, op == "sssp", prog)
        out[f"{P}/{op}"] = {"v_pp": t["v_pp"], "L": t["L"], "arrays": flat(
            {k: t[k] for k in ("vprops", "active", "inbox", "has_msg",
                               "edges")})}
print(json.dumps(out))
"""


def _flat_specs(tree, prefix=""):
    if isinstance(tree, G.Spec):
        return {prefix: [list(tree.shape), tree.dtype]}
    out = {}
    for k, v in tree.items():
        out.update(_flat_specs(v, f"{prefix}/{k}"))
    return out


def test_graph_templates_match_reference():
    env = jax_env(XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, "-c", _REF_TEMPLATES], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    for P in (256, 512):
        for op in ("pagerank", "sssp"):
            t = G.graph_templates(P, op == "sssp", G.program_for(op))
            want = ref[f"{P}/{op}"]
            assert (t["v_pp"], t["L"]) == (want["v_pp"], want["L"])
            got = _flat_specs({k: t[k] for k in ("vprops", "active",
                                                 "inbox", "has_msg",
                                                 "edges")})
            assert got == want["arrays"], (P, op)


_RANK = r"""
import json, sys, warnings
from repro_torch.core import io, operators as ops
from repro_torch.core.engines.common import NonConvergenceWarning
from repro_torch.distributed.collectives import end_rank, init_rank
from repro_torch.launch import roofline as RL
warnings.simplefilter("ignore", NonConvergenceWarning)
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
init_rank(rank, world, port, "gloo")
g = io.uniform_graph(203, 1500, seed=4, weighted=True)
res = {"V": g.num_vertices}
for sch in ("ring", "allgather", "push"):
    kw = dict(engine="distributed", schedule=sch, device="cpu")
    for op, fn in (("pagerank", lambda: ops.pagerank(g, 3, **kw)),
                   ("sssp", lambda: ops.sssp(g, 0, 4, **kw))):
        _, info = fn()
        res[f"{op}/{sch}"] = {"bytes": info["bytes_exchanged"],
                              "iterations": info["iterations"],
                              "collectives": RL.collectives_from_info(info)}
if rank == 0:
    with open(out, "w") as f:
        json.dump(res, f)
end_rank()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_graph_job_wire_bytes_match_real_runs(tmp_path, world):
    """graph_job's wire model at a small V equals what P gloo ranks of a
    real `run_vcprog_distributed` report as `info["bytes_exchanged"]`,
    for both operators under each schedule."""
    port = collectives.free_port()
    out = tmp_path / "bytes.json"
    env = envutil.subprocess_env(threads=1)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), str(port),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    got = json.loads(out.read_text())
    for sch in G.SCHEDULES:
        for op in ("pagerank", "sssp"):
            run = got[f"{op}/{sch}"]
            model = G.exchange_bytes(op, sch, world, got["V"])
            assert model == run["bytes"], (op, sch)
            (kind, c), = run["collectives"].items()
            assert kind == RL.EXCHANGE_KIND[sch]
            assert c["wire_bytes"] == \
                model["per_superstep"] * run["iterations"]


def test_graph_job_cli_and_report(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(G, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(report, "OUT_DIRS", (str(tmp_path),))
    with pytest.raises(SystemExit) as e:
        G.main(["--op", "all", "--schedule", "all", "--mesh", "both"])
    assert e.value.code == 0
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert len(files) == 12 and "graph-sssp__push__multipod.json" in files
    rec = json.loads((tmp_path / "graph-pagerank__ring__pod.json").read_text())
    for k in ("arch", "shape", "mesh", "chips", "status", "memory",
              "roofline", "v_scale", "e_scale"):
        assert k in rec, k
    assert rec["cost_source"] == "analytic" and rec["status"] == "OK"
    assert rec["chips"] == 256 and rec["v_per_part"] == 1 << 20
    rf = rec["roofline"]
    wire = G.exchange_bytes("pagerank", "ring", 256, G.V_SCALE)
    assert rf["wire_bytes_per_chip"] == wire["per_superstep"]
    assert rf["hbm_bytes"] == sum(rec["hbm_bytes_by_pass"].values())
    assert rf["memory_s"] == pytest.approx(rf["hbm_bytes"] / RL.HBM_BW)
    assert rf["collective_s"] == pytest.approx(
        wire["per_superstep"] / RL.LINK_BW)
    capsys.readouterr()
    report.main()
    text = capsys.readouterr().out
    assert "NVIDIA H100" in text and "TPU" not in text
    assert text.count("| graph-pagerank | ring-V228-E232 |") == 3
    assert "analytic" in text


# ---------------------------------------------------------------------------
# the training launcher: preemption and resume; a reference checkpoint
# ---------------------------------------------------------------------------

def _launch(ckpt, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "12", "--warmup", "2", "--lr", "1e-3",
         "--log-every", "1", "--checkpoint-every", "100",
         "--checkpoint-dir", str(ckpt), *extra],
        env=envutil.subprocess_env(threads=2), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _final(out):
    return json.loads(out.strip().splitlines()[-1])


def test_launcher_sigterm_then_resume(tmp_path):
    """--smoke --device cpu --steps 12, SIGTERM after step 2's line: an
    emergency checkpoint, exit 0; --resume runs the rest to the same final
    loss as an uninterrupted run, bitwise."""
    full = _launch(tmp_path / "full")
    so, se = full.communicate(timeout=300)
    assert full.returncode == 0, se[-3000:]
    want = _final(so)
    p = _launch(tmp_path / "cut")
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if line.startswith("step     2"):
                p.send_signal(signal.SIGTERM)
                break
        rest, err = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err[-3000:]
    assert "emergency checkpoint" in "".join(lines) + rest
    steps = sorted(int(d.name[5:]) for d in
                   (tmp_path / "cut" / "granite-moe-1b-a400m-smoke").iterdir())
    assert steps and 3 <= steps[-1] < 12
    r = _launch(tmp_path / "cut", "--resume")
    so, se = r.communicate(timeout=300)
    assert r.returncode == 0, se[-3000:]
    assert f"resumed from step {steps[-1]}" in so
    assert _final(so)["last_loss"] == want["last_loss"]


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """Two reference steps, saved by the reference's CheckpointManager,
    restored and converted: the port's step 3 agrees with the
    reference's step 3."""
    arch = "granite-moe-1b-a400m"
    jcfg = jcfgs.smoke(jcfgs.get_config(arch))
    tcfg = tcfgs.smoke(tcfgs.get_config(arch))
    jstep = jax.jit(JTS.make_train_step(jcfg, None, j_lr(1e-3, 1, 10)))
    data = SyntheticLMDataset(tcfg.vocab_size, 16, 2, seed=5)
    jstate = JTS.init_train_state(jcfg, jax.random.PRNGKey(2))
    for s in range(2):
        jstate, _ = jstep(jstate, data.batch(s))
    mgr = JCheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, jstate)
    tree = mgr.restore(jax.tree.map(np.zeros_like, jstate))
    state = convert.train_state_from_numpy(tree, tcfg, "cpu")
    assert int(state.step) == 2 and int(state.opt.step) == 2
    step = TS.make_train_step(tcfg, None, linear_warmup_cosine(1e-3, 1, 10))
    state, m = step(state, data.batch(2))
    jstate, jm = jstep(jstate, data.batch(2))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert int(state.step) == 3


def test_launcher_on_two_ranks_resumes_on_one(tmp_path):
    """`torchrun --nproc-per-node 2` runs the sharded step on two gloo
    CPU ranks (the first line names the backend), rank 0 checkpoints at
    the end, and --resume on one rank reshards that checkpoint: its last
    loss lands within 1e-5 of an uninterrupted one-rank run's."""
    ckpt = tmp_path / "two"
    common = ["--smoke", "--device", "cpu", "--warmup", "2", "--lr", "1e-3",
              "--log-every", "1", "--checkpoint-every", "100",
              "--seq-len", "512"]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(collectives.free_port()), "-m",
         "repro_torch.launch.train", *common, "--steps", "3",
         "--checkpoint-dir", str(ckpt)],
        env=envutil.subprocess_env(threads=1), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    assert two.stdout.splitlines()[0].startswith("backend=gloo on the CPU")
    assert "mesh={'data': 2, 'model': 1}" in two.stdout
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--steps", "5", "--checkpoint-dir", str(ckpt), "--resume"],
        env=envutil.subprocess_env(threads=2), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    assert "resumed from step 3" in one.stdout
    full = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--steps", "5", "--checkpoint-dir", str(tmp_path / "full")],
        env=envutil.subprocess_env(threads=2), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert full.returncode == 0, full.stderr[-3000:]
    np.testing.assert_allclose(_final(one.stdout)["last_loss"],
                               _final(full.stdout)["last_loss"], rtol=1e-5)
