"""GPipe pipeline over a "pipe" axis of four gloo ranks on the CPU: staged
execution equals the sequential result (the reference's
tests/test_pipeline.py case: S 4 stages of 2 tanh layers, D 16, B 8, M 4
microbatches), held to 1e-5 against the JAX package's sequential run of
the same numpy weights. Every rank returns the whole output (the last
stage's, broadcast by a masked psum)."""
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from repro_torch import envutil
from repro_torch.distributed import collectives

S, L_PER, D, B, M = 4, 2, 16, 8, 4

_RANK = r"""
import faulthandler, json, sys
faulthandler.enable(all_threads=True)
import numpy as np, torch
from repro_torch.distributed.collectives import end_rank, init_rank
from repro_torch.distributed.pipeline import make_pipelined_fn
from repro_torch.launch.mesh import RankLayout
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
S, L_PER, D, B, M = 4, 2, 16, 8, 4
torch.set_num_threads(1)
init_rank(rank, world, port, "gloo")
rng = np.random.default_rng(0)
Ws = torch.from_numpy(rng.normal(size=(S, L_PER, D, D)).astype(np.float32)
                      * np.float32(0.3))
x = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))

def stage_fn(w_stage, x):
    for i in range(L_PER):
        x = torch.tanh(x @ w_stage[i])
    return x

lay = RankLayout((S,), ("pipe",), rank, torch.device("cpu"))
piped = make_pipelined_fn(stage_fn, lay, "pipe", num_microbatches=M)
y = piped(Ws, x)
comm = lay.comm("pipe")
with open(f"{out}.{rank}", "w") as f:
    json.dump({"y": y.tolist(), "permutes": comm.by_kind[
        "collective-permute"]["count"]}, f)
end_rank()
"""


def test_pipeline_matches_sequential(tmp_path):
    port = collectives.free_port()
    out = tmp_path / "y.json"
    env = envutil.subprocess_env(threads=1)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(S), str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(S)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, (r, port, [q.returncode for q in procs],
                                   [e[-1500:] for e in errs])

    rng = np.random.default_rng(0)
    Ws = jnp.asarray(rng.normal(size=(S, L_PER, D, D)).astype(np.float32)
                     * np.float32(0.3))
    y_seq = jnp.asarray(rng.normal(size=(B, D)).astype(np.float32))
    for s in range(S):
        for i in range(L_PER):
            y_seq = jnp.tanh(y_seq @ Ws[s, i])
    for r in range(S):
        got = json.loads(open(f"{out}.{r}").read())
        err = float(np.abs(np.asarray(got["y"]) - np.asarray(y_seq)).max())
        assert err < 1e-5, (r, err)
        # M + S - 1 ticks, one ring permute each
        assert got["permutes"] == M + S - 1
