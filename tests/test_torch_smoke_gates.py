"""chip_smoke.py's 23g bf16 gate on the CPU: `bf16_distances` and
`check_23g_bf16` on made-up logits (the phase itself runs on the card).
The ranks' logits lie `scale` times as far from the f32 twin as one
rank's, along the same direction, so each ratio reads `scale` exactly."""
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

V = 50          # the vocabulary; the logits carry 6 padded columns more


def _logits(seed, steps=5, rows=2):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (steps, rows, V + 6)).astype(np.float32))


def _result(dist):
    prefill = dict(flash_wgmma=2, flash_mma_sync=0, seq=True, tp=[],
                   finite=True, wall_s=1.0)
    serve = dict(finite=True, weights_staged_max=0, tp=["rglru.act_mlp"],
                 ms=[1.0] * 4, staged_max=0, state_bytes=0, param_bytes=0)
    return dict(prefill=prefill, serve=serve, **dist)


@pytest.mark.parametrize("scale, passes", [(1.0, True), (1.4, True),
                                           (1.6, False)])
def test_23g_bf16_gate_holds_the_ranks_to_one_rank(scale, passes):
    twin, err = _logits(0), 1e-2 * _logits(1)
    one, two = twin + err, twin + scale * err
    two[..., V:] = 1e6      # padded columns are not read
    d = CS.bf16_distances(two, one, twin, V)
    for k in ("max", "rms"):
        assert d[f"two_vs_twin_{k}"] == pytest.approx(
            scale * d[f"one_vs_twin_{k}"], rel=1e-6)
        assert d[f"two_vs_one_{k}"] == pytest.approx(
            abs(scale - 1) * d[f"one_vs_twin_{k}"], rel=1e-6, abs=1e-12)
    b = _result(d)
    if passes:
        CS.check_23g_bf16("m", 0, b, 2, [1.0] * 4, "cpu")
    else:
        with pytest.raises(SystemExit, match="over 1.5 x one rank's"):
            CS.check_23g_bf16("m", 0, b, 2, [1.0] * 4, "cpu")
