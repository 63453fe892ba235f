"""xlstm-350m in bf16: the port's rounding against the reference's.

The model tests hold every block to the reference in f32. The bf16 path
casts in other places (the projections in the activation dtype, then the
gates and states in f32), and a cast the port put elsewhere would show
only in bf16. At the smoke widths the bf16 model is blind to that (d 64:
its bf16 decode and forward give the same bits), so this test runs
xlstm-350m at its full width (d 1024, 4 heads of 512, mLSTM inner 2048,
vocab 50,304), cut to its first four layers (mLSTM, mLSTM, mLSTM,
sLSTM). The reference's `init_model` weights are rounded to bf16 once,
so the f32 and bf16 models of both packages hold the same values.

What is held: each package's bf16 forward, and its prefill plus one
decode step, at T + 1 = 34. A distance is the root mean square of the
difference over the RMS of the reference's f32 logits (the largest
difference, over 100,608 logits, moves by a third between runs that only
reorder a sum; the RMS does not). The port's bf16 forward and decode,
each against the reference's f32 forward, and its bf16 decode against
its own bf16 forward, must be within 1.5x the reference's same
distances, and the two packages' bf16 forwards within 1.5x the
reference's bf16-f32 distance. Read on the CPU: the reference 0.0241
(forward), 0.0242 (decode), 0.0061 (decode vs forward); the port
0.0241, 0.0235, 0.0070; the two bf16 forwards 0.0261 apart. A cast
planted in a copy (the mLSTM's log forget gates summed in bf16) read
0.0545, 0.0492 and 0.0285, and fails each check. The f32 models agree
within 1e-4, as in `test_torch_models.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jcfgs
from repro import models as M
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch import models as TM

ARCH = "xlstm-350m"
LAYERS, B, T = 4, 2, 33
RATIO = 1.5


def _cfgs(dtype):
    kw = dict(num_layers=LAYERS, dtype=dtype)
    return (jcfgs.get_config(ARCH).replace(**kw),
            tcfgs.get_config(ARCH).replace(**kw))


def _reference(params, cfg, x, cache_dtype):
    """(forward's logits at the last position, prefill on the first T
    tokens plus one decode step's)."""
    fwd = jax.jit(M.forward, static_argnames=("cfg",))(
        params, cfg, jnp.asarray(x))[0][:, -1]
    _, st = jax.jit(M.prefill_step,
                    static_argnames=("cfg", "max_len", "cache_dtype"))(
        params, cfg, jnp.asarray(x[:, :T]), max_len=T + 1,
        cache_dtype=cache_dtype)
    dec, _ = jax.jit(M.decode_step, static_argnames=("cfg",))(
        params, cfg, jnp.asarray(x[:, T]), st)
    return (np.asarray(fwd, np.float32), np.asarray(dec, np.float32))


@torch.no_grad()
def _port(model, x, cache_dtype):
    fwd = TM.forward(model, torch.from_numpy(x))[0][:, -1]
    _, st = TM.prefill_step(model, torch.from_numpy(x[:, :T]),
                            max_len=T + 1, cache_dtype=cache_dtype)
    dec, _ = TM.decode_step(model, torch.from_numpy(x[:, T]), st)
    return fwd.float().numpy(), dec.float().numpy()


def test_xlstm_bf16_rounds_as_the_reference():
    j32, t32 = _cfgs("float32")
    j16, t16 = _cfgs("bfloat16")
    params, _ = M.init_model(j32, jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)
    sd = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), t32)
    m32 = TM.Transformer(t32, device="cpu")
    m32.load_state_dict(sd, strict=True)
    m16 = TM.Transformer(t16, device="cpu", dtype=torch.bfloat16)
    m16.load_state_dict({k: v.to(torch.bfloat16) for k, v in sd.items()},
                        strict=True)
    x = np.random.default_rng(0).integers(
        0, j32.vocab_size, (B, T + 1)).astype(np.int32)
    V = j32.vocab_size

    ref32, ref32_dec = _reference(params, j32, x, jnp.float32)
    ref16, ref16_dec = _reference(params, j16, x, jnp.bfloat16)
    got32, got32_dec = _port(m32, x, torch.float32)
    got16, got16_dec = _port(m16, x, torch.bfloat16)
    ref32, ref32_dec, ref16, ref16_dec, got32, got32_dec, got16, \
        got16_dec = (a[:, :V] for a in (ref32, ref32_dec, ref16, ref16_dec,
                                        got32, got32_dec, got16, got16_dec))

    np.testing.assert_allclose(got32, ref32, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got32_dec, ref32_dec, rtol=1e-4, atol=1e-4)
    scale = float(np.sqrt(np.mean(ref32.astype(np.float64) ** 2)))

    def dist(a, b=ref32):
        d = a.astype(np.float64) - b
        return float(np.sqrt(np.mean(d ** 2))) / scale

    assert np.isfinite(got16).all() and np.isfinite(got16_dec).all()
    # the reference's own bf16 rounding: enough to be measured, too little
    # to mean a broken model
    assert 1e-3 < dist(ref16) < 0.2 and 1e-3 < dist(ref16_dec) < 0.2
    assert dist(got16) <= RATIO * dist(ref16)
    assert dist(got16_dec) <= RATIO * dist(ref16_dec)
    assert dist(got16_dec, got16) <= RATIO * dist(ref16_dec, ref16)
    assert dist(got16, ref16) <= RATIO * dist(ref16)
