"""Flash attention: the port's plain version against the reference.

`repro_torch.kernels.flash_attention.flash_attention_plain` (the CPU path
of the CUDA kernel, and its oracle on the card) against the JAX package's
Pallas kernel (`repro.kernels.ops.flash_attention`, interpret mode on the
CPU) and its oracle `mha_ref`, on the same numpy inputs. Tolerances: f32
2e-5, as tests/test_kernels.py holds the Pallas kernel to `mha_ref`; bf16
5e-2 abs, as test_flash_attention_bf16 does (both sides round the output
to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import counters
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=0, atol=5e-2)


def _inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in (shape_q, shape_kv, shape_kv))


def _both(q, k, v, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    """(port plain, Pallas interpret, mha_ref) as f32 numpy arrays."""
    port = fa.flash_attention_plain(*(torch.from_numpy(x).to(tdtype)
                                      for x in (q, k, v)), **kw)
    jq, jk, jv = (jnp.asarray(x, jdtype) for x in (q, k, v))
    kern = jops.flash_attention(jq, jk, jv, **kw)
    ref = jops.mha_ref(jq, jk, jv, **kw)
    return (port.float().numpy(), np.asarray(kern, np.float32),
            np.asarray(ref, np.float32))


@pytest.mark.parametrize("B,Hq,Hkv,T,S,Dh", [
    (1, 1, 1, 8, 8, 64),
    (2, 4, 2, 100, 100, 64),
    (1, 8, 1, 128, 128, 128),     # MQA
    (2, 6, 2, 96, 96, 64),        # non-pow2 heads
    (1, 2, 2, 64, 192, 64),       # T != S (full attention, as the reference)
    (1, 4, 2, 129, 129, 128),     # one row past a 128-row tile
    (1, 2, 1, 128, 384, 64),      # T != S at tile multiples
])
def test_plain_matches_pallas_shapes(B, Hq, Hkv, T, S, Dh):
    q, k, v = _inputs((B, Hq, T, Dh), (B, Hkv, S, Dh), seed=T + S)
    port, kern, ref = _both(q, k, v, causal=T == S)
    np.testing.assert_allclose(port, kern, **F32_TOL)
    np.testing.assert_allclose(port, ref, **F32_TOL)


@pytest.mark.parametrize("window", [1, 16, 17, 100, 4096])
def test_plain_matches_pallas_window(window):
    q, k, v = _inputs((1, 4, 130, 64), (1, 2, 130, 64), seed=window)
    port, kern, ref = _both(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(port, kern, **F32_TOL)
    np.testing.assert_allclose(port, ref, **F32_TOL)


@pytest.mark.parametrize("T,S", [(64, 192), (150, 40)])
def test_plain_causal_counts_qpos_from_zero(T, S):
    """Causal with T != S: query row t sees keys 0..t (not the last T of S
    positions as the model's einsum path would); rows past S see every
    key."""
    q, k, v = _inputs((1, 2, T, 16), (1, 1, S, 16), seed=7)
    port, kern, ref = _both(q, k, v, causal=True)
    np.testing.assert_allclose(port, kern, **F32_TOL)
    np.testing.assert_allclose(port, ref, **F32_TOL)
    # row 0 attends key 0 only: its output is v[0]
    np.testing.assert_allclose(port[0, :, 0], np.repeat(v[0, :, 0], 2, 0),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [None, 8, 40])
@pytest.mark.parametrize("q0,Tq", [(0, 48), (48, 48), (64, 32), (95, 1)])
def test_plain_q_offset_matches_the_reference_rows(q0, Tq, window):
    """A rank holding query rows q0..q0+Tq-1 of a 96-position sequence
    (against all 96 keys, as under a sequence split): the plain version
    with q_offset=q0 equals those rows of the reference's attention on the
    whole sequence (the Pallas kernel in interpret mode and `mha_ref`),
    with and without a window."""
    q, k, v = _inputs((2, 4, 96, 32), (2, 2, 96, 32), seed=q0 + Tq)
    kw = dict(causal=True, window=window)
    _, kern, ref = _both(q, k, v, **kw)
    rows = slice(q0, q0 + Tq)
    port = fa.flash_attention_plain(
        torch.from_numpy(q[:, :, rows]), torch.from_numpy(k),
        torch.from_numpy(v), q_offset=q0, **kw).numpy()
    np.testing.assert_allclose(port, kern[:, :, rows], **F32_TOL)
    np.testing.assert_allclose(port, ref[:, :, rows], **F32_TOL)
    # the wrapper's CPU path takes the same offset
    got = tops.flash_attention(torch.from_numpy(q[:, :, rows]),
                               torch.from_numpy(k), torch.from_numpy(v),
                               q_offset=q0, **kw).numpy()
    np.testing.assert_array_equal(got, port)


def test_plain_q_offset_refuses_a_negative_one():
    q, k, v = (torch.zeros((1, 1, 4, 16)) for _ in range(3))
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_plain(q, k, v, q_offset=-1)


def test_plain_ragged_and_dead_rows():
    """Ragged T = S = 77 (no tile multiple); window 0 leaves every row
    without a live key, so every row is 0 on both sides."""
    q, k, v = _inputs((2, 4, 77, 32), (2, 2, 77, 32), seed=3)
    port, kern, _ = _both(q, k, v, causal=True)
    np.testing.assert_allclose(port, kern, **F32_TOL)
    port0, kern0, ref0 = _both(q, k, v, causal=True, window=0)
    assert not port0.any() and not kern0.any() and not ref0.any()


def test_plain_matches_pallas_bf16():
    q, k, v = _inputs((2, 4, 64, 64), (2, 4, 64, 64), seed=11)
    port, kern, ref = _both(q, k, v, jnp.bfloat16, torch.bfloat16,
                            causal=True)
    np.testing.assert_allclose(port, kern, **BF16_TOL)
    np.testing.assert_allclose(port, ref, **BF16_TOL)


# Dh 256, recurrentgemma-9b's head dim (MQA, window 2048 at full width):
# the plain version against the Pallas kernel in interpret mode
DH256_CASES = {
    "mqa": dict(B=1, Hq=4, Hkv=1, T=130, S=130),
    "mqa_window": dict(B=2, Hq=4, Hkv=1, T=130, S=130, window=17),
    "gqa_window_long": dict(B=1, Hq=4, Hkv=2, T=200, S=200, window=64),
    "T_lt_S": dict(B=1, Hq=2, Hkv=1, T=64, S=192),
    "T_gt_S": dict(B=1, Hq=2, Hkv=1, T=150, S=40),
}


@pytest.mark.parametrize("case", sorted(DH256_CASES))
def test_plain_matches_pallas_dh256(case):
    c = dict(DH256_CASES[case])
    B, Hq, Hkv, T, S = (c.pop(n) for n in ("B", "Hq", "Hkv", "T", "S"))
    q, k, v = _inputs((B, Hq, T, 256), (B, Hkv, S, 256), seed=T + S)
    port, kern, ref = _both(q, k, v, causal=True, **c)
    np.testing.assert_allclose(port, kern, **F32_TOL)
    np.testing.assert_allclose(port, ref, **F32_TOL)


def test_plain_matches_pallas_dh256_bf16():
    q, k, v = _inputs((1, 4, 96, 256), (1, 1, 96, 256), seed=12)
    port, kern, ref = _both(q, k, v, jnp.bfloat16, torch.bfloat16,
                            causal=True, window=40)
    np.testing.assert_allclose(port, kern, **BF16_TOL)
    np.testing.assert_allclose(port, ref, **BF16_TOL)


def test_plain_sm_scale():
    q, k, v = _inputs((1, 2, 40, 64), (1, 2, 40, 64), seed=5)
    port, kern, ref = _both(q, k, v, causal=True, sm_scale=0.3)
    np.testing.assert_allclose(port, kern, **F32_TOL)


def test_wrapper_runs_plain_on_cpu():
    """ops.flash_attention on CPU tensors is the plain version (the tile
    sizes do not matter there) and launches nothing."""
    q, k, v = (torch.from_numpy(x) for x in
               _inputs((1, 4, 50, 16), (1, 2, 50, 16), seed=9))
    counters.reset()
    a = tops.flash_attention(q, k, v, window=8, block_q=128, block_k=32)
    b = fa.flash_attention_plain(q, k, v, window=8)
    assert torch.equal(a, b)
    assert counters.snapshot()["flash_attention"] == 0


@pytest.mark.parametrize("dtype,Dh,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.float16, 64, "wgmma"),
    (torch.bfloat16, 32, "mma_sync"), (torch.float16, 16, "mma_sync"),
    (torch.float32, 128, "mma_sync"), (torch.float32, 64, "mma_sync"),
    (torch.bfloat16, 256, "wgmma"), (torch.float16, 256, "wgmma"),
    (torch.float32, 256, "mma_sync"),
])
def test_variant_by_dtype_and_head_dim(dtype, Dh, want):
    """bf16/fp16 at Dh 64, 128 and 256 (recurrentgemma's local layers)
    take the wgmma variant; f32 at every head dim (3xTF32 on mma.sync,
    within the reference's 2e-5) and bf16/fp16 at the smoke configs' Dh
    16/32 the mma.sync one."""
    assert fa.variant(dtype, Dh) == want


@pytest.mark.parametrize("dtype,Dh,tile,ok", [
    (torch.bfloat16, 128, (None, None), True),
    (torch.bfloat16, 128, (128, 128), True),
    (torch.bfloat16, 128, (128, 64), True),
    (torch.float16, 64, (None, 64), True),
    (torch.bfloat16, 128, (64, 64), False),
    (torch.bfloat16, 64, (128, 32), False),
    (torch.float32, 128, (128, 64), True),
    (torch.float32, 128, (128, 128), False),
    (torch.bfloat16, 32, (None, None), True),
    (torch.bfloat16, 32, (128, 128), False),
    (torch.bfloat16, 256, (None, None), True),
    (torch.float32, 256, (128, 32), True),
    (torch.float16, 256, (None, 64), True),
    (torch.bfloat16, 256, (128, 128), False),
    (torch.bfloat16, 256, (128, 64), True),
    (torch.float16, 256, (128, 128), False),
    (torch.float32, 128, (None, None), True),
    (torch.float32, 128, (64, 64), False),
    (torch.float32, 64, (None, 64), True),
    (torch.float32, 16, (128, 64), True),
    (torch.float32, 256, (None, None), True),
    (torch.float32, 256, (128, 64), False),
    (torch.float32, 256, (64, 64), False),
])
def test_check_inputs_tiles_per_variant(dtype, Dh, tile, ok):
    """Each variant takes its own tiles (TILES; None its default) and
    refuses the others before any launch."""
    q = torch.zeros(1, 4, 8, Dh, dtype=dtype)
    k = torch.zeros(1, 2, 8, Dh, dtype=dtype)
    if ok:
        fa.check_inputs(q, k, k, *tile)
    else:
        with pytest.raises(ValueError, match="tile"):
            fa.check_inputs(q, k, k, *tile)


@pytest.mark.parametrize("case,exc,match", [
    ("tile", ValueError, "tile"),
    ("dtype", TypeError, "f32/bf16/fp16"),
    ("mixed", TypeError, "f32/bf16/fp16"),
    ("head_dim", ValueError, "head dim"),
    ("head_dim_512", ValueError, "head dim"),
    ("groups", ValueError, "Hq % Hkv"),
    ("layout", ValueError, "do not fit"),
    ("stride", ValueError, "aligned"),
])
def test_check_inputs_refuses(case, exc, match):
    """What the CUDA kernel does not take, checked before any launch."""
    q = torch.zeros(1, 4, 8, 64)
    k = v = torch.zeros(1, 2, 8, 64)
    kw = {}
    if case == "tile":
        kw = dict(block_q=64)      # the f32 kernel's q tile is 128 rows
    elif case == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed":
        k = k.bfloat16()
    elif case in ("head_dim", "head_dim_512"):
        dh = 48 if case == "head_dim" else 512
        q, k, v = (torch.zeros(s[:3] + (dh,)) for s in
                   (q.shape, k.shape, v.shape))
    elif case == "groups":
        k = v = torch.zeros(1, 3, 8, 64)
    elif case == "layout":
        k = v = torch.zeros(1, 2, 8, 32)
    elif case == "stride":
        q = torch.zeros(1, 4, 8, 66)[..., :64]
    with pytest.raises(exc, match=match):
        fa.check_inputs(q, k, v, **kw)
    fa.check_inputs(torch.zeros(1, 4, 8, 64), torch.zeros(1, 2, 8, 64),
                    torch.zeros(1, 2, 8, 64))
