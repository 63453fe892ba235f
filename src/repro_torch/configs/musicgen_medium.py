"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens;
the EnCodec frontend is a STUB per the brief (input_specs supplies
precomputed frame embeddings). MHA (kv=24), LayerNorm + GELU.
[arXiv:2306.05284; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    activation="gelu",
    norm="layernorm",
    rope_theta=1e4,               # sinusoidal in the original; RoPE here
    embed_inputs=True,            # frame embeddings come precomputed
    block_pattern=("attn",),
))
