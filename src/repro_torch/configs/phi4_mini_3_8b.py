"""phi4-mini-3.8b [dense] — RoPE, SwiGLU, GQA, tied embeddings, 200k vocab.
[arXiv:2412.08905; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1e4,
    tied_embeddings=True,
    block_pattern=("attn",),
))
