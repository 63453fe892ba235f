"""qwen3-14b [dense] — qk_norm, GQA, SwiGLU, RMSNorm. [hf:Qwen/Qwen3-14B]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    activation="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=1e6,
    block_pattern=("attn",),
))
