"""starcoder2-7b [dense] — GQA, RoPE, sliding-window 4096, GELU + LayerNorm.
[arXiv:2402.19173; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    activation="gelu",
    norm="layernorm",
    rope_theta=1e5,
    sliding_window=4096,
    block_pattern=("attn",),
))
