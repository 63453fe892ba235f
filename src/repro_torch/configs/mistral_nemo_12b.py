"""mistral-nemo-12b [dense] — GQA kv=8, head_dim 128 (< d_model/H), 128k ctx.
[hf:mistralai/Mistral-Nemo-Base-2407]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,                 # q width 4096 != d_model — real Nemo quirk
    d_ff=14336,
    vocab_size=131072,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    max_seq_len=131072,
    block_pattern=("attn",),
))
