"""dbrx-132b [moe] — 16 experts top-4 fine-grained MoE, GQA kv=8, LayerNorm.
[hf:databricks/dbrx-base; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,                   # per expert
    vocab_size=100352,
    activation="swiglu",
    norm="layernorm",
    rope_theta=5e5,
    num_experts=16,
    top_k=4,
    block_pattern=("moe",),
))
