"""granite-moe-1b-a400m [moe] — 32 experts top-8, GQA kv=8, tied embeddings.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                     # per expert (fine-grained)
    vocab_size=49155,             # odd vocab — exercises sharding fallback
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1e4,
    tied_embeddings=True,
    num_experts=32,
    top_k=8,
    block_pattern=("moe",),
))
