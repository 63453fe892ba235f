"""pixtral-12b [vlm] — mistral-nemo-12b text backbone; the pixtral-ViT
frontend is a STUB per the brief (input_specs supplies precomputed patch
embeddings). [hf:mistralai/Pixtral-12B-2409; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    embed_inputs=True,            # patch embeddings come precomputed
    block_pattern=("attn",),
))
