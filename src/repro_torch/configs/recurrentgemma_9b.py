"""recurrentgemma-9b [hybrid] — Griffin: RG-LRU recurrent blocks + local
attention (MQA kv=1, window 2048), pattern 2 recurrent : 1 local attn.
[arXiv:2402.19427; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,                # 12 x (rglru,rglru,local) + (rglru,rglru)
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=1e4,
    sliding_window=2048,
    tied_embeddings=True,
    block_pattern=("rglru", "rglru", "local"),
    rnn_width=4096,
    conv_width=4,
    max_seq_len=1 << 20,          # local window + O(1) recurrent state
))
