"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (3:1 m:s pattern), no FFN
(the xLSTM block carries its own up/down projection). [arXiv:2405.04517;
unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,                       # per assignment: block-internal projections
    vocab_size=50304,
    norm="rmsnorm",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_proj_factor=2.0,
    conv_width=4,
    max_seq_len=1 << 20,          # recurrent state is O(1) in sequence length
))
