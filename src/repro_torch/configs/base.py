"""Architecture config system.

Each assigned architecture lives in its own module (configs/<id>.py) with
the exact published geometry; `smoke(cfg)` derives the reduced variant the
CPU smoke tests instantiate (same family/block pattern, tiny dims).

This is the port's own copy of the reference package's configs, value for
value: the port imports nothing of that package, whose import loads jax.
In the port `attn_impl="xla"` names the full-scores einsum path
(`models.layers.attention_scores_xla`), `"flash_kernel"` the hand-written
CUDA flash-attention kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | vlm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    activation: str = "swiglu"       # swiglu | geglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = global attention
    tied_embeddings: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # block pattern, repeated to cover num_layers (remainder applied at the
    # end); tokens: attn | local | moe | mlstm | slstm | rglru
    block_pattern: Tuple[str, ...] = ("attn",)
    # recurrent dims
    rnn_width: int = 0               # RG-LRU width (0 -> d_model)
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0   # xLSTM block up-projection
    # modality frontend stub (vlm/audio): inputs are precomputed embeddings
    embed_inputs: bool = False
    max_seq_len: int = 131072
    # numerics / compile strategy
    dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots
    scan_layers: bool = True
    attn_impl: str = "xla"           # xla | xla_chunked | flash_kernel
    moe_impl: str = "sort"           # sort (gather-based) | einsum (GShard)
    # §Perf lever: shard dispatch indices over experts BEFORE the gather so
    # expert inputs are born EP-sharded instead of being resharded after
    moe_ep_gather: bool = False
    # §Perf lever: EP-local scatter-add combine — each expert shard writes
    # its outputs back to token space and only the [G,g,D] partial sums
    # cross the mesh (vs gathering the [G,E,C,D] expert outputs everywhere)
    moe_ep_combine: bool = False
    # activation sharding profile: default (sequence-parallel over TP) |
    # dp (batch over every axis; for recurrent archs whose time scans
    # break under a sharded sequence)
    sharding_profile: str = "default"
    fsdp: bool = True
    # Megatron-style vocab padding so embeddings/logits shard over TP even
    # for odd vocabs (granite's 49155); padded logit columns are masked.
    vocab_pad_multiple: int = 256

    # ---- derived ----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def layer_types(self) -> Tuple[str, ...]:
        """The per-layer block type, pattern repeated + remainder."""
        p = self.block_pattern
        reps = self.num_layers // len(p)
        rem = self.num_layers - reps * len(p)
        return tuple(p) * reps + tuple(p[:rem])

    @property
    def sub_quadratic(self) -> bool:
        """True when 500k-token decode is feasible (no full-attention KV)."""
        return all(t in ("mlstm", "slstm", "rglru", "local")
                   for t in self.layer_types)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        from . import _load_all  # late import to avoid cycles
        _load_all()
    return _REGISTRY[name]


def list_archs():
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests: small layers/width,
    few experts, tiny vocab — but the SAME block pattern and code paths."""
    pat_len = len(cfg.block_pattern)
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=max(2, pat_len + (pat_len > 1)),  # cover pattern+remainder
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads
        else cfg.num_kv_heads,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256 if cfg.vocab_size % 2 == 0 else 255,  # keep odd/even
        num_experts=min(cfg.num_experts, 4),
        top_k=min(cfg.top_k, 2),
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        rnn_width=64 if cfg.rnn_width else 0,
        max_seq_len=512,
        dtype="float32",
        remat="none",
        scan_layers=cfg.scan_layers,
    )


# ---------------------------------------------------------------------------
# Analytic param / FLOP model (for the roofline's MODEL_FLOPS = 6·N·D term)
# ---------------------------------------------------------------------------

def _mlp_params(cfg: ArchConfig) -> int:
    if cfg.d_ff == 0:
        return 0
    mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return mats * cfg.d_model * cfg.d_ff


def _attn_params(cfg: ArchConfig) -> int:
    hd = cfg.head_dim_
    q = cfg.d_model * cfg.num_heads * hd
    kv = 2 * cfg.d_model * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * cfg.d_model
    return q + kv + o


def _block_params(cfg: ArchConfig, kind: str) -> int:
    d = cfg.d_model
    norms = 2 * d
    if kind in ("attn", "local"):
        return _attn_params(cfg) + _mlp_params(cfg) + norms
    if kind == "moe":
        router = d * cfg.num_experts
        return _attn_params(cfg) + router + cfg.num_experts * _mlp_params(cfg) + norms
    if kind == "mlstm":
        inner = int(d * cfg.mlstm_proj_factor)
        # up(2x for gate), qkv over inner, gates, down
        return 2 * d * inner + 3 * inner * inner + 3 * inner + inner * d + norms
    if kind == "slstm":
        # 4 gates, recurrent + input weights at model width + ffn-ish proj
        return 8 * d * d + 4 * d + norms
    if kind == "rglru":
        r = cfg.rnn_width_
        # in/out proj (x2 branches), conv, gates
        return 2 * d * r + r * d + cfg.conv_width * r + 2 * r * r + 2 * r + norms
    raise ValueError(kind)


def param_count(cfg: ArchConfig) -> int:
    n = cfg.vocab_size * cfg.d_model          # embedding
    if not cfg.tied_embeddings:
        n += cfg.vocab_size * cfg.d_model     # lm head
    n += cfg.d_model                          # final norm
    for kind in cfg.layer_types:
        n += _block_params(cfg, kind)
    return n


def active_param_count(cfg: ArchConfig) -> int:
    """MoE: params actually touched per token (6·N_active·D convention)."""
    if not cfg.is_moe:
        return param_count(cfg)
    n = param_count(cfg)
    for kind in cfg.layer_types:
        if kind == "moe":
            n -= (cfg.num_experts - cfg.top_k) * _mlp_params(cfg)
    return n


def model_flops(cfg: ArchConfig, num_tokens: int) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); embedding params excluded per
    the standard convention (gather, not matmul) but the LM head included."""
    n_active = active_param_count(cfg) - cfg.vocab_size * cfg.d_model
    return 6.0 * n_active * num_tokens
