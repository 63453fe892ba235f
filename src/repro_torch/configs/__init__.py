"""Architecture registry: the 10 assigned archs + the paper's graph
workload configs. `get_config(name)` / `list_archs()` are the entry points;
`--arch <id>` in the launchers resolves through here."""
from .base import (ArchConfig, active_param_count, get_config, list_archs,  # noqa: F401
                   model_flops, param_count, register, smoke)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (dbrx_132b, granite_moe_1b_a400m, mistral_nemo_12b,  # noqa: F401
                   musicgen_medium, phi4_mini_3_8b, pixtral_12b,
                   qwen3_14b, recurrentgemma_9b, starcoder2_7b, xlstm_350m)


_load_all()

ASSIGNED_ARCHS = (
    "starcoder2-7b", "qwen3-14b", "mistral-nemo-12b", "phi4-mini-3.8b",
    "dbrx-132b", "granite-moe-1b-a400m", "xlstm-350m", "pixtral-12b",
    "recurrentgemma-9b", "musicgen-medium",
)

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
