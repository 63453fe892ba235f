"""LM substrate: the serving path (prefill + decode) and the
differentiable loss (`lm_loss`, trained by `train.step`) of the
reference's architecture zoo, every block kind: attention + MLP (dense,
vlm, audio), MoE (`moe.py`) and the recurrent blocks (`recurrent.py`)."""
from . import decoding, layers, moe, recurrent, transformer  # noqa: F401
from .decoding import greedy_generate, prefill_step  # noqa: F401
from .transformer import (DecodeState, Transformer,  # noqa: F401
                          decode_state_specs, decode_step, forward,
                          init_decode_state, lm_loss)
