"""LM substrate: the dense serving path (prefill + decode) of the
reference's architecture zoo, for the configs whose blocks are attention
and MLP (dense, vlm and audio families)."""
from . import decoding, layers, transformer  # noqa: F401
from .decoding import greedy_generate, prefill_step  # noqa: F401
from .transformer import (Transformer, decode_step, forward,  # noqa: F401
                          init_decode_state, lm_loss)
