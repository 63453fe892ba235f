"""The training path on one rank: train, serve and prefill steps."""
from .step import (TrainState, init_train_state, make_prefill_step,  # noqa: F401
                   make_serve_step, make_train_step)
