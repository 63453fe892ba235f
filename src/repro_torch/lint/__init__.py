"""repro_torch.lint — the linter's runtime layer: the retrace sentinel
(rule UL301, lint/retrace.py). The static rules (UL10x, UL20x) are not
ported yet, and the facade's `lint=` knob stays "off"."""
from . import retrace
from .retrace import (CompileWatcher, RetraceError, RetraceWarning,
                      assert_compiles)

__all__ = ["CompileWatcher", "RetraceError", "RetraceWarning",
           "assert_compiles", "retrace"]
