"""One error format for every execution-knob resolver.

Every knob resolver (`resolve_kernel_mode`, `resolve_frontier_mode`,
`resolve_prefetch_mode`, `resolve_exchange_mode`, `resolve_guards_mode`,
`resolve_lint_mode`, ...) historically spelled its own ValueError, so
the knob name, the offending value, and the valid choices appeared in a
different order and quoting style per module. They now all raise through
:func:`knob_error`, so a bad knob anywhere in the stack reads the same:

    frontier must be one of ('auto', 'dense', 'sparse'), got 'sprase'

Test suites match on the knob *name* only, so the shared format is the
contract; the exact punctuation is not.
"""
from __future__ import annotations

__all__ = ["knob_error"]


def knob_error(name: str, value, choices, note: str = "") -> ValueError:
    """A uniformly-formatted ValueError for a bad knob value.

    `name` is the knob (keyword argument) name, `choices` the valid
    values in preference order, `note` an optional trailing hint (e.g.
    legacy aliases also accepted). Returned, not raised — call sites
    `raise knob_error(...)` so the traceback points at the resolver.
    """
    suffix = f" {note}" if note else ""
    return ValueError(
        f"{name} must be one of {tuple(choices)}{suffix}, got {value!r}")
