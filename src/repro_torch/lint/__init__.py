"""repro_torch.lint — static analysis + retrace sentinel for VCPrograms.

UniGPS's pitch is that an analyst writes one Python VCProg and the
framework hides the execution — which means user mistakes must surface
as diagnostics at program-definition time, not as failures or silent
wrong answers deep inside an engine's superstep loop. This package is
that surface, in three layers:

  layer 1  lint/contracts.py     vmapped contract checks      UL10x
  layer 2  lint/trace_audit.py   vmap escapes, make_fx diffs  UL20x
  layer 3  lint/retrace.py       runtime compile counting     UL301

Layers 1 and 2 call the user's methods as the engines do
(`vcprog.record_vmap`) on K = 3 synthetic samples on the CPU: they
allocate nothing on a card and launch no kernel, whatever the session's
device. UL203/UL204 (host-callback hygiene in the JAX package) do not
apply in the port.

Entry points:

  * :func:`check_program` — lint one program (or BatchedProgram),
    returns a list of :class:`Finding`;
  * ``UniGPS(lint="warn"|"error"|"off")`` — every `vcprog()` call lints
    the user program first (cached per program class);
  * ``python -m repro_torch.lint <files...>`` — the CLI
    (``--list-rules``, ``--json``, ``--error``, ``--rules``);
  * ``ServingSession(sentinel=...)`` — the layer-3 retrace sentinel
    guarding warm cache hits and in-capacity deltas (lint/retrace.py).

Suppression: set ``lint_suppress = ("UL105", ...)`` on the program
class, or pass ``rules=`` to check only a subset.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..core import vcprog as _vcprog
from . import contracts, retrace, trace_audit
from .retrace import (CompileWatcher, RetraceError, RetraceWarning,
                      assert_compiles)
from .rules import RULES, Finding, finding

__all__ = ["CompileWatcher", "Finding", "LintError", "LintWarning",
           "RULES", "RetraceError", "RetraceWarning", "assert_compiles",
           "check_and_report", "check_program", "finding",
           "resolve_lint_mode", "retrace"]

_MODES = ("warn", "error", "off")


class LintError(ValueError):
    """Raised under lint='error' / --error; carries the findings."""

    def __init__(self, findings):
        self.findings = list(findings)
        n = len(self.findings)
        body = "\n".join(str(f) for f in self.findings)
        super().__init__(
            f"{n} lint finding(s) on the VCProgram:\n{body}")


class LintWarning(UserWarning):
    """Emitted per finding under lint='warn'."""


def resolve_lint_mode(lint, knob: str = "lint") -> str:
    """Validate the lint knob ("warn"|"error"|"off"; None = "warn")."""
    if lint is None:
        return "warn"
    if lint in _MODES:
        return lint
    from ..core.knobs import knob_error
    raise knob_error(knob, lint, _MODES)


def check_program(program, *, graph=None, vertex_props=None,
                  edge_props=None, query_attrs=(), rules=None):
    """Lint one VCProgram (or BatchedProgram); returns the findings.

    `graph` (or explicit `vertex_props`/`edge_props` samples) supplies
    the property schema the synthetic records carry — lint with the real
    graph when the program indexes custom props. `query_attrs` names
    additional attrs that must ride batched lanes as operands (UL201),
    on top of the class's own `lane_attrs` declaration. `rules`
    restricts checking to the given rule ids; the class's
    `lint_suppress` tuple always filters its listed ids out.
    """
    base = program
    batched = isinstance(program, _vcprog.BatchedProgram)
    if batched:
        base = program.base_program()
    samples = contracts.synthetic_samples(
        base, graph=graph, vertex_props=vertex_props,
        edge_props=edge_props)

    findings = list(contracts.check_contracts(base, samples))
    if batched:
        findings += trace_audit.audit_batched(program, samples,
                                              query_attrs=query_attrs)

    suppress = set(getattr(type(base), "lint_suppress", ()) or ())
    findings = [f for f in findings if f.rule not in suppress]
    if rules is not None:
        allow = set(rules)
        findings = [f for f in findings if f.rule in allow]
    # deterministic order: by rule id, then method
    return sorted(findings, key=lambda f: (f.rule, f.method or "",
                                           f.message))


# -- UniGPS(lint=...) integration -------------------------------------------

#: lint results cached per (program classes, attr names, prop schema):
#: the rules are value-independent in outcome, so one check per class
#: per graph schema keeps the per-call overhead at one dict probe.
_checked: dict = {}


def _schema(props):
    return tuple(sorted((k, str(np.asarray(v).dtype), np.shape(v)[1:])
                        for k, v in (props or {}).items()))


def _cache_key(program, graph):
    progs = program if isinstance(program, (list, tuple)) else (program,)
    ident = tuple((type(p), tuple(sorted(p.__dict__)))
                  if not isinstance(p, _vcprog.BatchedProgram)
                  else (type(p), p.base_class, p.lane_attr_names,
                        tuple(sorted(p.common_attrs)))
                  for p in progs)
    schema = None
    if graph is not None:
        schema = (_schema(graph.vertex_props), _schema(graph.edge_props))
    return (ident, schema)


def check_and_report(program, *, graph=None, mode="warn") -> list:
    """The `UniGPS.vcprog` hook: lint `program` (one program, a program
    list, or a BatchedProgram) and warn/raise per `mode`. Results are
    cached per program class + graph schema, so a hot request loop pays
    one dict probe."""
    mode = resolve_lint_mode(mode)
    if mode == "off":
        return []
    key = _cache_key(program, graph)
    findings = _checked.get(key)
    if findings is None:
        progs = (program if isinstance(program, (list, tuple))
                 else (program,))
        findings = []
        seen = set()
        for p in progs:
            cls = (p.base_class if isinstance(p, _vcprog.BatchedProgram)
                   else type(p))
            if cls in seen:
                continue
            seen.add(cls)
            findings += check_program(p, graph=graph)
        _checked[key] = findings
    if findings:
        if mode == "error":
            raise LintError(findings)
        for f in findings:
            warnings.warn(str(f), LintWarning, stacklevel=3)
    return findings
