"""Finding/rule vocabulary of the VCProg linter.

Every diagnostic `repro_torch.lint` can emit is registered here with a
stable id — the same ids, titles and severities as the JAX package's
catalog — so CI tooling can diff findings across revisions and user
programs can suppress specific rules
(`VCProgram.lint_suppress = ("UL105",)`). Rule ids are grouped by
analysis layer:

  UL1xx  contract checker  (lint/contracts.py, the methods run through
                            `record_vmap` on synthetic CPU samples)
  UL2xx  trace auditor     (lint/trace_audit.py, vmap failures and
                            `make_fx` graphs)
  UL3xx  retrace sentinel  (lint/retrace.py, runtime compile counting)

UL203 and UL204 are kept in the catalog for stable ids but do not apply
in the port (`Rule.applies` is False): the port has no host callback a
method could hand a traced value.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

__all__ = ["Finding", "Rule", "RULES", "finding"]


class Rule(NamedTuple):
    id: str
    title: str
    severity: str  # default severity: "error" | "warning"
    summary: str
    applies: bool = True  # False: kept for its id, never reported here


_NOT_APPLICABLE = (
    "Not applicable in the port: it has no pure_callback/io_callback, so a "
    "method cannot hand a host function a traced value; a method that does "
    "host work on its own parameters (.tolist(), .numpy(), .item()) raises "
    "under torch.func.vmap, which UL100/UL202 report. ")

#: The rule catalog — the single source of truth for `--list-rules` and
#: the per-rule mutant tests.
RULES = {r.id: r for r in [
    Rule("UL100", "method-crash", "error",
         "a VCProgram method raised when run through the engine's vmapped "
         "call path on synthetic records — it would fail identically inside "
         "the superstep loop"),
    Rule("UL101", "state-not-closed", "error",
         "vertex_compute returns a state record whose pytree structure, "
         "leaf shapes, or dtypes differ from init_vertex's — the superstep "
         "loop's carry must be shape-stable across supersteps"),
    Rule("UL102", "message-schema-mismatch", "error",
         "emit_message / merge_message produce a message record that "
         "does not match empty_message()'s structure or dtypes — the "
         "combine plane folds messages into inboxes tiled from the "
         "empty record"),
    Rule("UL103", "bad-monoid-table", "error",
         "the declared `monoid` is not one of sum|min|max|general, or a "
         "per-leaf monoid table does not mirror the message record"),
    Rule("UL104", "monoid-identity-violated", "error",
         "empty_message() is not the identity of merge_message, or "
         "merge_message disagrees with the declared named monoid on "
         "sample values — folds would change converged lanes' results"),
    Rule("UL105", "monotonic-contradicts-monoid", "error",
         "the declared `monotonic` direction contradicts the combine "
         "monoid (e.g. monotonic='decreasing' with a max/sum monoid) — "
         "the guards' monotonicity watchdog would trip on correct runs"),
    Rule("UL106", "bad-lane-shape", "error",
         "a record leaf has rank > 1, or is_active/is_emit is not a "
         "scalar — batched lanes pack record leaves as slab columns, so "
         "per-vertex/per-message leaves must be scalars or [D] vectors"),
    Rule("UL201", "attr-baked-as-trace-constant", "error",
         "a per-query constructor attr is value-equal across batch lanes "
         "and was set on the lane programs as a Python constant — a "
         "runner cached on the lane signature (a serving cache entry's "
         "PreparedRunner) would silently replay this batch's value for "
         "different queries (the replayed-root serving bug class)"),
    Rule("UL202", "tracer-bool-escape", "error",
         "a method forces a mapped tensor to a Python bool/int/float "
         "(`if`, `while`, int(), .item()) — under torch.func.vmap this "
         "raises; use torch.where / arithmetic on the tensors instead"),
    Rule("UL203", "callback-captures-traced-value", "error",
         _NOT_APPLICABLE +
         "(JAX package: a pure_callback/io_callback host function closes "
         "over a method parameter or a value derived from one, so the "
         "captured tracer leaks into eager host execution — the "
         "callback engine's leaked-tracer bug class)", applies=False),
    Rule("UL204", "eager-jax-op-in-callback", "warning",
         _NOT_APPLICABLE +
         "(JAX package: a pure_callback/io_callback host function calls "
         "jax/jnp ops, each dispatched and first compiled eagerly per "
         "invocation)", applies=False),
    Rule("UL301", "retrace-budget-exceeded", "error",
         "a code path asserted to replay prepared work triggered new "
         "compile events: Triton JIT compiles, generated packed-kernel "
         "modules, nvcc builds or loads, or runner builds (reported by the "
         "runtime retrace sentinel, lint/retrace.py, not the static "
         "linter)"),
]}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: a rule instance anchored to a program/method."""

    rule: str                      # rule id, key into RULES
    program: str                   # VCProgram class name
    message: str                   # what is wrong, concretely
    method: Optional[str] = None   # offending method, when attributable
    fix: str = ""                  # actionable remediation
    location: str = ""             # "file:line" when resolvable
    severity: str = ""             # filled from RULES when empty

    def __str__(self) -> str:
        where = self.location or self.program
        meth = f".{self.method}" if self.method else ""
        out = (f"{where}: {self.rule} {self.severity}: "
               f"[{self.program}{meth}] {self.message}")
        if self.fix:
            out += f"\n    fix: {self.fix}"
        return out

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["title"] = RULES[self.rule].title
        return d


def finding(rule: str, program, message: str, **kw) -> Finding:
    """Build a Finding with the rule's default severity filled in.
    `program` may be a class, an instance, or a name string."""
    if not isinstance(program, str):
        cls = program if isinstance(program, type) else type(program)
        program = cls.__name__
    kw.setdefault("severity", RULES[rule].severity)
    return Finding(rule=rule, program=program, message=message, **kw)
