"""The port's VCProg linter (`repro_torch.lint`) held to the JAX
package's (`repro.lint`): every seeded mutant of tests/test_lint.py is
written in torch beside its JAX twin and both linters must fire the same
(rule, method, program) set; the built-in operators, a batched SSSP and
the multi-leaf record programs lint clean in both packages; UL201's
serving-bug fixtures, suppression, the knob, the `UniGPS(lint=...)`
integration (on the CPU), the CLI and a seeded sweep of well-formed
programs mirror the reference's tests.

The JAX twins are tests/test_lint.py's own classes, loaded from that
file, so the two suites cannot drift apart.
"""
import importlib.util
import inspect
import io
import json
import os
import pathlib
import subprocess
import sys
import warnings
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

pytest.importorskip("jax.numpy")  # the reference package needs jax

import repro  # noqa: E402
from repro.core import operators as rops  # noqa: E402
from repro.core import vcprog as rvc  # noqa: E402
from repro.core.graph import from_edges as rfrom_edges  # noqa: E402
from repro.lint import check_program as rcheck  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import vcprog as tvc  # noqa: E402
from repro_torch.core.graph import from_edges  # noqa: E402
from repro_torch.lint import (LintError, LintWarning, RULES,  # noqa: E402
                              check_program, resolve_lint_mode)
from repro_torch.lint.cli import main as lint_main  # noqa: E402

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent


def _load(name):
    """A test module of this directory under a private name (its tests are
    collected from its own file, not from here)."""
    spec = importlib.util.spec_from_file_location(
        f"_lint_twin_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load("test_lint")

# ---------------------------------------------------------------------------
# the torch twins of tests/test_lint.py's program and mutants (module
# level: locations are read from this file's source)
# ---------------------------------------------------------------------------

INF = 3.4e38


class GoodMin(tvc.VCProgram):
    monoid = "min"
    monotonic = "decreasing"
    lane_attrs = ("root",)

    def __init__(self, root=0):
        self.root = root

    def init_vertex(self, vid, out_degree, vprop):
        return {"d": torch.where(vid == self.root, 0.0, INF)}

    def empty_message(self):
        return {"d": INF}

    def merge_message(self, a, b):
        return {"d": torch.minimum(a["d"], b["d"])}

    def vertex_compute(self, prop, msg, it):
        new = torch.minimum(prop["d"], msg["d"])
        return {"d": new}, new < prop["d"]

    def emit_message(self, src, dst, src_prop, edge_prop):
        return src_prop["d"] < INF, {"d": src_prop["d"] + 1.0}


class CrashInit(GoodMin):                      # UL100
    def init_vertex(self, vid, out_degree, vprop):
        return {"d": vprop["no_such_prop"]}


class NotClosed(GoodMin):                      # UL101
    def vertex_compute(self, prop, msg, it):
        return {"d": prop["d"], "extra": torch.tensor(0.0)}, False


class DtypeDrift(GoodMin):                     # UL101 (dtype, not structure)
    def vertex_compute(self, prop, msg, it):
        return {"d": prop["d"].to(torch.int32)}, False


class OffSchemaEmit(GoodMin):                  # UL102
    def emit_message(self, src, dst, src_prop, edge_prop):
        return True, {"e": src_prop["d"]}


class SwappedEmit(GoodMin):                    # UL102 (pair swapped)
    def emit_message(self, src, dst, src_prop, edge_prop):
        return {"d": src_prop["d"] + 1.0}, src_prop["d"] < INF


class OffSchemaMerge(GoodMin):                 # UL102
    def merge_message(self, a, b):
        return {"d": torch.minimum(a["d"], b["d"]).to(torch.int32)}


class TypoMonoid(GoodMin):                     # UL103
    monoid = "mni"
    monotonic = None


class BadTableShape(GoodMin):                  # UL103 (table != record)
    monoid = {"d": "min", "ghost": "min"}
    monotonic = None


class BadIdentity(GoodMin):                    # UL104
    def empty_message(self):
        return {"d": 0.0}


class WrongNamedOp(GoodMin):                   # UL104 (merge != declared op)
    def merge_message(self, a, b):
        return {"d": torch.maximum(a["d"], b["d"])}


class ContradictsMonoid(GoodMin):              # UL105
    monoid = "max"
    monotonic = "decreasing"

    def empty_message(self):
        return {"d": -INF}

    def merge_message(self, a, b):
        return {"d": torch.maximum(a["d"], b["d"])}


class MatrixLeaf(GoodMin):                     # UL106
    monotonic = None

    def init_vertex(self, vid, out_degree, vprop):
        return {"d": torch.zeros((2, 3))}

    def empty_message(self):
        return {"d": torch.full((2, 3), INF)}

    def vertex_compute(self, prop, msg, it):
        return {"d": torch.minimum(prop["d"], msg["d"])}, False

    def emit_message(self, src, dst, src_prop, edge_prop):
        return True, {"d": src_prop["d"]}


class TracerBool(GoodMin):                     # UL202
    def vertex_compute(self, prop, msg, it):
        if msg["d"] < prop["d"]:
            return {"d": msg["d"]}, True
        return prop, False


class LeakyCallback(GoodMin):                  # JAX: UL203 + UL204
    def vertex_compute(self, prop, msg, it):
        def host():
            return np.asarray(torch.minimum(msg["d"], torch.tensor(0.0)))
        d = torch.as_tensor(host())
        return {"d": d}, False


class CleanCallback(GoodMin):                  # the host work kept in torch
    def vertex_compute(self, prop, msg, it):
        return {"d": torch.minimum(msg["d"], torch.tensor(0.0))}, False


MUTANTS = [
    (CrashInit, "UL100"),
    (NotClosed, "UL101"),
    (DtypeDrift, "UL101"),
    (OffSchemaEmit, "UL102"),
    (SwappedEmit, "UL102"),
    (OffSchemaMerge, "UL102"),
    (TypoMonoid, "UL103"),
    (BadTableShape, "UL103"),
    (BadIdentity, "UL104"),
    (WrongNamedOp, "UL104"),
    (ContradictsMonoid, "UL105"),
    (MatrixLeaf, "UL106"),
    (TracerBool, "UL202"),
]


def fired(findings):
    """The (rule, method, program) set of a finding list."""
    return {(f.rule, f.method, f.program) for f in findings}


def rules_of(findings):
    return sorted({f.rule for f in findings})


def test_mutant_lists_cover_the_reference():
    """Every mutant of tests/test_lint.py has its torch twin here, but
    LeakyCallback, whose rules do not apply in the port (tested below)."""
    ref = {c.__name__: r for c, r in J.MUTANTS}
    ours = {c.__name__: r for c, r in MUTANTS}
    assert ref.pop("LeakyCallback") == "UL203"
    assert ours == ref


def test_good_program_is_clean():
    assert check_program(GoodMin()) == []
    assert rcheck(J.GoodMin()) == []


@pytest.mark.parametrize("cls,rule", MUTANTS,
                         ids=[c.__name__ for c, _ in MUTANTS])
def test_mutant_fires_the_same_rules_as_its_jax_twin(cls, rule):
    ours = check_program(cls())
    ref = rcheck(getattr(J, cls.__name__)())
    assert rule in rules_of(ours), (cls.__name__, ours)
    assert fired(ours) == fired(ref), (fired(ours), fired(ref))
    for f in ours:
        assert f.fix or f.rule == "UL106", f"finding without fix: {f}"


def test_leaky_callback_is_a_crash_under_vmap_and_ul203_never_fires():
    """The JAX twin hands pure_callback a closure over a traced value
    (UL203, UL204). The port has no host callback: the same host read
    (np.asarray of a mapped tensor) raises under the engine's vmap, so
    the port reports UL100 on that method, and UL203/UL204 never fire."""
    assert rules_of(rcheck(J.LeakyCallback())) == ["UL203", "UL204"]
    ours = check_program(LeakyCallback())
    assert fired(ours) == {("UL100", "vertex_compute", "LeakyCallback")}
    assert not RULES["UL203"].applies and not RULES["UL204"].applies
    for cls, _ in MUTANTS + [(LeakyCallback, None), (CleanCallback, None)]:
        assert not {"UL203", "UL204"} & set(rules_of(check_program(cls())))


def test_clean_callback_twins_are_clean():
    assert rcheck(J.CleanCallback()) == []
    assert check_program(CleanCallback()) == []


def test_findings_carry_source_locations():
    """UL202 points at the user's `if` line, in both packages."""
    (f,) = [f for f in check_program(TracerBool()) if f.rule == "UL202"]
    src, first = inspect.getsourcelines(TracerBool.vertex_compute)
    line = first + next(i for i, s in enumerate(src) if "if msg" in s)
    assert f.location == f"{__file__}:{line}", f.location
    assert "torch.where" in f.fix
    (r,) = [r for r in rcheck(J.TracerBool()) if r.rule == "UL202"]
    assert "test_lint.py" in r.location


def test_escapes_are_classified_by_vmap_message():
    """int(), float() and .item() on a mapped value read as UL202, like
    `if`; other failures stay UL100."""
    class IntEscape(GoodMin):
        def emit_message(self, src, dst, src_prop, edge_prop):
            return True, {"d": src_prop["d"] + int(dst)}

    class ItemEscape(GoodMin):
        def init_vertex(self, vid, out_degree, vprop):
            return {"d": torch.tensor(float(vid.item()))}

    assert fired(check_program(IntEscape())) == {
        ("UL202", "emit_message", "IntEscape")}
    assert fired(check_program(ItemEscape())) == {
        ("UL202", "init_vertex", "ItemEscape")}


# ---------------------------------------------------------------------------
# dogfood: every built-in operator program lints clean, in both packages
# ---------------------------------------------------------------------------

BUILTINS = [
    ("PageRankProgram", (16, 3, 0.85)),
    ("SSSPProgram", (0,)),
    ("CCProgram", ()),
    ("BFSProgram", (0,)),
    ("DegreeProgram", ()),
    ("PersonalizedPageRankProgram", (16, 3, 0, 0.85)),
]


@pytest.mark.parametrize("name,args", BUILTINS, ids=[n for n, _ in BUILTINS])
def test_builtin_operators_lint_clean(name, args):
    assert check_program(getattr(tops, name)(*args)) == []
    assert rcheck(getattr(rops, name)(*args)) == []


def test_builtin_batched_lint_clean():
    assert check_program(tvc.as_batched(
        [tops.SSSPProgram(root=0), tops.SSSPProgram(root=5)])) == []
    assert rcheck(rvc.as_batched(
        [rops.SSSPProgram(root=0), rops.SSSPProgram(root=5)])) == []


@pytest.mark.parametrize("name", ["MixedStats", "UniformTriple", "VecStats"])
def test_multileaf_records_lint_clean(name):
    """Several leaves, per-leaf monoid dicts and [D] vector leaves (the
    packed kernel's record programs) lint clean in both packages."""
    t = getattr(_load("test_torch_multileaf"), name)
    r = getattr(_load("test_multileaf"), name)
    assert check_program(t()) == []
    assert rcheck(r()) == []


# ---------------------------------------------------------------------------
# UL201: the replayed-root serving regression fixture
# ---------------------------------------------------------------------------

def test_ul201_value_equal_attr_baked_raw_constructor():
    bad = tvc.BatchedProgram([tops.SSSPProgram(root=3)] * 2)
    assert "root" in bad.common_attrs
    (f,) = check_program(bad)
    assert f.rule == "UL201"
    assert "root" in f.message and "lane_attrs" in f.fix
    assert "as_batched" in f.fix
    assert "init_vertex" in f.message  # the graph the value was baked into
    (r,) = rcheck(rvc.BatchedProgram([rops.SSSPProgram(root=3)] * 2))
    assert fired([f]) == fired([r])


def test_ul201_silent_for_true_config_attrs():
    bp = tvc.BatchedProgram([tops.PageRankProgram(16, 3, 0.85)] * 2)
    assert check_program(bp) == []
    assert rcheck(rvc.BatchedProgram([rops.PageRankProgram(16, 3, 0.85)]
                                     * 2)) == []


def test_ul201_unconsumed_attr_is_silent():
    """A declared per-query attr that no method reads is harmless."""
    class Unread(GoodMin):
        lane_attrs = ("root", "tag")

        def __init__(self, root=0, tag=7):
            self.root, self.tag = root, tag

    bp = tvc.BatchedProgram([Unread(root=1), Unread(root=2)])
    assert "tag" in bp.common_attrs
    assert check_program(bp) == []


def test_as_batched_auto_forces_declared_lane_attrs():
    bp = tvc.as_batched([tops.SSSPProgram(root=3)] * 2)
    assert "root" in bp.lane_attr_names
    assert check_program(bp) == []


def test_serving_regression_equal_then_distinct_sources():
    g = from_edges([0, 1, 2, 3], [1, 2, 3, 0], 4)
    d, _ = tops.sssp(g, 0, 8, engine="pushpull", sources=[2, 2],
                     device="cpu")
    d2, _ = tops.sssp(g, 0, 8, engine="pushpull", sources=[2, 3],
                      device="cpu")
    np.testing.assert_array_equal(d[0], d2[0])
    assert not np.array_equal(d2[0], d2[1])
    rd, _ = rops.sssp(rfrom_edges([0, 1, 2, 3], [1, 2, 3, 0], 4), 0, 8,
                      engine="pushpull", sources=[2, 3])
    np.testing.assert_array_equal(d2, np.asarray(rd))


def test_query_attrs_parameter_flags_undeclared_attr():
    class NoDecl(GoodMin):
        lane_attrs = ()

    class RNoDecl(J.GoodMin):
        lane_attrs = ()

    bad = tvc.BatchedProgram([NoDecl(root=2)] * 2)
    assert check_program(bad) == []           # no declared intent: silent
    fs = check_program(bad, query_attrs=("root",))
    assert rules_of(fs) == ["UL201"]          # caller-declared intent
    ref = rcheck(rvc.BatchedProgram([RNoDecl(root=2)] * 2),
                 query_attrs=("root",))
    assert rules_of(ref) == ["UL201"]


# ---------------------------------------------------------------------------
# suppression + knob plumbing
# ---------------------------------------------------------------------------

def test_lint_suppress_filters_rule():
    class Suppressed(ContradictsMonoid):
        lint_suppress = ("UL105",)

    assert tvc.VCProgram.lint_suppress == ()
    assert check_program(Suppressed()) == []
    assert "UL105" in rules_of(check_program(ContradictsMonoid()))


def test_rules_whitelist():
    assert check_program(ContradictsMonoid(), rules=("UL101",)) == []
    assert rules_of(check_program(ContradictsMonoid(),
                                  rules=("UL105",))) == ["UL105"]


def test_resolve_lint_mode():
    assert resolve_lint_mode(None) == "warn"
    assert resolve_lint_mode("error") == "error"
    with pytest.raises(ValueError, match="lint must be one of"):
        resolve_lint_mode("loud")


def test_knob_errors_share_format():
    from repro_torch.core.message_plane import (resolve_frontier_mode,
                                                resolve_kernel_mode,
                                                resolve_prefetch_mode)
    from repro_torch.distributed.wire import resolve_exchange_mode
    for fn, knob in ((resolve_frontier_mode, "frontier"),
                     (resolve_kernel_mode, "kernel"),
                     (resolve_prefetch_mode, "prefetch"),
                     (resolve_exchange_mode, "exchange"),
                     (resolve_lint_mode, "lint")):
        with pytest.raises(ValueError,
                           match=rf"{knob} must be one of .*got 'bogus'"):
            fn("bogus")


def test_rule_catalog_mirrors_the_reference():
    from repro.lint import RULES as RRULES
    assert list(RULES) == list(RRULES)
    for rid, r in RULES.items():
        assert (r.title, r.severity) == (RRULES[rid].title,
                                         RRULES[rid].severity)
    assert [r for r in RULES if not RULES[r].applies] == ["UL203", "UL204"]


# ---------------------------------------------------------------------------
# UniGPS(lint=...) integration, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_graph():
    return from_edges([0, 1, 2], [1, 2, 0], 3)


def test_unigps_lint_error_raises(tiny_graph):
    u = repro_torch.UniGPS(engine="pushpull", lint="error", device="cpu")
    with pytest.raises(LintError) as ei:
        u.vcprog(tiny_graph, TracerBool(), max_iter=3)
    assert any(f.rule == "UL202" for f in ei.value.findings)


def test_unigps_lint_warn_default(tiny_graph):
    u = repro_torch.UniGPS(engine="pushpull", device="cpu")
    assert u.lint == "warn"
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with pytest.raises(Exception):       # the program is truly broken
            u.vcprog(tiny_graph, TracerBool(), max_iter=3)
    assert any(issubclass(w.category, LintWarning) for w in rec)


def test_unigps_lint_off_and_per_call_override(tiny_graph):
    u = repro_torch.UniGPS(engine="pushpull", lint="off", device="cpu")
    with pytest.raises(Exception) as ei:
        u.vcprog(tiny_graph, TracerBool(), max_iter=3)
    assert not isinstance(ei.value, LintError)
    with pytest.raises(LintError):
        u.vcprog(tiny_graph, TracerBool(), max_iter=3, lint="error")


def test_unigps_clean_program_runs_under_error(tiny_graph):
    u = repro_torch.UniGPS(engine="pushpull", lint="error", device="cpu")
    labels, info = u.vcprog(tiny_graph, tops.CCProgram(), max_iter=10)
    assert info["converged"]
    ref, _ = repro.UniGPS(engine="pushpull", lint="error").vcprog(
        rfrom_edges([0, 1, 2], [1, 2, 0], 3), rops.CCProgram(), max_iter=10)
    assert labels["label"].tolist() == np.asarray(ref["label"]).tolist()


def test_unigps_error_raises_before_the_run(tiny_graph, monkeypatch):
    """Under "error" nothing runs: the engine is never entered."""
    from repro_torch.core import api

    def no_run(*a, **k):
        raise AssertionError("the engine ran")

    monkeypatch.setattr(api, "run_vcprog", no_run)
    u = repro_torch.UniGPS(lint="error", device="cpu")
    with pytest.raises(LintError) as ei:
        u.vcprog(tiny_graph, DtypeDrift(), max_iter=3)
    assert rules_of(ei.value.findings) == ["UL101"]


def test_unigps_bad_lint_knob():
    with pytest.raises(ValueError, match="lint must be one of"):
        repro_torch.UniGPS(lint="nope", device="cpu")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _run_cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = lint_main(list(argv))
    return code, out.getvalue(), err.getvalue()


def test_cli_list_rules():
    code, out, _ = _run_cli("--list-rules")
    assert code == 0
    for rid in RULES:
        assert rid in out
    na = [ln.split()[0] for ln in out.splitlines()
          if "not applicable in the port" in ln and ln.startswith("UL")]
    assert na == ["UL203", "UL204"]
    code, out, _ = _run_cli("--list-rules", "--json")
    assert [r["id"] for r in json.loads(out)] == list(RULES)


def test_cli_clean_operators_file():
    code, out, _ = _run_cli("src/repro_torch/core/operators.py")
    assert code == 0
    assert "0 finding(s)" in out
    assert "linted 6 program(s)" in out


BAD_PROGRAM = (
    "import torch\n"
    "from repro_torch.core.vcprog import VCProgram\n"
    "class Bad(VCProgram):\n"
    "    monoid = 'mni'\n"
    "    def init_vertex(self, vid, out_degree, vprop):\n"
    "        return {'d': torch.tensor(0.0)}\n"
    "    def empty_message(self):\n"
    "        return {'d': torch.tensor(0.0)}\n"
    "    def merge_message(self, a, b):\n"
    "        return {'d': torch.minimum(a['d'], b['d'])}\n"
    "    def vertex_compute(self, prop, msg, it):\n"
    "        return prop, torch.tensor(False)\n"
    "    def emit_message(self, src, dst, src_prop, edge_prop):\n"
    "        return torch.tensor(True), {'d': src_prop['d']}\n")


def test_cli_bad_file(tmp_path):
    bad = tmp_path / "badprog.py"
    bad.write_text(BAD_PROGRAM)
    code, out, _ = _run_cli(str(bad))
    assert code == 0 and "UL103" in out       # findings but no --error
    code, out, _ = _run_cli(str(bad), "--error")
    assert code == 1
    code, out, _ = _run_cli(str(bad), "--json")
    rep = json.loads(out)
    assert "UL103" in [f["rule"] for f in rep["findings"]]
    assert all(f["program"] == "Bad" for f in rep["findings"])
    code, out, _ = _run_cli(str(bad), "--rules", "UL105", "--error")
    assert code == 0


def test_cli_unimportable_file(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("this is not python ][\n")
    code, _, err = _run_cli(str(p))
    assert code == 2
    assert "could not import" in err


def test_cli_uninstantiable_class_is_skip_not_error(tmp_path):
    p = tmp_path / "needs_arg.py"
    p.write_text(
        "from repro_torch.core.vcprog import VCProgram\n"
        "class NeedsExotic(VCProgram):\n"
        "    def __init__(self, mystery_thing):\n"
        "        self.mystery_thing = mystery_thing\n")
    code, out, _ = _run_cli(str(p))
    assert code == 0
    assert "skipped NeedsExotic" in out


def test_cli_module_entry_point_imports_no_jax(tmp_path):
    """`python -m repro_torch.lint` in a fresh interpreter: the example
    programs lint clean, a finding under --error exits 1, and neither
    jax nor the JAX package is loaded."""
    bad = tmp_path / "badprog.py"
    bad.write_text(BAD_PROGRAM)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "HOME": str(tmp_path)}
    probe = ("import runpy, sys; sys.argv = ['lint'] + sys.argv[1:]; "
             "code = 0\n"
             "try:\n"
             "    runpy.run_module('repro_torch.lint', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    code = e.code\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'repro')]\n"
             "print('LOADED', bad); sys.exit(code)")
    good = subprocess.run(
        [sys.executable, "-c", probe, "examples/quickstart_torch.py",
         "examples/graph_analytics_torch.py", "--error"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert good.returncode == 0, good.stdout + good.stderr
    assert "LOADED []" in good.stdout and "0 finding(s)" in good.stdout
    failing = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", str(bad), "--error"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert failing.returncode == 1, failing.stdout + failing.stderr


# ---------------------------------------------------------------------------
# property test: random well-formed programs never produce findings, in
# either package
# ---------------------------------------------------------------------------

_IDENTITY = {"min": INF, "max": -INF, "sum": 0.0}
_OPS = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}


def _make_wellformed(monoid, nleaves, root, use_vec, vec_d):
    """tests/test_lint.py's well-formed program, in torch."""
    keys = [f"x{i}" for i in range(nleaves)]
    ident = _IDENTITY[monoid]
    op = _OPS[monoid]

    def rec(fill):
        return {k: (torch.full((vec_d,), fill) if use_vec and i == 0
                    else torch.tensor(fill, dtype=torch.float32))
                for i, k in enumerate(keys)}

    class RandomProgram(tvc.VCProgram):
        lane_attrs = ("root",)

        def __init__(self, root=0):
            self.root = root

        def init_vertex(self, vid, out_degree, vprop):
            return {k: torch.where(vid == self.root, v, v + 1.0)
                    for k, v in rec(0.0).items()}

        def empty_message(self):
            return rec(ident)

        def merge_message(self, a, b):
            return {k: op(a[k], b[k]) for k in a}

        def vertex_compute(self, prop, msg, it):
            new = ({k: op(prop[k], msg[k]) for k in prop}
                   if monoid != "sum" else prop)
            return new, False

        def emit_message(self, src, dst, src_prop, edge_prop):
            return True, src_prop

    RandomProgram.monoid = monoid
    return RandomProgram(root=root)


@pytest.mark.parametrize("seed", range(12))
def test_wellformed_programs_have_zero_findings(seed):
    """Zero false positives over randomized well-formed programs, with the
    reference's draws for each seed, in both packages."""
    rng = np.random.default_rng(seed)
    kw = dict(monoid=["min", "max", "sum"][int(rng.integers(3))],
              nleaves=int(rng.integers(1, 4)), root=int(rng.integers(8)),
              use_vec=bool(rng.integers(2)), vec_d=int(rng.integers(1, 5)))
    prog = _make_wellformed(**kw)
    assert check_program(prog) == [], kw
    assert check_program(tvc.as_batched([prog, prog])) == [], kw
    J._assert_wellformed_clean(**kw)
