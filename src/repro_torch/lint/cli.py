"""`python -m repro_torch.lint` — lint VCProgram classes found in Python
files.

    python -m repro_torch.lint src/repro_torch/core/operators.py examples/
    python -m repro_torch.lint --list-rules
    python -m repro_torch.lint examples/ --json
    python -m repro_torch.lint src/repro_torch/core/operators.py \
        examples/quickstart_torch.py --error

Each path (file or directory, recursively *.py) is imported as a
module; every VCProgram subclass *defined in* that module is
instantiated with heuristic constructor arguments (known parameter
names like root/source/num_vertices get sensible values; everything
else its default, or 1/1.0 by annotation) and run through
:func:`repro_torch.lint.check_program`. A module may pin the exact
instances to lint by exporting a ``LINT_PROGRAMS`` list — classes the
heuristics cannot instantiate are reported as skips, not findings. The
methods run on the CPU, even where a card is present.

Exit status: 0 = clean, 1 = findings and --error given, 2 = a path
could not be imported at all.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import traceback

from ..core.vcprog import BatchedProgram, VCProgram
from . import check_program
from .rules import RULES

__all__ = ["main"]

#: constructor-argument heuristics by parameter name (checked in order,
#: substring match) — enough to build every built-in operator program
_ARG_HEURISTICS = (
    (("root", "source", "src", "seed", "target"), 0),
    (("num_vertices", "n_vertices", "num_nodes"), 16),
    (("num_iters", "max_iter", "iters", "rounds"), 3),
    (("damping", "alpha"), 0.85),
    (("weight", "scale", "tol"), 1.0),
)


def _collect_files(paths) -> list:
    files = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in sorted(os.walk(p)):
                files += sorted(os.path.join(root, n) for n in names
                                if n.endswith(".py")
                                and not n.startswith("_"))
        else:
            files.append(p)
    return files


def _import_file(path: str, idx: int):
    """Import a target file. Files inside a package (an `__init__.py`
    chain) import by their dotted name so relative imports work;
    standalone scripts import from their location."""
    path = os.path.abspath(path)
    pkg_dir = os.path.dirname(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    while os.path.exists(os.path.join(pkg_dir, "__init__.py")):
        parts.insert(0, os.path.basename(pkg_dir))
        pkg_dir = os.path.dirname(pkg_dir)
    if len(parts) > 1:
        if pkg_dir not in sys.path:
            sys.path.insert(0, pkg_dir)
        return importlib.import_module(".".join(parts))
    name = f"_repro_torch_lint_target_{idx}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _heuristic_value(pname: str, param):
    if param.default is not inspect.Parameter.empty:
        return param.default
    for keys, val in _ARG_HEURISTICS:
        if any(k in pname for k in keys):
            return val
    ann = param.annotation
    if ann in (float, "float"):
        return 1.0
    if ann in (int, "int"):
        return 1
    raise TypeError(f"no heuristic for constructor arg {pname!r}")


def _instantiate(cls):
    sig = inspect.signature(cls.__init__)
    kwargs = {}
    for pname, param in list(sig.parameters.items())[1:]:  # skip self
        if param.kind in (inspect.Parameter.VAR_POSITIONAL,
                          inspect.Parameter.VAR_KEYWORD):
            continue
        kwargs[pname] = _heuristic_value(pname, param)
    return cls(**kwargs)


def _module_programs(mod):
    """(instances, skips) of VCProgram classes defined in this module."""
    pinned = getattr(mod, "LINT_PROGRAMS", None)
    if pinned is not None:
        return list(pinned), []
    progs, skips = [], []
    for name, obj in sorted(vars(mod).items()):
        if not (isinstance(obj, type) and issubclass(obj, VCProgram)
                and obj not in (VCProgram, BatchedProgram)
                and obj.__module__ == mod.__name__):
            continue
        try:
            progs.append(_instantiate(obj))
        except Exception as e:  # noqa: BLE001 — report as a skip
            skips.append((name, f"{type(e).__name__}: {e}"))
    return progs, skips


def _list_rules(as_json: bool) -> int:
    if as_json:
        print(json.dumps([r._asdict() for r in RULES.values()], indent=2))
        return 0
    for r in RULES.values():
        na = "" if r.applies else "  (not applicable in the port)"
        print(f"{r.id}  {r.severity:7s}  {r.title}{na}")
        print(f"       {r.summary}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static analyzer for UniGPS VCProgram classes on "
                    "PyTorch (rule catalog: --list-rules)")
    ap.add_argument("paths", nargs="*",
                    help="Python files or directories to lint")
    ap.add_argument("--error", action="store_true",
                    help="exit 1 when any finding is reported")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to check "
                         "(default: all)")
    args = ap.parse_args(argv)

    if args.list_rules:
        return _list_rules(args.as_json)
    if not args.paths:
        ap.error("no paths given (or use --list-rules)")

    rules = None
    if args.rules:
        rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            ap.error(f"unknown rule id(s) {unknown} — see --list-rules")

    report = {"files": [], "findings": [], "skipped": [], "errors": []}
    for idx, path in enumerate(_collect_files(args.paths)):
        try:
            mod = _import_file(path, idx)
        except Exception:  # noqa: BLE001 — an unimportable target file
            report["errors"].append(
                {"file": path, "traceback": traceback.format_exc()})
            continue
        progs, skips = _module_programs(mod)
        report["files"].append(
            {"file": path, "programs": [type(p).__name__ for p in progs]})
        for name, why in skips:
            report["skipped"].append({"file": path, "program": name,
                                      "reason": why})
        for prog in progs:
            for f in check_program(prog, rules=rules):
                d = f.to_dict()
                d["file"] = path
                report["findings"].append(d)

    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        for e in report["errors"]:
            print(f"ERROR: could not import {e['file']}:\n"
                  f"{e['traceback']}", file=sys.stderr)
        for s in report["skipped"]:
            print(f"note: skipped {s['program']} in {s['file']} "
                  f"({s['reason']})")
        nprogs = sum(len(f["programs"]) for f in report["files"])
        for d in report["findings"]:
            print(f"{d['location'] or d['file']}: {d['rule']} "
                  f"{d['severity']}: [{d['program']}"
                  f"{'.' + d['method'] if d['method'] else ''}] "
                  f"{d['message']}")
            if d["fix"]:
                print(f"    fix: {d['fix']}")
        print(f"linted {nprogs} program(s) in {len(report['files'])} "
              f"file(s): {len(report['findings'])} finding(s)")

    if report["errors"]:
        return 2
    if report["findings"] and args.error:
        return 1
    return 0
