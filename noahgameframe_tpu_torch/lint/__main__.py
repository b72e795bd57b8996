"""CLI for the port's nf-lint: ``python -m noahgameframe_tpu_torch.lint``.

Exit status: 0 when every finding is suppressed or baselined, 1 when
any open finding remains, 2 on usage errors.  ``--update-baseline``
rewrites the baseline from the current open findings and exits 0.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import ALL_RULES, RULES_BY_NAME
from .engine import run_lint, write_baseline

_PKG_ROOT = Path(__file__).resolve().parent.parent
_DEFAULT_BASELINE = _PKG_ROOT.parent / "nf_lint_torch_baseline.json"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nf-lint-torch",
        description="static analysis for capture-safety, device syncs and "
                    "protocol contracts of the PyTorch port")
    p.add_argument("--root", type=Path, default=_PKG_ROOT,
                   help="directory to scan (default: the installed "
                        "noahgameframe_tpu_torch package)")
    p.add_argument("--rule", action="append", dest="rules", default=None,
                   metavar="NAME",
                   help="run only this rule (repeatable); see --list-rules")
    p.add_argument("--json", action="store_true",
                   help="emit the JSON findings report on stdout")
    p.add_argument("--baseline", type=Path, default=None,
                   help=f"baseline file (default: {_DEFAULT_BASELINE.name} "
                        "next to the package, when present)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from current open findings")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.name:24s} {cls.description}")
        return 0
    if args.rules:
        unknown = [r for r in args.rules if r not in RULES_BY_NAME]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2
    baseline = args.baseline
    if baseline is None and _DEFAULT_BASELINE.exists():
        baseline = _DEFAULT_BASELINE
    report = run_lint(args.root, rules=ALL_RULES, rule_filter=args.rules,
                      baseline_path=None if args.update_baseline
                      else baseline)

    if args.update_baseline:
        target = args.baseline or _DEFAULT_BASELINE
        write_baseline(target, report.open_findings)
        print(f"baseline updated: {target} "
              f"({len(report.open_findings)} finding(s))")
        return 0

    if args.json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        for f in sorted(report.findings,
                        key=lambda f: (f.path, f.line, f.rule)):
            tag = "" if f.status == "open" else f" [{f.status}]"
            print(f"{f.path}:{f.line}: [{f.rule}]{tag} {f.message}")
        for key in report.stale_baseline:
            print(f"stale baseline entry (fixed? run --update-baseline): "
                  f"{key}")
        open_n = len(report.open_findings)
        sup = sum(1 for f in report.findings if f.status == "suppressed")
        base = sum(1 for f in report.findings if f.status == "baselined")
        print(f"nf-lint: {open_n} open, {sup} suppressed, {base} "
              f"baselined ({len(report.rules)} rules)")
    return 1 if report.open_findings else 0


if __name__ == "__main__":
    sys.exit(main())
