"""tbx-check CLI for the port.

    python -m taboo_brittleness_tpu_torch.analysis [--deep] [--baseline FILE]
        [--write-baseline FILE] [--list-rules] [paths...]

Exit codes: 0 clean (every finding fixed, pragma-suppressed, or baselined),
1 unsuppressed findings, 2 usage/IO error.  The default path set is the
port's package; the gate runs it over ``taboo_brittleness_tpu_torch tests
chip_smoke.py`` (``tests/`` holds the JAX package's tests too: the static
rules scope themselves by path, and only the port's tests arm its faults).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional, Sequence

from taboo_brittleness_tpu_torch.analysis import baseline as baseline_mod
from taboo_brittleness_tpu_torch.analysis.core import Finding, analyze_file
from taboo_brittleness_tpu_torch.analysis.rules import (
    JAX_ONLY, RULES, RepoContext)

# The checker's own violation corpus: every file seeds exactly the hazard its
# rule must catch, so scanning it would fail the gate by design.
DEFAULT_EXCLUDES = ("tests/fixtures/analysis",)


@dataclasses.dataclass
class Report:
    findings: List[Finding]        # active (unsuppressed, unbaselined)
    suppressed: List[Finding]      # pragma'd out
    baselined: List[Finding]       # filtered by --baseline
    files_checked: int

    @property
    def clean(self) -> bool:
        return not self.findings


def _norm(path: str) -> str:
    return os.path.relpath(path).replace(os.sep, "/")


def iter_python_files(paths: Sequence[str],
                      default_excludes: bool = True) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs.sort()
                for name in sorted(names):
                    if name.endswith(".py"):
                        files.append(os.path.join(root, name))
        elif os.path.isfile(p):
            files.append(p)
        else:
            raise FileNotFoundError(p)
    out = []
    for f in files:
        rel = _norm(f)
        if default_excludes and any(ex in rel for ex in DEFAULT_EXCLUDES):
            continue
        if rel not in out:
            out.append(rel)
    return out


def run_check(paths: Sequence[str], *, deep: bool = False,
              conc: bool = True,
              baseline: Optional[str] = None,
              default_excludes: bool = True,
              rules=None) -> Report:
    """Programmatic entry point (``tests/test_torch_analysis.py`` uses
    this)."""
    files = iter_python_files(paths, default_excludes=default_excludes)
    repo = RepoContext.discover(files)
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in files:
        a, s = analyze_file(f, rel=_norm(f), rules=rules, repo=repo)
        active.extend(a)
        suppressed.extend(s)
    if conc:
        from taboo_brittleness_tpu_torch.analysis.conc import run_conc

        a, s = run_conc(files)
        active.extend(a)
        suppressed.extend(s)
    if deep:
        from taboo_brittleness_tpu_torch.analysis.deep import run_deep

        active.extend(run_deep())
    baselined: List[Finding] = []
    if baseline is not None:
        known = baseline_mod.load(baseline)
        active, baselined = baseline_mod.split(active, known)
    active.sort(key=lambda x: (x.path, x.line, x.col, x.code))
    return Report(findings=active, suppressed=suppressed,
                  baselined=baselined, files_checked=len(files))


def rule_table() -> List[str]:
    """The ``--list-rules`` lines: every code with its alias, the JAX-only
    codes with the reason they check nothing here."""
    from taboo_brittleness_tpu_torch.analysis.conc import CONC_RULES

    lines = [f"{rule.code}  {rule.alias:<14} {rule.summary}" for rule in RULES]
    lines += [f"{rule.code}  {rule.alias:<14} [JAX-only] {rule.summary} — "
              f"{rule.reason}" for rule in JAX_ONLY]
    lines += [f"{rule.code}  {rule.alias:<14} [--conc] {rule.summary}"
              for rule in CONC_RULES]
    lines += ["TBX100  deep-entry     [--deep] entry point failed to run",
              "TBX101  deep-f32       [--deep] widening f32 conversion on a "
              "vocab-carrying tensor"]
    return sorted(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m taboo_brittleness_tpu_torch.analysis",
        description="tbx-check for the port: static analysis gate "
                    "(rules TBX001..TBX010 plus the whole-program "
                    "host-concurrency pass TBX201..TBX206; --deep adds "
                    "the dispatch-level pass over the registered entry "
                    "points).")
    ap.add_argument("paths", nargs="*", default=["taboo_brittleness_tpu_torch"],
                    help="files or directories (default: the port's package)")
    ap.add_argument("--deep", action="store_true",
                    help="also run the registered entry points eagerly on "
                         "the CPU at a tiny config and audit their "
                         "dispatched ops for vocab-dim f32 materialization "
                         "(imports torch)")
    ap.add_argument("--conc", dest="conc", action="store_true", default=True,
                    help="run the whole-program host-concurrency pass "
                         "(TBX201..TBX206); on by default")
    ap.add_argument("--no-conc", dest="conc", action="store_false",
                    help="skip the concurrency pass (static AST rules only)")
    ap.add_argument("--baseline", metavar="FILE",
                    help="filter findings already recorded in FILE")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="record current findings to FILE and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--no-default-excludes", action="store_true",
                    help="also scan the checker's own violation corpus "
                         f"(default excludes: {', '.join(DEFAULT_EXCLUDES)})")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only the summary line")
    args = ap.parse_args(argv)

    if args.list_rules:
        for line in rule_table():
            print(line)  # tbx: TBX009-ok — the rule table is the CLI's stdout
        return 0

    try:
        report = run_check(
            args.paths, deep=args.deep, conc=args.conc,
            baseline=args.baseline,
            default_excludes=not args.no_default_excludes)
    except (FileNotFoundError, ValueError) as e:
        # tbx: TBX009-ok — the CLI's error line on stderr
        print(f"tbx-check: error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        n = baseline_mod.save(report.findings, args.write_baseline)
        # tbx: TBX009-ok — the CLI's result line
        print(f"tbx-check: wrote {n} fingerprint(s) to {args.write_baseline}")
        return 0

    if not args.quiet:
        for f in report.findings:
            print(f.format())  # tbx: TBX009-ok — the findings are the CLI's stdout
    # tbx: TBX009-ok — the CLI's summary line
    print(f"tbx-check: {report.files_checked} file(s), "
          f"{len(report.findings)} finding(s) "
          f"({len(report.suppressed)} suppressed, "
          f"{len(report.baselined)} baselined)")
    if report.findings and not args.quiet:
        # tbx: TBX009-ok — the CLI's hint on stderr
        print("  fix, suppress with `# tbx: <rule>-ok — <reason>`, or ratchet "
              "with --write-baseline/--baseline", file=sys.stderr)
    return 0 if report.clean else 1
