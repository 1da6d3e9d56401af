"""The port's `check` — the project-invariant static analyzer.

Orchestrates the six rules over one shared parse of the tree, applies
the checked-in suppression baseline, and renders text or the JSON
artifact. Exit codes follow the validator-tool convention:

    0  no non-baselined findings (stale baseline entries warn only)
    1  new findings (the gate's failure)
    2  config/internal errors (broken baseline, unreadable schema,
       syntax error in a scanned file, a captured function that no
       longer resolves)

Entry points:
- `python -m proteinbert_tpu_torch check` (cli/main.py) — the operator
  verb, the same runner;
- `run_check(cfg)` — the library call fixture tests drive.

The JAX package's `analysis/runner.py` over the port's rules:
`graph-purity` in place of `jit-purity`, the baseline in the port's
package, and the report's `seconds` (the analysis's own wall time,
start-up excluded).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from proteinbert_tpu_torch.analysis import (
    docs_rule, durability, exports_rule, locks, purity, schema_rule,
)
from proteinbert_tpu_torch.analysis.context import CheckConfig, CheckContext
from proteinbert_tpu_torch.analysis.findings import (
    BaselineError, Finding, load_baseline, report_dict, save_baseline,
    split_by_baseline,
)

DEFAULT_BASELINE = "proteinbert_tpu_torch/analysis/check_baseline.json"

RULES = {
    purity.RULE: purity.check,
    locks.RULE: locks.check,
    durability.RULE: durability.check,
    schema_rule.RULE: schema_rule.check,
    docs_rule.RULE: docs_rule.check,
    exports_rule.RULE: exports_rule.check,
}


def run_check(cfg: CheckConfig,
              rules: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the selected rules; returns {"findings": [Finding...],
    "errors": [...], "rules": [...]} BEFORE baseline filtering (the
    caller owns suppression so fixture tests see raw findings)."""
    selected = list(RULES) if not rules else rules
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule(s) {unknown}; have "
                         f"{sorted(RULES)}")
    ctx = CheckContext(cfg)
    findings: List[Finding] = []
    # A scanned file that does not parse is itself a finding: the gate
    # must not silently skip whatever the syntax error hides.
    for pf in ctx.files:
        if pf.parse_error is not None:
            findings.append(Finding(
                rule="parse", path=pf.path, line=1,
                symbol="syntax-error",
                message=f"file does not parse: {pf.parse_error}"))
    for name in selected:
        findings.extend(RULES[name](ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))
    return {"findings": findings, "errors": list(ctx.errors),
            "rules": selected}


def main(argv: Optional[List[str]] = None,
         repo_root: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m proteinbert_tpu_torch check",
        description="project-invariant static analyzer (graph purity "
                    "and launch or raise, lock discipline, durability "
                    "protocol, event schema, doc drift, dead exports)")
    ap.add_argument("--root", default=repo_root or os.getcwd(),
                    help="tree to analyze (default: repo root)")
    ap.add_argument("--rule", action="append", metavar="NAME",
                    help=f"run only this rule (repeatable); one of "
                         f"{sorted(RULES)}")
    ap.add_argument("--baseline", default=None,
                    help="suppression baseline JSON (default: "
                         f"<root>/{DEFAULT_BASELINE})")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable report to stdout")
    ap.add_argument("--json-artifact", default=None, metavar="PATH",
                    help="ALSO write the JSON report here (the "
                         "bench-trajectory check_findings_total input)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write every current finding into the "
                         "baseline file (reasons stubbed for human "
                         "review) and exit 0")
    ap.add_argument("--events-jsonl", default=None, metavar="PATH",
                    help="mirror the counts as a note(kind="
                         "check_capture) event on this stream — the "
                         "trajectory sentinel's suppression-creep "
                         "series")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    cfg = CheckConfig(root=root)
    t0 = time.perf_counter()
    try:
        result = run_check(cfg, rules=args.rule)
    except ValueError as e:
        print(f"check: {e}", file=sys.stderr)
        return 2
    try:
        baseline = load_baseline(baseline_path)
    except BaselineError as e:
        print(f"check: {e}", file=sys.stderr)
        return 2

    findings = result["findings"]
    if args.write_baseline:
        if result["errors"]:
            for err in result["errors"]:
                print(f"CONFIG ERROR: {err}", file=sys.stderr)
            print("check: refusing to write a baseline while "
                  "config errors hide findings", file=sys.stderr)
            return 2
        # Syntax errors are never suppressible: a baselined parse
        # finding would let every rule silently skip that file forever.
        parse_findings = [f for f in findings if f.rule == "parse"]
        if parse_findings:
            for f in parse_findings:
                print(str(f), file=sys.stderr)
            print("check: fix the syntax error(s) above before "
                  "writing a baseline", file=sys.stderr)
            return 2
        entries = dict(baseline)
        for f in findings:
            entries.setdefault(
                f.key, "UNREVIEWED (added by --write-baseline; "
                       "justify or fix)")
        save_baseline(baseline_path, entries)
        print(f"wrote {len(entries)} suppression(s) to {baseline_path}")
        return 0

    new, suppressed, stale = split_by_baseline(findings, baseline)
    report = report_dict(new, suppressed, stale, baseline,
                         result["rules"], errors=result["errors"])
    report["seconds"] = round(time.perf_counter() - t0, 6)
    if args.events_jsonl:
        # obs.events is stdlib-only, so this stays torch-free under a
        # stub parent package.
        from proteinbert_tpu_torch.obs.events import EventLog

        ev = EventLog(args.events_jsonl)
        # platform="static" keys the same trajectory series
        # ("check_findings_total/static") as the JAX package's checks.
        ev.emit("note", source="pbt_check", kind="check_capture",
                platform="static",
                check_findings_total=report["counts"][
                    "check_findings_total"],
                check_baselined_total=report["counts"]["baselined"])
        ev.close()
    if args.json_artifact:
        with open(args.json_artifact, "w") as f:
            json.dump(report, f, indent=1)
    if args.json:
        json.dump(report, sys.stdout, indent=1)
        print()
    else:
        for f in new:
            print(str(f))
        for f in suppressed:
            print(f"baselined: {f} — {baseline.get(f.key)}")
        for key in stale:
            print(f"STALE baseline entry (matched nothing — delete "
                  f"it): {key}")
        for err in result["errors"]:
            print(f"CONFIG ERROR: {err}", file=sys.stderr)
        print(f"check: {len(new)} finding(s), "
              f"{len(suppressed)} baselined, {len(stale)} stale "
              f"baseline entr{'y' if len(stale) == 1 else 'ies'}, "
              f"{len(result['errors'])} error(s) "
              f"[rules: {', '.join(result['rules'])}]")
    if result["errors"]:
        return 2
    return 1 if new else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
