"""Typed findings + the checked-in suppression baseline (a copy of the
JAX package's `analysis/findings.py`).

A `Finding` is one rule violation at one `file:line`. Its `key` is
deliberately LINE-NUMBER-FREE — `rule::file::symbol` — so a checked-in
suppression survives unrelated edits to the file above it, and a
suppressed violation that MOVES (same symbol) stays suppressed while a
NEW violation (different symbol) in the same file still fails the gate.

The baseline file is the explicit debt ledger: every entry carries a
mandatory human-written `reason` (an entry without one is a config
error, exit 2 — suppressions must never be silent), and entries that no
longer match any finding are reported as STALE so paid-down debt gets
deleted instead of rotting.

Stdlib-only, like everything in this package: the analyzer must run as
a pre-test gate with no torch (or even numpy) import.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str        # rule id, e.g. "jit-purity"
    path: str        # repo-relative, forward slashes
    line: int        # 1-indexed
    symbol: str      # stable anchor: "Class.method" / "func" / name
    message: str     # human sentence, pinpointing

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.symbol}"

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "key": self.key}

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message} "
                f"(key: {self.key})")


class BaselineError(ValueError):
    """Malformed baseline file — a CONFIG error (exit 2), never a
    finding: a broken suppression ledger must not silently un-suppress
    (gate goes red for the wrong reason) or over-suppress."""


def load_baseline(path: str) -> Dict[str, str]:
    """{finding key: reason}. Missing file = empty baseline (a repo
    with zero accepted debt needs no file). Every entry must carry a
    non-empty reason string."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {}
    except ValueError as e:
        raise BaselineError(f"{path}: not JSON: {e}") from None
    if not isinstance(raw, dict) or raw.get("v") != BASELINE_VERSION:
        raise BaselineError(
            f"{path}: expected {{'v': {BASELINE_VERSION}, "
            f"'suppressions': [...]}}, got {type(raw).__name__} "
            f"v={raw.get('v') if isinstance(raw, dict) else None!r}")
    entries = raw.get("suppressions")
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: 'suppressions' must be a list")
    out: Dict[str, str] = {}
    for i, ent in enumerate(entries):
        if not isinstance(ent, dict):
            raise BaselineError(f"{path}: suppression #{i} is not an "
                                "object")
        key, reason = ent.get("key"), ent.get("reason")
        if not isinstance(key, str) or "::" not in key:
            raise BaselineError(
                f"{path}: suppression #{i}: 'key' must be a "
                f"'rule::file::symbol' string, got {key!r}")
        if not isinstance(reason, str) or not reason.strip():
            raise BaselineError(
                f"{path}: suppression #{i} ({key}): every suppression "
                "must carry a non-empty human 'reason'")
        if key in out:
            raise BaselineError(f"{path}: duplicate suppression {key}")
        out[key] = reason
    return out


def save_baseline(path: str, entries: Dict[str, str]) -> None:
    doc = {"v": BASELINE_VERSION,
           "suppressions": [{"key": k, "reason": entries[k]}
                            for k in sorted(entries)]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")


def split_by_baseline(
    findings: List[Finding], baseline: Dict[str, str],
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """(new, suppressed, stale_keys): `new` fails the gate, `suppressed`
    matched a baseline entry, `stale_keys` are baseline entries that
    matched nothing (debt already paid — delete them)."""
    new: List[Finding] = []
    suppressed: List[Finding] = []
    hit: set = set()
    for f in findings:
        if f.key in baseline:
            suppressed.append(f)
            hit.add(f.key)
        else:
            new.append(f)
    stale = sorted(set(baseline) - hit)
    return new, suppressed, stale


def report_dict(new: List[Finding], suppressed: List[Finding],
                stale: List[str], baseline: Dict[str, str],
                rules_run: List[str],
                errors: Optional[List[str]] = None) -> Dict[str, Any]:
    """The `pbt check --json` artifact. `check_findings_total` counts
    new + suppressed — the series a findings trajectory fits, so
    suppression creep moves the trajectory even while the gate is
    green."""
    return {
        "v": 1,
        "kind": "pbt_check_report",
        "rules": sorted(rules_run),
        "findings": [f.to_dict() for f in new],
        "baselined": [dict(f.to_dict(), reason=baseline.get(f.key, ""))
                      for f in suppressed],
        "stale_baseline": stale,
        "counts": {
            "new": len(new),
            "baselined": len(suppressed),
            "stale_baseline": len(stale),
            "check_findings_total": len(new) + len(suppressed),
        },
        "errors": list(errors or []),
        "ok": not new and not (errors or []),
    }
