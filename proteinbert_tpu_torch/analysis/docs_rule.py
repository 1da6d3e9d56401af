"""Rule 5 — `obs-doc-drift`: code and docs/observability.md in lockstep.

docs/observability.md is the operator contract: the event-schema table
and the metric-name catalog. Both halves have drifted in past reviews
(a new event lands, the table lags a PR). This rule makes the doc a
checked artifact:

- **events, both directions**: the backticked first-column names of
  the table rows in the "## Event schema" section must equal the keys
  of `EVENT_FIELDS` exactly — an undocumented event and a documented
  ghost both fail.
- **metrics, both directions**: every LITERAL instrument name
  registered in the scanned package (`counter/gauge/histogram/
  quantile_window/timer("name", ...)`, plus the `KernelPathCounter`
  shim's metric-name argument) must appear in the doc (as itself or
  inside a `{a,b,c}` brace set); and every backticked token in the
  "## Metric names" section that both LOOKS like a metric (snake_case,
  `{label=…}` stripped, brace sets expanded) and carries a Prometheus
  family suffix (`_total`, `_seconds`, `_bytes`, …) must be a
  registered name. The suffix requirement is what keeps event payload
  fields mentioned in the same prose (`bad_step`, `overlap_s`) from
  reading as ghost metrics. Names that are documented-as-removed
  history live in `cfg.docs_allow`.

Dynamic names (f-strings, `prefix + k`) are skipped — the rule checks
what it can prove, and the runtime registry remains the backstop.

A copy of the JAX package's `analysis/docs_rule.py`: the port keeps the
JAX event schema and checks the same doc.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from proteinbert_tpu_torch.analysis.context import CheckContext, dotted
from proteinbert_tpu_torch.analysis.findings import Finding
from proteinbert_tpu_torch.analysis.schema_rule import (
    SchemaExtractionError, extract_event_fields,
)

RULE = "obs-doc-drift"

_REGISTRY_METHODS = {"counter", "gauge", "histogram", "quantile_window",
                     "timer"}
# One backticked token: `serve_batch` / `slo_burn_rate{objective=}` /
# `serve_cache_{hits,misses}_total`.
_BACKTICK_RE = re.compile(r"`([^`\s]+)`")
_TABLE_EVENT_RE = re.compile(r"^\|\s*`([a-z][a-z0-9_]*)`\s*\|")
_METRIC_TOKEN_RE = re.compile(r"^[a-z][a-z0-9_]*$")
# Words that match the metric shape but are prose, not instruments.
_METRIC_STOPWORDS = {"snake_case", "pbt_", "label"}
# A doc token only counts as a metric CLAIM (reverse direction) when
# it carries a Prometheus-style family suffix; prose mentions of event
# payload fields share the snake_case shape but not the suffix.
_METRIC_SUFFIXES = ("_total", "_seconds", "_bytes", "_rate", "_count",
                    "_depth", "_occupancy", "_progress", "_hit_rate")


def _section(text: str, heading: str) -> str:
    """The body of one `## heading` section (to the next `## `)."""
    lines = text.splitlines()
    out: List[str] = []
    inside = False
    for ln in lines:
        if ln.startswith("## "):
            inside = ln[3:].strip().lower().startswith(heading.lower())
            continue
        if inside:
            out.append(ln)
    return "\n".join(out)


def _doc_events(text: str) -> Set[str]:
    out: Set[str] = set()
    for ln in _section(text, "Event schema").splitlines():
        m = _TABLE_EVENT_RE.match(ln.strip())
        if m:
            out.add(m.group(1))
    return out


def _expand_braces(token: str) -> Optional[List[str]]:
    """`a_{x,y}_b` → [a_x_b, a_y_b]; `a{label=…}` → [a]; plain → [a];
    None when the token is not metric-shaped after expansion."""
    m = re.match(r"^([a-z0-9_]*)\{([^{}]*)\}([a-z0-9_]*)$", token)
    if m:
        pre, inner, post = m.groups()
        if "=" in inner:          # label spec: strip it
            token = pre + post if (pre + post) else pre
            candidates = [token.rstrip("_")] if token else []
        else:                     # {a,b,c} expansion
            candidates = [pre + part + post
                          for part in inner.split(",") if part]
    else:
        candidates = [token]
    ok = [c for c in candidates if _METRIC_TOKEN_RE.match(c)
          and "_" in c and c not in _METRIC_STOPWORDS]
    return ok or None


def _doc_metrics(text: str) -> Dict[str, str]:
    """{metric name: the raw token it came from} over the Metric names
    section."""
    out: Dict[str, str] = {}
    for raw in _BACKTICK_RE.findall(_section(text, "Metric names")):
        expanded = _expand_braces(raw)
        if expanded is None:
            continue
        for name in expanded:
            out.setdefault(name, raw)
    return out


def _registered_metrics(ctx: CheckContext) -> Dict[str, Tuple[str, int]]:
    """{literal instrument name: (file, line)} across the scanned
    PACKAGE roots (tools/bench are deliberately excluded — their
    ad-hoc instruments are capture plumbing, not operator surface):
    registry-method calls plus the KernelPathCounter shim's
    metric-name argument."""
    pkg_roots = tuple(r.rstrip("/") + "/" for r in ctx.cfg.scan_roots
                      if not r.endswith(".py") and r != "tools")
    out: Dict[str, Tuple[str, int]] = {}
    for pf in ctx.files:
        if pf.tree is None or not pf.path.startswith(pkg_roots):
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            head = dotted(node.func)
            if head is None:
                continue
            tail = head.rsplit(".", 1)[-1]
            if tail in _REGISTRY_METHODS:
                arg_idx = 0
            elif tail == "KernelPathCounter":
                # The shared path-counter shim registers its metric
                # name dynamically; the literal lives at arg 1.
                arg_idx = 1
            else:
                continue
            if len(node.args) <= arg_idx or not isinstance(
                    node.args[arg_idx], ast.Constant):
                continue
            name = node.args[arg_idx].value
            if isinstance(name, str) and _METRIC_TOKEN_RE.match(name) \
                    and "_" in name:
                out.setdefault(name, (pf.path, node.lineno))
    return out


def check(ctx: CheckContext) -> List[Finding]:
    doc = ctx.read_text(ctx.cfg.docs_md)
    if doc is None:
        ctx.errors.append(f"{ctx.cfg.docs_md}: missing — obs-doc-drift "
                          "rule cannot run")
        return []
    events_pf = ctx.load(ctx.cfg.events_py)
    findings: List[Finding] = []
    allow = set(ctx.cfg.docs_allow)

    # ---- events, both directions -----------------------------------
    schema_events: Set[str] = set()
    if events_pf is not None and events_pf.tree is not None:
        try:
            schema_events = set(extract_event_fields(
                events_pf.source, events_pf.path))
        except SchemaExtractionError as e:
            ctx.errors.append(str(e))
    doc_events = _doc_events(doc)
    for ev in sorted(schema_events - doc_events):
        findings.append(Finding(
            rule=RULE, path=ctx.cfg.events_py,
            line=_line_of(events_pf, f'"{ev}"'),
            symbol=f"event-undocumented:{ev}",
            message=(f"event type {ev!r} is in EVENT_FIELDS but has no "
                     f"row in {ctx.cfg.docs_md}'s Event schema table"),
        ))
    for ev in sorted(doc_events - schema_events):
        findings.append(Finding(
            rule=RULE, path=ctx.cfg.docs_md, line=1,
            symbol=f"event-ghost:{ev}",
            message=(f"{ctx.cfg.docs_md} documents event {ev!r} which "
                     "is not in EVENT_FIELDS — stale doc or missing "
                     "schema entry"),
        ))

    # ---- metrics, both directions ----------------------------------
    registered = _registered_metrics(ctx)
    doc_metrics = _doc_metrics(doc)
    for name, (path, line) in sorted(registered.items()):
        if name in allow:
            continue
        # A plain substring anywhere in the doc counts, and so does
        # membership in a brace-expanded token
        # (`serve_cache_{hits,misses,evictions}_total`).
        if name not in doc and name not in doc_metrics:
            findings.append(Finding(
                rule=RULE, path=path, line=line,
                symbol=f"metric-undocumented:{name}",
                message=(f"metric {name!r} is registered in code but "
                         f"never mentioned in {ctx.cfg.docs_md}"),
            ))
    documented_names = set(registered)
    for name, raw in sorted(doc_metrics.items()):
        if name in allow or name in documented_names:
            continue
        if not name.endswith(_METRIC_SUFFIXES):
            continue  # prose/payload-field mention, not a metric claim
        # A documented family name may be a prefix of registered
        # series (e.g. `serve_latency` → serve_latency_seconds) or a
        # suffix variant exported by the registry (`_p50_s`, `_count`);
        # only flag names with no registered relative at all.
        if any(r.startswith(name) or name.startswith(r)
               for r in documented_names):
            continue
        findings.append(Finding(
            rule=RULE, path=ctx.cfg.docs_md, line=1,
            symbol=f"metric-ghost:{name}",
            message=(f"{ctx.cfg.docs_md} mentions metric {name!r} "
                     f"(token `{raw}`) which matches no registered "
                     "instrument name — stale doc, or register/allow "
                     "it"),
        ))
    return findings


def _line_of(pf, needle: str) -> int:
    if pf is None:
        return 1
    for i, ln in enumerate(pf.lines, start=1):
        if needle in ln:
            return i
    return 1
