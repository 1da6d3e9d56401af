"""Rule 4 — `event-schema`: every emit call site checked statically.

`obs/events.EVENT_FIELDS` is the runtime schema's single source of
truth, but until now an emitter drifting from it (unknown event name,
missing required field, wrongly-typed literal) surfaced only when the
record was actually emitted — and the never-raises telemetry contract
means it surfaced as a dropped record, not a failure. This rule moves
the check to lint time: every `*.emit("<literal>", k=v, ...)` in the
scanned tree is validated against the schema.

The schema is extracted by PARSING `events.py` (the dict literal is
read off the AST), never by importing it: importing the obs package
pulls the `proteinbert_tpu_torch` root, which imports torch — and the
`check` verb's analyzer must run torch-free as a pre-test gate. (A copy
of the JAX package's `analysis/schema_rule.py`.)

Checked per call site with a literal event name:
- the event type exists in EVENT_FIELDS;
- every required field is present as a keyword (skipped when the call
  spreads `**fields` — the analyzer never guesses at dynamic payloads);
- keyword values that are LITERALS type-check against the declared
  type (variables pass — runtime validation still backstops them).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple, Type

from proteinbert_tpu_torch.analysis.context import CheckContext, dotted
from proteinbert_tpu_torch.analysis.findings import Finding

RULE = "event-schema"

_TYPE_NAMES: Dict[str, type] = {
    "str": str, "int": int, "float": float, "dict": dict,
    "list": list, "bool": bool, "tuple": tuple,
}


class SchemaExtractionError(ValueError):
    pass


def extract_event_fields(source: str, filename: str,
                         ) -> Dict[str, Dict[str, Tuple[type, ...]]]:
    """{event: {field: accepted types}} parsed from the EVENT_FIELDS
    dict literal — raises SchemaExtractionError when the assignment is
    missing or not statically readable (the gate must go red, not
    silently check nothing)."""
    tree = ast.parse(source, filename=filename)
    target: Optional[ast.Dict] = None
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and \
                node.target.id == "EVENT_FIELDS" and \
                isinstance(node.value, ast.Dict):
            target = node.value
        elif isinstance(node, ast.Assign) and \
                any(isinstance(t, ast.Name) and t.id == "EVENT_FIELDS"
                    for t in node.targets) and \
                isinstance(node.value, ast.Dict):
            target = node.value
    if target is None:
        raise SchemaExtractionError(
            f"{filename}: no statically-readable EVENT_FIELDS dict")
    out: Dict[str, Dict[str, Tuple[type, ...]]] = {}
    for k, v in zip(target.keys, target.values):
        if not isinstance(k, ast.Constant) or not isinstance(k.value, str):
            raise SchemaExtractionError(
                f"{filename}: non-literal EVENT_FIELDS key "
                f"at line {getattr(k, 'lineno', '?')}")
        if not isinstance(v, ast.Dict):
            raise SchemaExtractionError(
                f"{filename}: EVENT_FIELDS[{k.value!r}] is not a dict "
                "literal")
        fields: Dict[str, Tuple[type, ...]] = {}
        for fk, fv in zip(v.keys, v.values):
            if not isinstance(fk, ast.Constant):
                raise SchemaExtractionError(
                    f"{filename}: non-literal field name in "
                    f"EVENT_FIELDS[{k.value!r}]")
            fields[fk.value] = _parse_types(fv, filename, k.value)
        out[k.value] = fields
    return out


def _parse_types(node: ast.AST, filename: str,
                 event: str) -> Tuple[type, ...]:
    names: List[ast.AST] = (list(node.elts)
                            if isinstance(node, ast.Tuple) else [node])
    types: List[type] = []
    for n in names:
        name = dotted(n)
        t = _TYPE_NAMES.get(name or "")
        if t is None:
            raise SchemaExtractionError(
                f"{filename}: EVENT_FIELDS[{event!r}] declares unknown "
                f"type {name!r}")
        types.append(t)
    return tuple(types)


def _literal_type(node: ast.AST) -> Optional[type]:
    """The python type of a literal keyword value; None = dynamic."""
    if isinstance(node, ast.Constant):
        return type(node.value)
    if isinstance(node, ast.Dict):
        return dict
    if isinstance(node, (ast.List, ast.ListComp)):
        return list
    if isinstance(node, ast.Tuple):
        return tuple
    if isinstance(node, ast.UnaryOp) and \
            isinstance(node.op, (ast.USub, ast.UAdd)) and \
            isinstance(node.operand, ast.Constant):
        return type(node.operand.value)
    return None


def check(ctx: CheckContext) -> List[Finding]:
    events_pf = ctx.load(ctx.cfg.events_py)
    if events_pf is None or events_pf.tree is None:
        ctx.errors.append(
            f"{ctx.cfg.events_py}: events schema source missing or "
            "unparseable — event-schema rule cannot run")
        return []
    try:
        schema = extract_event_fields(events_pf.source, events_pf.path)
    except SchemaExtractionError as e:
        ctx.errors.append(str(e))
        return []

    findings: List[Finding] = []
    for pf in ctx.files:
        if pf.tree is None or pf.path == ctx.cfg.events_py:
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            head = dotted(node.func)
            if head is None or head.rsplit(".", 1)[-1] != "emit":
                continue
            if not node.args or not isinstance(node.args[0], ast.Constant) \
                    or not isinstance(node.args[0].value, str):
                continue  # dynamic event name: runtime validation's job
            findings.extend(_check_call(pf.path, node, schema))
    return findings


def _check_call(path: str, node: ast.Call,
                schema: Dict[str, Dict[str, Tuple[type, ...]]],
                ) -> List[Finding]:
    event = node.args[0].value
    line = node.lineno
    out: List[Finding] = []
    if event not in schema:
        out.append(Finding(
            rule=RULE, path=path, line=line,
            symbol=f"emit:{event}:unknown-event",
            message=(f"emit of unknown event type {event!r} — not in "
                     "obs.events.EVENT_FIELDS (add it to the schema "
                     "with a make_example fixture, or fix the name)"),
        ))
        return out
    required = schema[event]
    kws = {kw.arg: kw.value for kw in node.keywords if kw.arg is not None}
    has_spread = any(kw.arg is None for kw in node.keywords)
    for field, types in required.items():
        if field not in kws:
            if not has_spread:
                out.append(Finding(
                    rule=RULE, path=path, line=line,
                    symbol=f"emit:{event}:missing:{field}",
                    message=(f"emit({event!r}) is missing required "
                             f"field {field!r} — the record would be "
                             "dropped by the never-raises writer at "
                             "runtime"),
                ))
            continue
        lit = _literal_type(kws[field])
        if lit is None:
            continue
        # bool is an int subclass but the runtime validator rejects it
        # for int-typed fields across the schema; mirror that.
        ok = lit in types or (lit is int and float in types)
        if lit is bool and bool not in types:
            ok = False
        if not ok:
            names = "/".join(t.__name__ for t in types)
            out.append(Finding(
                rule=RULE, path=path, line=line,
                symbol=f"emit:{event}:type:{field}",
                message=(f"emit({event!r}): field {field!r} literal is "
                         f"{lit.__name__}, schema requires {names}"),
            ))
    return out
