"""Rule 6 — `dead-export`: package `__init__.py` names nobody uses.

Every package `__init__.py` re-exports its public surface (plus
`__all__`). Exports rot: a refactor moves the last caller and the
re-export lingers, advertising API that nothing exercises and that no
test would catch breaking. This rule flags any exported name that is
referenced NOWHERE else in the repo — not in the package, not in
tests/chip_smoke.py. (A copy of the JAX package's
`analysis/exports_rule.py`.)

Matching is identifier-based and deliberately coarse (any `Name`,
`Attribute` attr, or import of the same identifier anywhere counts as
a use): the rule must never flag a live name; a dead one that shares
its identifier with something alive simply stays below the radar.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from proteinbert_tpu_torch.analysis.context import CheckContext
from proteinbert_tpu_torch.analysis.findings import Finding

RULE = "dead-export"

_DUNDER = ("__version__", "__all__")


def _exported_names(tree: ast.AST) -> Dict[str, int]:
    """{name: line} exported by one __init__: the literal __all__ when
    present, else every top-level import alias."""
    all_node = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            all_node = node
    out: Dict[str, int] = {}
    if all_node is not None and isinstance(all_node.value,
                                           (ast.List, ast.Tuple)):
        for elt in all_node.value.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value,
                                                            str):
                out[elt.value] = elt.lineno
        return out
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                if not name.startswith("_"):
                    out[name] = node.lineno
    return out


def check(ctx: CheckContext) -> List[Finding]:
    index = ctx.identifier_index()
    findings: List[Finding] = []
    for pf in ctx.files:
        if pf.tree is None or not pf.path.endswith("/__init__.py"):
            continue
        exported = _exported_names(pf.tree)
        if not exported:
            continue
        used: Set[str] = set()
        for rel, ids in index.items():
            if rel == pf.path:
                continue
            used |= ids & set(exported)
        for name in sorted(set(exported) - used):
            if name in _DUNDER:
                continue
            findings.append(Finding(
                rule=RULE, path=pf.path, line=exported[name],
                symbol=f"export:{name}",
                message=(f"`{name}` is exported from {pf.path} but "
                         "referenced nowhere else in the repo — drop "
                         "the re-export (and __all__ entry) or add the "
                         "missing consumer/test"),
            ))
    return findings
