"""Rule 2 — `lock-discipline`: guarded attributes + static lock order.

The threaded layers (serve/scheduler, serve/fleet, obs) guard mutable
state with per-instance locks, but nothing enforced the pairing — the
unlocked `stats()`-path reads this rule was built to catch are silent
data races that only surface as flickering drill numbers. The registry
is declared IN THE SOURCE, next to the state it protects:

    self.accepted_total = 0     # guarded-by: _lock

declares that `self.accepted_total` may only be read or written inside
a lexical `with self._lock:` block (any method of the same class).
Exceptions are explicit, never inferred:

- `__init__` is exempt (construction is single-threaded by contract);
- a method whose CALLERS hold the lock declares it on its `def` line:
      def _transition(self, ...):  # lock-held: _lock

The second half is a static lock-ORDER check: within each function,
`with <lockA>:` regions that acquire `<lockB>` (directly, via a
module-local call whose body acquires it, or via a known external
acquirer like `.emit(...)` → the telemetry lock) contribute a lockA →
lockB edge; a cycle across the collected edges is a potential deadlock
and fails the gate. Lock identity is `Class._lockattr` (or
`module:name` for bare names); the known-acquirers table maps
`.emit(...)` to the shared telemetry lock — the one cross-module
acquisition this codebase actually has.

A copy of the JAX package's `analysis/locks.py`.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from proteinbert_tpu_torch.analysis.context import CheckContext, ParsedFile
from proteinbert_tpu_torch.analysis.findings import Finding

RULE = "lock-discipline"

# Method names that acquire a lock OUTSIDE the scanned module when
# called on any receiver. `.emit(...)` (EventLog/Telemetry) is the one
# real cross-module acquisition in this codebase; its lock never calls
# back out, so modeling it as a single leaf node is faithful.
KNOWN_EXTERNAL_ACQUIRERS: Dict[str, str] = {
    "emit": "obs.telemetry._lock",
}


def _lock_name(expr: ast.AST) -> Optional[str]:
    """The lock attribute/name acquired by a `with` item, if it looks
    like a lock (threading convention: name contains 'lock')."""
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return expr.attr if "lock" in expr.attr.lower() else None
    if isinstance(expr, ast.Name):
        return expr.id if "lock" in expr.id.lower() else None
    return None


class _ClassInfo:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.guarded: Dict[str, str] = {}   # attr -> lock attr


def _collect_classes(pf: ParsedFile) -> List[_ClassInfo]:
    out: List[_ClassInfo] = []
    if pf.tree is None:
        return out
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        ci = _ClassInfo(node)
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                lock = pf.guarded_by(sub.lineno)
                if lock is None:
                    continue
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        ci.guarded[t.attr] = lock
        if ci.guarded:
            out.append(ci)
    return out


class _LockRegionVisitor(ast.NodeVisitor):
    """Walk one method body tracking which declared locks are held
    lexically, flagging guarded-attribute touches outside them."""

    def __init__(self, pf: ParsedFile, cls: str, method: str,
                 guarded: Dict[str, str], held: Set[str]):
        self.pf = pf
        self.cls = cls
        self.method = method
        self.guarded = guarded
        self.held = set(held)
        self.findings: List[Finding] = []

    def visit_With(self, node: ast.With) -> None:
        acquired = [ln for item in node.items
                    if (ln := _lock_name(item.context_expr)) is not None]
        self.held.update(acquired)
        for stmt in node.body:
            self.visit(stmt)
        self.held.difference_update(acquired)
        # with-items themselves (the lock expression) need no check.

    # Nested defs get their own top-level walk via _method_findings
    # (a closure does not inherit the lexical lock region at CALL
    # time — it may run later, lock released).
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node) -> None:  # pragma: no cover
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self" \
                and node.attr in self.guarded:
            lock = self.guarded[node.attr]
            if lock not in self.held:
                access = ("write" if isinstance(node.ctx,
                                                (ast.Store, ast.Del))
                          else "read")
                self.findings.append(Finding(
                    rule=RULE, path=self.pf.path, line=node.lineno,
                    symbol=f"{self.cls}.{self.method}:{node.attr}",
                    message=(f"unlocked {access} of `self.{node.attr}` "
                             f"(declared guarded-by `{lock}`) in "
                             f"`{self.cls}.{self.method}` — wrap it in "
                             f"`with self.{lock}:` or mark the method "
                             f"`# lock-held: {lock}`"),
                ))
        self.generic_visit(node)


def _method_findings(pf: ParsedFile, ci: _ClassInfo) -> List[Finding]:
    out: List[Finding] = []
    for item in ci.node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # Walk the method and every CLOSURE inside it as separate
        # regions (a closure body runs with no lexical lock held).
        defs: List[ast.AST] = [item]
        for sub in ast.walk(item):
            if sub is not item and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.append(sub)
        for d in defs:
            name = d.name  # type: ignore[attr-defined]
            if d is item and name == "__init__":
                break  # constructor (and its closures) exempt
            held: Set[str] = set()
            held_decl = pf.lock_held(d.lineno)
            if held_decl is not None:
                held.add(held_decl)
            visitor = _LockRegionVisitor(
                pf, ci.node.name,
                name if d is item else f"{item.name}.{name}",
                ci.guarded, held)
            for stmt in d.body:  # type: ignore[attr-defined]
                visitor.visit(stmt)
            out.extend(visitor.findings)
    return out


# ------------------------------------------------------------ lock order

def _function_acquisitions(fn: ast.AST, lock_id) -> Set[str]:
    """Locks a function's body acquires: direct `with` items plus the
    known external acquirers it calls (so a helper that only emits
    still contributes the telemetry lock to its callers' regions)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                ln = _lock_name(item.context_expr)
                if ln is not None:
                    out.add(lock_id(ln))
        elif isinstance(node, ast.Call):
            callee = (node.func.attr if isinstance(node.func,
                                                   ast.Attribute)
                      else node.func.id if isinstance(node.func,
                                                      ast.Name)
                      else None)
            ext = KNOWN_EXTERNAL_ACQUIRERS.get(callee or "")
            if ext is not None:
                out.add(ext)
    return out


def _order_edges(pf: ParsedFile) -> Dict[Tuple[str, str], int]:
    """{(held lock, acquired lock): first line} across the file."""
    if pf.tree is None:
        return {}
    edges: Dict[Tuple[str, str], int] = {}

    # Map function/method names to their direct acquisitions so a call
    # under a held lock contributes its callee's locks (one level).
    fn_acquires: Dict[str, Set[str]] = {}
    classes: Dict[ast.AST, str] = {}
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    classes[sub] = node.name

    def lock_id_for(cls: Optional[str]):
        def lock_id(name: str) -> str:
            return f"{cls}.{name}" if cls else f"{pf.path}:{name}"
        return lock_id

    for node in ast.walk(pf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls = classes.get(node)
            fn_acquires.setdefault(node.name, set()).update(
                _function_acquisitions(node, lock_id_for(cls)))

    def walk_region(body, held: List[str], cls: Optional[str]) -> None:
        lock_id = lock_id_for(cls)
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # closures run later, outside the region
            if isinstance(node, ast.With):
                acquired = [lock_id(ln) for item in node.items
                            if (ln := _lock_name(item.context_expr))]
                for a in acquired:
                    for h in held:
                        if h != a:
                            edges.setdefault((h, a), node.lineno)
                walk_region(node.body, held + acquired, cls)
                continue
            if held:
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    callee = None
                    if isinstance(sub.func, ast.Name):
                        callee = sub.func.id
                    elif isinstance(sub.func, ast.Attribute):
                        callee = sub.func.attr
                    if callee is None:
                        continue
                    targets: Set[str] = set()
                    ext = KNOWN_EXTERNAL_ACQUIRERS.get(callee)
                    if ext is not None:
                        targets.add(ext)
                    targets |= fn_acquires.get(callee, set())
                    for a in targets:
                        for h in held:
                            if h != a:
                                edges.setdefault((h, a), sub.lineno)
            walk_region(list(ast.iter_child_nodes(node)), held, cls)

    for node in ast.walk(pf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            walk_region(node.body, [], classes.get(node))
    return edges


def _find_cycle(edges: Dict[Tuple[str, str], int]) -> Optional[List[str]]:
    graph: Dict[str, List[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, []).append(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(u: str) -> Optional[List[str]]:
        color[u] = GRAY
        stack.append(u)
        for v in graph.get(u, []):
            c = color.get(v, WHITE)
            if c == GRAY:
                return stack[stack.index(v):] + [v]
            if c == WHITE:
                cyc = dfs(v)
                if cyc is not None:
                    return cyc
        stack.pop()
        color[u] = BLACK
        return None

    for u in list(graph):
        if color.get(u, WHITE) == WHITE:
            cyc = dfs(u)
            if cyc is not None:
                return cyc
    return None


def check(ctx: CheckContext) -> List[Finding]:
    findings: List[Finding] = []
    all_edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for pf in ctx.files:
        if pf.tree is None:
            continue
        for ci in _collect_classes(pf):
            findings.extend(_method_findings(pf, ci))
        for edge, line in _order_edges(pf).items():
            all_edges.setdefault(edge, (pf.path, line))
    cyc = _find_cycle({e: 0 for e in all_edges})
    if cyc is not None:
        first = all_edges.get((cyc[0], cyc[1]), ("", 0))
        findings.append(Finding(
            rule=RULE, path=first[0] or "<multiple>", line=first[1] or 1,
            symbol="lock-order:" + "->".join(cyc),
            message=("inconsistent lock acquisition order (potential "
                     "deadlock): " + " -> ".join(cyc)
                     + " — acquire these locks in one global order"),
        ))
    return findings
