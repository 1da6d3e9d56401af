"""Rule 1 — `graph-purity`: no host state frozen into a CUDA graph, and
launch or raise in the kernel wrappers.

The port's counterpart of the JAX package's `jit-purity`. The port has no
jit: its trace time is CUDA-graph capture. A served shape is one CUDA
graph (`serve/dispatch.WarmShape`), captured over one call of a batch
function; host code inside that call runs ONCE, at capture, and every
replay reuses whatever it read then. So the functions a capture runs
must not

- read a host clock (`time.time` / `perf_counter` / `monotonic`),
- draw host randomness (`random.*`, `np.random.*` — torch's device
  generators are fine: they are captured as device work),
- read the environment (`os.environ` / `os.getenv`) outside the
  sanctioned readers (`cfg.sanctioned_env_readers`), or
- declare `global` (a module global mutated at capture changes once, not
  per replay).

Roots, where the JAX rule had `jit` / `shard_map` / `pallas_call`:

- **captured bodies**: the body of every `with torch.cuda.graph(...)`
  block, and the batch functions the dispatchers hand to `WarmShape`
  (`cfg.captured_functions`, "path:qualname" — the dispatchers pass them
  as a parameter, which no name-based resolution can follow). A
  configured name that no longer resolves is a config error;
- **kernel wrappers**: every function under `cfg.kernel_roots` that
  reaches a `<kernel>.launch(...)` call (`kernels/build.Kernel.launch`),
  by calling or naming (`run = _attention_launch`) a function that
  does — the counterpart of a function holding a `pallas_call`.

The kernel wrappers are also held to the port's ground rule, launch or
raise: on a CUDA tensor a wrapper launches its kernel or raises, and
never falls back to the kernel's plain PyTorch version (`*_reference`).
In a wrapper

- an `except` handler must end in `raise` (no `return`, no swallowing),
  and must not name a plain version (**except-swallows**,
  **except-plain**);
- a plain version may be named only under a CPU device test:
  `<t>.device.type == "cpu"` (or `!= "cpu"`'s else branch), or a call
  of a predicate whose body answers `True` under such a test
  (`kernels/fused_block._device_check`). Passed as an argument, it must
  go to a parameter the callee itself names only under a CPU device test
  (`kernels/quant_leaves.int8_leg`'s `plain`), or to `recompute_vjp`'s
  backward slot (`_PLAIN_SLOTS`) (**plain-route**). A route test guards it
  too: `path == "reference"` (or `!= "pallas"`'s body, `== "pallas"`'s
  else branch) where `path` was bound from a call of a `*_route` function
  (`kernels/one_pass.onepass_route` and its kin) — a decision from the
  shape alone, the same on every device, never from a failed launch.

Reachability is name-based, as in the JAX rule, and follows imports
across the scanned modules: `f(x)` resolves to a module-level `def f` of
its module or of the scanned module it was imported from, `mod.f(x)` to
`f` of an imported scanned module, and `self.m()` to a method of the
lexically enclosing class. Calls on other receivers (`kernel.launch`,
`k.start_build`) are not followed.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from proteinbert_tpu_torch.analysis.context import (
    CheckContext, ParsedFile, dotted,
)
from proteinbert_tpu_torch.analysis.findings import Finding

RULE = "graph-purity"

_CLOCK_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
                "time.monotonic_ns", "time.time_ns",
                "time.perf_counter_ns"}
_GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}
_LAUNCH_ATTR = "launch"
_PLAIN_SUFFIX = "_reference"
# A call of a function with this suffix returns the route decision,
# (path, reason); `path == "reference"` guards the reference route.
_ROUTE_SUFFIX = "_route"
# "callee:index" argument slots a kernel wrapper may fill with a plain
# version outside a CPU device test: `kernels/autograd.recompute_vjp`'s
# backward recomputes the plain version at the activation dtype on either
# device (the port's backward; the launch counts are forward-only).
_PLAIN_SLOTS = {"recompute_vjp:1"}


class _FnInfo:
    """One function/method definition (or a captured `with` body) and
    where it lives."""

    def __init__(self, node: ast.AST, cls: Optional[str], qual: str,
                 mod: "_Module") -> None:
        self.node = node
        self.cls = cls      # enclosing class name, if a method
        self.qual = qual    # "Class.method" or "func" (nesting flattened)
        self.mod = mod


class _Module:
    """One scanned file: its functions by name and method, and what its
    `from` imports bind (local name → (module dotted name, name)))."""

    def __init__(self, pf: ParsedFile, name: str) -> None:
        self.pf = pf
        self.name = name
        self.fns: List[_FnInfo] = []
        self.graph_bodies: List[_FnInfo] = []
        self.by_name: Dict[str, List[_FnInfo]] = {}
        self.top: Dict[str, _FnInfo] = {}
        self.by_method: Dict[Tuple[str, str], _FnInfo] = {}
        self.imports: Dict[str, Tuple[str, str]] = {}
        self.host_random = False
        self._collect(pf.tree, None, "", None)
        for fi in self.fns:
            self.by_name.setdefault(fi.node.name, []).append(fi)
            if fi.cls is not None:
                self.by_method[(fi.cls, fi.node.name)] = fi
        for node in pf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.top[node.name] = next(
                    fi for fi in self.fns if fi.node is node)
        self._read_imports(pf.tree)

    def _collect(self, node: ast.AST, cls: Optional[str], prefix: str,
                 owner: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                self.fns.append(_FnInfo(child, cls, qual, self))
                # Nested defs keep the class scope of their enclosing
                # method (self.x inside them still binds that class).
                self._collect(child, cls, f"{qual}.", qual)
            elif isinstance(child, ast.ClassDef):
                self._collect(child, child.name, f"{child.name}.", owner)
            else:
                if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                        isinstance(item.context_expr, ast.Call)
                        and dotted(item.context_expr.func)
                        in _GRAPH_CONTEXTS for item in child.items):
                    body = ast.Module(body=child.body, type_ignores=[])
                    self.graph_bodies.append(_FnInfo(
                        body, cls, f"{owner or '<module>'}:<graph>", self))
                self._collect(child, cls, prefix, owner)

    def _read_imports(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                self.host_random |= any(a.name == "random"
                                        for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (
                        node.module, alias.name)


class _Program:
    """Every scanned module, and name resolution across them."""

    def __init__(self, ctx: CheckContext) -> None:
        self.modules: Dict[str, _Module] = {}    # dotted name → module
        self.by_path: Dict[str, _Module] = {}
        for pf in ctx.files:
            if pf.tree is None:
                continue
            name = pf.path[:-3].replace("/", ".")
            if name.endswith(".__init__"):
                name = name[:-len(".__init__")]
            mod = _Module(pf, name)
            self.modules[name] = mod
            self.by_path[pf.path] = mod

    def functions(self) -> Iterator[_FnInfo]:
        for mod in self.modules.values():
            yield from mod.fns

    def _imported(self, mod: _Module, name: str,
                  depth: int = 0) -> Tuple[List[_FnInfo], Optional[_Module]]:
        """(the defs `name` is bound to in `mod` through its imports, the
        module it is bound to when it names a module)."""
        bound = mod.imports.get(name)
        if bound is None or depth > 3:
            return [], None
        base, attr = bound
        sub = self.modules.get(f"{base}.{attr}")
        if sub is not None:
            return [], sub
        target = self.modules.get(base)
        if target is None:
            return [], None
        if attr in target.top:
            return [target.top[attr]], None
        return self._imported(target, attr, depth + 1)

    def resolve(self, fi: _FnInfo, expr: ast.AST) -> List[_FnInfo]:
        """The functions a call target or a named reference resolves to."""
        mod = fi.mod
        if isinstance(expr, ast.Name):
            local = mod.by_name.get(expr.id)
            if local:
                return list(local)
            return self._imported(mod, expr.id)[0]
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name):
            if expr.value.id == "self":
                if fi.cls is None:
                    return []
                target = mod.by_method.get((fi.cls, expr.attr))
                return [target] if target is not None else []
            _, target_mod = self._imported(mod, expr.value.id)
            if target_mod is not None and expr.attr in target_mod.top:
                return [target_mod.top[expr.attr]]
        return []

    def find(self, spec: str) -> Optional[_FnInfo]:
        """The function a "path:qualname" names, or None."""
        path, _, qual = spec.partition(":")
        mod = self.by_path.get(path)
        if mod is None:
            return None
        return next((fi for fi in mod.fns if fi.qual == qual), None)


def _launch_wrappers(prog: _Program, kernel_roots: Tuple[str, ...]
                     ) -> List[_FnInfo]:
    """The functions under `kernel_roots` that reach a `.launch(...)`
    call by calling or naming a function that makes one."""
    dirs = tuple(r.rstrip("/") + "/" for r in kernel_roots)
    fns = [fi for fi in prog.functions()
           if fi.mod.pf.path.startswith(dirs)]
    reaching: Set[int] = set()
    refs: Dict[int, List[_FnInfo]] = {}
    for fi in fns:
        out: List[_FnInfo] = []
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and \
                    node.func.attr == _LAUNCH_ATTR and not (
                        isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"):
                reaching.add(id(fi.node))
            if isinstance(node, (ast.Name, ast.Attribute)) and \
                    isinstance(node.ctx, ast.Load):
                out.extend(prog.resolve(fi, node))
        refs[id(fi.node)] = out
    changed = True
    while changed:
        changed = False
        for fi in fns:
            if id(fi.node) not in reaching and any(
                    id(t.node) in reaching for t in refs[id(fi.node)]):
                reaching.add(id(fi.node))
                changed = True
    return [fi for fi in fns if id(fi.node) in reaching]


def graph_roots(ctx: CheckContext) -> List[Tuple[str, str, str]]:
    """(kind, path, qualname) of every root the rule resolves on the
    tree: "captured" (a configured batch function), "graph-body" (a
    `with torch.cuda.graph(...)` block) and "wrapper" (a launch-reaching
    kernel function). Unresolved configured names go to ctx.errors."""
    prog = _Program(ctx)
    return [(kind, fi.mod.pf.path, fi.qual)
            for kind, fi in _roots(prog, ctx)]


def _roots(prog: _Program, ctx: CheckContext
           ) -> List[Tuple[str, _FnInfo]]:
    out: List[Tuple[str, _FnInfo]] = []
    for spec in ctx.cfg.captured_functions:
        fi = prog.find(spec)
        if fi is None:
            ctx.errors.append(
                f"graph-purity: captured function {spec!r} does not "
                "resolve (renamed or moved? update "
                "CheckConfig.captured_functions)")
            continue
        out.append(("captured", fi))
    for mod in prog.modules.values():
        out.extend(("graph-body", fi) for fi in mod.graph_bodies)
    out.extend(("wrapper", fi)
               for fi in _launch_wrappers(prog, ctx.cfg.kernel_roots))
    return out


def _reachable(prog: _Program, roots: List[_FnInfo]) -> List[_FnInfo]:
    out: List[_FnInfo] = []
    seen: Set[int] = set()
    stack = list(roots)
    while stack:
        fi = stack.pop()
        if id(fi.node) in seen:
            continue
        seen.add(id(fi.node))
        out.append(fi)
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                stack.extend(prog.resolve(fi, node.func))
    return out


def check(ctx: CheckContext) -> List[Finding]:
    prog = _Program(ctx)
    roots = _roots(prog, ctx)
    findings: List[Finding] = []
    sanctioned = set(ctx.cfg.sanctioned_env_readers)
    for fi in _reachable(prog, [fi for _, fi in roots]):
        name = getattr(fi.node, "name", "<graph>")
        if name in sanctioned:
            continue
        findings.extend(_check_body(fi))
    predicates = _cpu_predicates(prog)
    for kind, fi in roots:
        if kind == "wrapper":
            findings.extend(_launch_or_raise(prog, fi, predicates))
    return findings


def _check_body(fi: _FnInfo) -> List[Finding]:
    out: List[Finding] = []
    pf = fi.mod.pf

    def flag(node: ast.AST, what: str) -> None:
        out.append(Finding(
            rule=RULE, path=pf.path, line=node.lineno,
            symbol=f"{fi.qual}:{what}",
            message=(f"{what} inside `{fi.qual}`, which runs while a CUDA "
                     "graph captures (a captured batch function, a "
                     "`torch.cuda.graph` body or a kernel wrapper) — host "
                     "state read/mutated once at capture and frozen into "
                     "every replay; hoist it out of the captured path or "
                     "use a sanctioned reader"),
        ))

    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name in _CLOCK_CALLS:
                flag(node, name)
            elif name is not None and fi.mod.host_random and \
                    name.startswith("random."):
                flag(node, name)
            elif name is not None and (name.startswith("np.random.")
                                       or name.startswith(
                                           "numpy.random.")):
                flag(node, name)
            elif name in ("os.getenv", "getenv"):
                flag(node, "os.getenv")
        elif isinstance(node, ast.Attribute) and node.attr == "environ":
            base = dotted(node)
            if base == "os.environ":
                flag(node, "os.environ")
        elif isinstance(node, ast.Global):
            flag(node, f"global {','.join(node.names)}")
    return out


# ------------------------------------------------------- launch or raise

def _cpu_test(expr: ast.AST, predicates: Set[str],
              route_vars: Set[str] = frozenset()) -> Optional[bool]:
    """True when `expr` holds only for a CPU tensor/device or the
    reference route, False when it holds only otherwise, None when it
    says neither."""
    if isinstance(expr, ast.Call):
        name = dotted(expr.func)
        if name is not None and name.rsplit(".", 1)[-1] in predicates:
            return True
        return None
    if isinstance(expr, ast.Compare) and len(expr.ops) == 1:
        left, right = expr.left, expr.comparators[0]
        if isinstance(left, ast.Constant):
            left, right = right, left
        if not isinstance(right, ast.Constant):
            return None
        if isinstance(left, ast.Name) and left.id in route_vars and \
                right.value in ("reference", "pallas"):
            holds = right.value == "reference"
        elif right.value == "cpu" and isinstance(left, ast.Attribute) \
                and left.attr == "type":
            holds = True
        else:
            return None
        if isinstance(expr.ops[0], ast.Eq):
            return holds
        if isinstance(expr.ops[0], ast.NotEq):
            return not holds
    return None


def _route_vars(root: ast.AST) -> Set[str]:
    """Names bound in `root` from a call of a `*_route` function: `path =
    f_route(...)` or `path, reason = f_route(...)` (the first name)."""
    out: Set[str] = set()
    for node in ast.walk(root):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)):
            continue
        callee = dotted(node.value.func)
        if callee is None or not callee.endswith(_ROUTE_SUFFIX):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Tuple) and target.elts:
            target = target.elts[0]
        if isinstance(target, ast.Name):
            out.add(target.id)
    return out


def _cpu_predicates(prog: _Program) -> Set[str]:
    """Names of the functions whose body answers `True` under a CPU
    device test (`if x.device.type == "cpu": return True`)."""
    out: Set[str] = set()
    for fi in prog.functions():
        for stmt in fi.node.body:
            if isinstance(stmt, ast.If) and _cpu_test(stmt.test,
                                                      set()) is True and \
                    any(isinstance(s, ast.Return)
                        and isinstance(s.value, ast.Constant)
                        and s.value.value is True for s in stmt.body):
                out.add(fi.node.name)
    return out


def _is_plain(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
            and node.id.endswith(_PLAIN_SUFFIX):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load) \
            and node.attr.endswith(_PLAIN_SUFFIX):
        return node.attr
    return None


def _uses(root: ast.AST, is_target, predicates: Set[str]
          ) -> Iterator[Tuple[ast.AST, str, bool, bool,
                              Optional[Tuple[ast.Call, object]]]]:
    """Every node of `root` that `is_target` names, as (node, name,
    under a CPU test or a reference-route test, inside an except handler,
    (the call, its slot) when the node is a direct argument of a
    call)."""
    route_vars = _route_vars(root)

    def visit(node, guarded, handler, arg_of):
        name = is_target(node)
        if name is not None:
            yield node, name, guarded, handler, arg_of
            return
        if isinstance(node, (ast.If, ast.IfExp)):
            pol = _cpu_test(node.test, predicates, route_vars)
            yield from visit(node.test, guarded, handler, None)
            body = node.body if isinstance(node.body, list) else [node.body]
            orelse = (node.orelse if isinstance(node.orelse, list)
                      else [node.orelse])
            for child in body:
                yield from visit(child, guarded or pol is True, handler,
                                 None)
            for child in orelse:
                yield from visit(child, guarded or pol is False, handler,
                                 None)
            return
        if isinstance(node, ast.ExceptHandler):
            for child in ast.iter_child_nodes(node):
                yield from visit(child, guarded, True, None)
            return
        if isinstance(node, ast.Call):
            yield from visit(node.func, guarded, handler, None)
            for i, arg in enumerate(node.args):
                yield from visit(arg, guarded, handler, (node, i))
            for kw in node.keywords:
                yield from visit(kw.value, guarded, handler,
                                 (node, kw.arg))
            return
        for child in ast.iter_child_nodes(node):
            yield from visit(child, guarded, handler, None)

    body = getattr(root, "body", [])
    for stmt in body if isinstance(body, list) else [body]:
        yield from visit(stmt, False, False, None)


def _param_guarded(fi: _FnInfo, slot, predicates: Set[str]) -> bool:
    """Whether the parameter of `fi` at `slot` (an index or a keyword) is
    named only under a CPU device test in its body."""
    params = [a.arg for a in fi.node.args.args]
    if isinstance(slot, int):
        if slot >= len(params):
            return False
        param = params[slot]
    elif slot in params:
        param = slot
    else:
        return False

    def is_param(node):
        return (param if isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load) and node.id == param
                else None)

    return all(guarded for _, _, guarded, _, _ in
               _uses(fi.node, is_param, predicates))


def _launch_or_raise(prog: _Program, fi: _FnInfo,
                     predicates: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    pf = fi.mod.pf

    def flag(node: ast.AST, what: str, message: str) -> None:
        out.append(Finding(rule=RULE, path=pf.path, line=node.lineno,
                           symbol=f"{fi.qual}:{what}",
                           message=f"kernel wrapper `{fi.qual}`: {message}"))

    for node in ast.walk(fi.node):
        if not isinstance(node, ast.ExceptHandler):
            continue
        last = node.body[-1] if node.body else None
        if not isinstance(last, ast.Raise) or any(
                isinstance(n, ast.Return) for n in ast.walk(node)):
            caught = ast.unparse(node.type) if node.type else "bare"
            flag(node, f"except-swallows:{caught}",
                 f"the `except {caught}` handler does not end in `raise` — "
                 "on a CUDA tensor a wrapper launches its kernel or "
                 "raises; re-raise (or let the error through)")
    for node, name, guarded, handler, arg_of in _uses(fi.node, _is_plain,
                                                      predicates):
        if handler:
            flag(node, f"except-plain:{name}",
                 f"an `except` handler routes to the plain version "
                 f"`{name}` — a failed launch must raise, never fall back")
            continue
        if guarded:
            continue
        if arg_of is not None:
            call, slot = arg_of
            callee = dotted(call.func)
            head = callee.rsplit(".", 1)[-1] if callee else None
            if f"{head}:{slot}" in _PLAIN_SLOTS:
                continue
            targets = prog.resolve(fi, call.func)
            if targets and all(_param_guarded(t, slot, predicates)
                               for t in targets):
                continue
            flag(node, f"plain-route:{name}",
                 f"the plain version `{name}` is passed to "
                 f"`{callee or ast.unparse(call.func)}`, which does not "
                 "run it only under a CPU device test — on a CUDA tensor "
                 "the wrapper must launch or raise")
            continue
        flag(node, f"plain-route:{name}",
             f"the plain version `{name}` is chosen outside a CPU device "
             "test (`x.device.type == \"cpu\"` or a predicate such as "
             "`_device_check`) — on a CUDA tensor the wrapper must launch "
             "or raise")
    return out
