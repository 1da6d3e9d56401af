"""Rule 3 — `durability-protocol`: tmp → fsync → rename, or nothing.

`mapper/store.py` owns the crash-safety story (objects and cursors are
absent-or-complete because every write goes tmp → flush → fsync →
atomic rename) and `train/checkpoint.py` writes each step the same way,
a directory at a time. This rule pins the protocol in the durability
files (`cfg.durability_files`):

1. **rename-without-fsync**: an `os.replace`/`os.rename` whose SOURCE
   expression was opened for write in the same function must have an
   `os.fsync` between the open and the rename — otherwise the rename
   can land before the data and a crash leaves a "complete" name with
   torn bytes (precisely the torn-survivor class the drills hunt).
2. **bare-final-write**: opening a path for (over)write whose handle is
   never the source of a rename in that function writes bytes straight
   to a FINAL path — a crash mid-write leaves a torn file under its
   real name. Append mode is exempt (the quarantine/event sidecars are
   append-only by design, torn-tail-tolerant at read time).
3. **the directory form** (the port's checkpointer, which has no orbax
   under it): files opened for write at `os.path.join(tmp, ...)`, where
   the same function later renames the directory `tmp` itself. That is
   durable when each such file is fsynced before the next write-open
   (or the rename) and the parent directory is fsynced after the rename
   (`os.fsync`, or a module-local helper that calls it). A file of the
   form without its fsync is **dir-file-without-fsync**; a rename
   without the parent's fsync after it is
   **dir-rename-without-parent-fsync**; without the rename the files are
   bare final writes (2).

Matching is per-function and textual on the path expression
(`ast.unparse`), which is exactly how the real code is shaped: every
atomic write in this package opens `tmp` (or a file inside the
directory `tmp`) and renames `tmp` within one function.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from proteinbert_tpu_torch.analysis.context import CheckContext, dotted
from proteinbert_tpu_torch.analysis.findings import Finding

RULE = "durability-protocol"

_WRITE_MODES = ("w", "wb", "w+", "wb+", "w+b", "x", "xb")


def _open_write_target(node: ast.Call) -> Optional[str]:
    """The unparsed path expression of an `open(path, "w*")` /
    `os.fdopen(fd, "w*")` call, or None when not a write-mode open."""
    name = dotted(node.func)
    if name not in ("open", "os.fdopen"):
        return None
    mode: Optional[str] = None
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
        mode = node.args[1].value
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if not isinstance(mode, str) or mode not in _WRITE_MODES:
        return None
    if not node.args:
        return None
    return ast.unparse(node.args[0])


def check(ctx: CheckContext) -> List[Finding]:
    import os

    findings: List[Finding] = []
    for rel in ctx.cfg.durability_files:
        if not os.path.exists(ctx.cfg.abspath(rel)):
            continue  # tree without this subsystem (fixture roots)
        pf = ctx.load(rel)
        if pf is None or pf.tree is None:
            continue
        dir_syncers = _dir_syncers(pf.tree)
        for node in ast.walk(pf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(_check_function(pf.path, node, dir_syncers))
    return findings


def _dir_syncers(tree: ast.AST) -> Set[str]:
    """Names of the module-level functions that call `os.fsync` (such as
    checkpoint.py's `_fsync_dir`): a call to one after a directory
    rename is the parent's fsync."""
    return {node.name for node in getattr(tree, "body", [])
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and any(isinstance(n, ast.Call)
                    and dotted(n.func) in ("os.fsync", "fsync")
                    for n in ast.walk(node))}


def _join_dir(expr: ast.AST) -> Optional[str]:
    """`D` (unparsed) for an `os.path.join(D, ...)` path, else None."""
    if isinstance(expr, ast.Call) and dotted(expr.func) == "os.path.join" \
            and len(expr.args) >= 2:
        return ast.unparse(expr.args[0])
    return None


def _check_function(path: str, fn: ast.AST,
                    dir_syncers: Set[str] = frozenset()) -> List[Finding]:
    opens: List[Tuple[int, str, Optional[str]]] = []  # (line, path, dir)
    fsyncs: List[int] = []                # lines
    dir_syncs: List[int] = []             # lines of dir_syncers calls
    renames: List[Tuple[int, str, ast.Call]] = []  # (line, src expr)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        target = _open_write_target(node)
        if target is not None:
            opens.append((node.lineno, target, _join_dir(node.args[0])))
            continue
        name = dotted(node.func)
        if name in ("os.fsync", "fsync"):
            fsyncs.append(node.lineno)
        elif name in dir_syncers:
            dir_syncs.append(node.lineno)
        elif name in ("os.replace", "os.rename") and node.args:
            renames.append((node.lineno, ast.unparse(node.args[0]),
                            node))

    out: List[Finding] = []
    fname = getattr(fn, "name", "<fn>")
    renamed_exprs = {src for _, src, _ in renames}
    for rline, src, _node in renames:
        matching = [(oline, t) for oline, t, _ in opens
                    if t == src and oline <= rline]
        if not matching:
            continue  # source not opened here (caller's durable bytes)
        oline = max(o for o, _ in matching)
        if not any(oline <= f <= rline for f in fsyncs):
            out.append(Finding(
                rule=RULE, path=path, line=rline,
                symbol=f"{fname}:rename-without-fsync:{src}",
                message=(f"`os.replace({src}, ...)` in `{fname}` renames "
                         "a file opened for write in this function with "
                         "no os.fsync between write and rename — the "
                         "rename can land before the data (torn "
                         "survivor); fsync before renaming"),
            ))
    dir_renames = {}  # directory expr -> line of its last rename
    for rline, src, _node in renames:
        dir_renames[src] = max(rline, dir_renames.get(src, 0))
    write_lines = sorted({o for o, _, _ in opens} | {r for r, _, _ in renames})
    checked_dirs = set()
    for oline, target, parent in opens:
        if target in renamed_exprs:
            continue  # tmp half of a tmp→rename pair
        rline = dir_renames.get(parent) if parent is not None else None
        if rline is None or rline < oline:
            out.append(Finding(
                rule=RULE, path=path, line=oline,
                symbol=f"{fname}:bare-final-write:{target}",
                message=(f"`open({target}, 'w…')` in `{fname}` writes "
                         "bytes directly to a final path (no tmp→fsync→"
                         "rename in this function) — a crash mid-write "
                         "leaves a torn file under its real name; write a "
                         "tmp sibling and os.replace it"),
            ))
            continue
        # The directory form: this file lands under `parent`, which the
        # function renames at rline.
        nxt = min(w for w in write_lines if w > oline)
        if not any(oline <= f < nxt for f in fsyncs):
            out.append(Finding(
                rule=RULE, path=path, line=oline,
                symbol=f"{fname}:dir-file-without-fsync:{target}",
                message=(f"`open({target}, 'w…')` in `{fname}` writes a "
                         f"file of the directory `{parent}`, which is "
                         "renamed into place, with no os.fsync before the "
                         "next write or the rename — the rename can land "
                         "before the file's bytes; fsync each file"),
            ))
        if parent not in checked_dirs:
            checked_dirs.add(parent)
            if not any(f > rline for f in fsyncs + dir_syncs):
                out.append(Finding(
                    rule=RULE, path=path, line=rline,
                    symbol=f"{fname}:dir-rename-without-parent-fsync:"
                           f"{parent}",
                    message=(f"`os.rename({parent}, ...)` in `{fname}` "
                             "renames a directory of fsynced files with no "
                             "fsync of the parent directory after it — "
                             "the rename itself may not survive a crash; "
                             "fsync the parent"),
                ))
    return out
