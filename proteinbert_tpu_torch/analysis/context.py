"""Shared parse context for the port's `check` rules.

Every rule consumes the same one-pass artifacts: each scanned file is
read and `ast.parse`d exactly once, `# guarded-by:` / `# lock-held:`
comment annotations are extracted from raw source lines (the AST drops
comments), and a cheap per-file identifier index serves the dead-export
sweep. Rules never touch the filesystem themselves — fixture tests
point a `CheckConfig` at a temp tree and get identical behavior to the
repo run.

The JAX package's `analysis/context.py` with the port's defaults: the
scan roots, durability files, event schema and references of
`proteinbert_tpu_torch/`, and what `graph-purity` needs in place of
`jit-purity`'s trace entries — the kernel directories whose
launch-reaching functions are wrappers, and the batch functions a CUDA
graph captures.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

# --- comment annotations -------------------------------------------------
# `self.attr = ...  # guarded-by: _lock` declares that `self.attr` may
# only be touched inside `with self._lock`. `def m(...):  # lock-held:
# _lock` declares a method whose CALLERS hold the lock (the body is
# treated as locked). Both are per-line, next to the code they govern.
GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
LOCK_HELD_RE = re.compile(r"#\s*lock-held:\s*([A-Za-z_]\w*)")


@dataclasses.dataclass
class ParsedFile:
    path: str                 # repo-relative, forward slashes
    abspath: str
    source: str
    lines: List[str]
    tree: Optional[ast.AST]   # None when the file failed to parse
    parse_error: Optional[str] = None

    def guarded_by(self, lineno: int) -> Optional[str]:
        m = GUARDED_BY_RE.search(self._line(lineno))
        return m.group(1) if m else None

    def lock_held(self, lineno: int) -> Optional[str]:
        m = LOCK_HELD_RE.search(self._line(lineno))
        return m.group(1) if m else None

    def _line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


@dataclasses.dataclass
class CheckConfig:
    """Everything the rules need to know about one tree: the port's by
    default; fixture tests construct it by hand against a temp
    directory."""

    root: str
    # Directories/files (repo-relative) the AST rules scan.
    scan_roots: Tuple[str, ...] = ("proteinbert_tpu_torch", "chip_smoke.py")
    # Files under the durability contract (rule 3): tmp→fsync→rename per
    # file, or the directory form (files fsynced in a tmp directory that
    # is renamed, then the parent fsynced).
    durability_files: Tuple[str, ...] = (
        "proteinbert_tpu_torch/mapper/store.py",
        "proteinbert_tpu_torch/train/checkpoint.py",
    )
    # The event schema's single source of truth (rule 4), parsed by
    # AST — never imported, so the checker stays torch-free even though
    # importing obs pulls the package root (which imports torch).
    events_py: str = "proteinbert_tpu_torch/obs/events.py"
    # The observability reference both drift directions check (rule 5):
    # the port keeps the JAX event schema, so it is the JAX package's doc.
    docs_md: str = "docs/observability.md"
    # Extra corpus consulted when deciding whether an export is dead
    # (rule 6) — tests legitimately keep an export alive.
    reference_roots: Tuple[str, ...] = (
        "proteinbert_tpu_torch", "tests", "chip_smoke.py")
    # Functions allowed to read os.environ inside a captured body or a
    # kernel wrapper (rule 1). The one trace-time reader is
    # `kernels/budget.refuse_forced_reference`: it only raises (on a CUDA
    # device while JAX's force-reference switch is set, which the port
    # does not port), so a capture with the switch set fails and no
    # replay can run a route the read chose. A build-time reader such as
    # `kernels/build.nvcc_path` belongs here only if the rule reaches it.
    sanctioned_env_readers: Tuple[str, ...] = ("refuse_forced_reference",)
    # Metric/event names the doc may mention without a live
    # registration (rule 5): documented-as-removed history.
    docs_allow: Tuple[str, ...] = (
        "fused_kernel_fallback_total",
    )
    # Directories (repo-relative) whose functions that reach a
    # `<kernel>.launch(...)` call are kernel wrappers (rule 1's second
    # kind of root, held to launch or raise).
    kernel_roots: Tuple[str, ...] = ("proteinbert_tpu_torch/kernels",)
    # The batch functions the dispatchers hand to `serve/dispatch.
    # WarmShape`, which captures one call of each in a CUDA graph
    # (rule 1's first kind of root, beside `with torch.cuda.graph(...)`
    # bodies), as "path:qualname". A name that no longer resolves is a
    # config error.
    captured_functions: Tuple[str, ...] = tuple(
        f"proteinbert_tpu_torch/{path}:{fn}" for path, fns in (
            ("inference.py", (
                "_encode_batch", "_go_probs_batch", "_residue_probs_batch",
                "_packed_encode_batch", "_packed_go_probs_batch",
                "_packed_residue_probs_batch")),
            ("heads/apply.py", ("trunk_batch", "packed_trunk_batch")),
            ("parallel/quant.py", (
                "_q_encode_batch", "_q_go_probs_batch",
                "_q_residue_probs_batch", "_q_act_encode_batch",
                "_q_act_go_probs_batch", "_q_act_residue_probs_batch",
                "_q_packed_encode_batch", "_q_packed_go_probs_batch",
                "_q_packed_residue_probs_batch", "_q_trunk_batch",
                "_q_packed_trunk_batch")),
        ) for fn in fns)

    def abspath(self, rel: str) -> str:
        return os.path.join(self.root, rel)


class CheckContext:
    def __init__(self, cfg: CheckConfig):
        self.cfg = cfg
        self.errors: List[str] = []
        self._cache: Dict[str, ParsedFile] = {}
        self.files: List[ParsedFile] = []
        for rel in sorted(_walk_py(cfg.root, cfg.scan_roots)):
            pf = self.load(rel)
            if pf is not None:
                self.files.append(pf)

    # ------------------------------------------------------------ loading

    def load(self, rel: str) -> Optional[ParsedFile]:
        """Parse one repo-relative file (cached). Unreadable files are
        context errors (exit 2); unparseable ones carry parse_error and
        become findings in the runner (a syntax error in a scanned file
        must fail the gate, not vanish)."""
        rel = rel.replace(os.sep, "/")
        if rel in self._cache:
            return self._cache[rel]
        abspath = self.cfg.abspath(rel)
        try:
            with open(abspath, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            self.errors.append(f"{rel}: unreadable: {e}")
            self._cache[rel] = None  # type: ignore[assignment]
            return None
        tree: Optional[ast.AST] = None
        parse_error: Optional[str] = None
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            parse_error = f"line {e.lineno}: {e.msg}"
        pf = ParsedFile(path=rel, abspath=abspath, source=source,
                        lines=source.splitlines(), tree=tree,
                        parse_error=parse_error)
        self._cache[rel] = pf
        return pf

    def read_text(self, rel: str) -> Optional[str]:
        try:
            with open(self.cfg.abspath(rel), encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None

    # ------------------------------------------- identifier index (rule 6)

    def identifier_index(self) -> Dict[str, Set[str]]:
        """{repo-relative path: every identifier the file mentions}
        over the reference corpus — Name ids, Attribute attrs, and
        import names. Coarse by design: the dead-export sweep must err
        toward 'used', never flag a live name."""
        index: Dict[str, Set[str]] = {}
        for rel in sorted(_walk_py(self.cfg.root,
                                   self.cfg.reference_roots)):
            pf = self.load(rel)
            if pf is None or pf.tree is None:
                continue
            ids: Set[str] = set()
            for node in ast.walk(pf.tree):
                if isinstance(node, ast.Name):
                    ids.add(node.id)
                elif isinstance(node, ast.Attribute):
                    ids.add(node.attr)
                elif isinstance(node, (ast.Import, ast.ImportFrom)):
                    for alias in node.names:
                        ids.add(alias.name.split(".")[0]
                                if isinstance(node, ast.Import)
                                else alias.name)
                        if alias.asname:
                            ids.add(alias.asname)
            index[rel] = ids
        return index


def _walk_py(root: str, rel_roots: Iterable[str]) -> List[str]:
    out: List[str] = []
    for rel in rel_roots:
        top = os.path.join(root, rel)
        if os.path.isfile(top) and rel.endswith(".py"):
            out.append(rel.replace(os.sep, "/"))
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__"
                           and not d.startswith(".")]
            for fn in filenames:
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    out.append(os.path.relpath(full, root)
                               .replace(os.sep, "/"))
    return out


# ----------------------------------------------------- small AST helpers

def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def qualname(stack: List[str], name: str) -> str:
    return ".".join(stack + [name]) if stack else name
