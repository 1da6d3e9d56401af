"""GO ontology (OBO) parsing + DAG closure (reference C2, redesigned) — a
copy of `proteinbert_tpu/etl/go_ontology.py`.

The reference regex-parses the CAFA `go.txt` into a pandas DataFrame and
builds ancestor/offspring closures by BFS from the roots (reference
uniref_dataset.py:158-198, 323-360). Here the ontology is a plain
`GoOntology` object: dict-backed, no DataFrame in the hot path, closures
computed by one topological propagation pass. Crucially `complete()`
really ancestor-completes a term set — the reference computes the
completion and then throws it away (reference uniref_dataset.py:124-126;
SURVEY ledger #6).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Sequence, Set

_TERM_BLOCK = re.compile(r"\[Term\]\n((?:[\w-]+: .*\n?)+)")
_FIELD_LINE = re.compile(r"([\w-]+): (.*)")


@dataclasses.dataclass
class GoTerm:
    id: str
    index: int                      # dense index in parse order
    name: str = ""
    namespace: str = ""
    is_obsolete: bool = False
    parents: Set[str] = dataclasses.field(default_factory=set)   # direct is_a
    children: Set[str] = dataclasses.field(default_factory=set)


class GoOntology:
    """Parsed GO DAG with transitive-ancestor closure.

    `ancestors[go_id]` includes the term itself (matching the reference's
    closure convention, uniref_dataset.py:346).
    """

    def __init__(self, terms: Dict[str, GoTerm]):
        self.terms = terms
        self.id_to_index = {t.id: t.index for t in terms.values()}
        self.index_to_id = {t.index: t.id for t in terms.values()}
        self.ancestors = self._close(lambda t: t.parents)
        self.offspring = self._close(lambda t: t.children)

    def __len__(self) -> int:
        return len(self.terms)

    def _close(self, up) -> Dict[str, Set[str]]:
        """Transitive closure along `up` edges via iterative DFS with
        memoization (the DAG is small: ~47k terms)."""
        closure: Dict[str, Set[str]] = {}

        def visit(root: str) -> Set[str]:
            stack = [root]
            while stack:
                gid = stack[-1]
                if gid in closure:
                    stack.pop()
                    continue
                pending = [p for p in up(self.terms[gid])
                           if p not in closure and p in self.terms]
                if pending:
                    stack.extend(pending)
                    continue
                out = {gid}
                for p in up(self.terms[gid]):
                    if p in self.terms:
                        out |= closure[p]
                closure[gid] = out
                stack.pop()
            return closure[root]

        for gid in self.terms:
            visit(gid)
        return closure

    def complete(self, go_ids: Iterable[str]) -> Set[str]:
        """Ancestor-complete a set of GO ids; unknown ids are dropped
        (the caller counts them — see UnirefToSqliteParser)."""
        out: Set[str] = set()
        for gid in go_ids:
            anc = self.ancestors.get(gid)
            if anc is not None:
                out |= anc
        return out

    def complete_indices(self, go_ids: Iterable[str]) -> List[int]:
        """Sorted dense indices of the ancestor-completed set. This is
        what the reference MEANT to store (ledger #6)."""
        return sorted(self.id_to_index[g] for g in self.complete(go_ids))

    def roots(self) -> List[str]:
        return [t.id for t in self.terms.values() if not t.parents]


def parse_obo(path: str) -> GoOntology:
    """Parse an OBO-style file (the CAFA go.txt format the reference
    consumes, reference uniref_dataset.py:158-198) into a GoOntology."""
    with open(path, "r") as f:
        raw = f.read()

    terms: Dict[str, GoTerm] = {}
    for match in _TERM_BLOCK.finditer(raw):
        fields: Dict[str, List[str]] = {}
        for line in match.group(1).splitlines():
            m = _FIELD_LINE.match(line)
            if not m:
                continue
            fields.setdefault(m.group(1), []).append(m.group(2))
        gid = fields["id"][0]
        if gid in terms:
            raise ValueError(f"duplicate GO id {gid}")
        term = GoTerm(
            id=gid,
            index=len(terms),
            name=fields.get("name", [""])[0],
            namespace=fields.get("namespace", [""])[0],
            is_obsolete=fields.get("is_obsolete", ["false"])[0] == "true",
        )
        for raw_is_a in fields.get("is_a", []):
            # "GO:0000001 ! parent name" — keep only the id.
            term.parents.add(raw_is_a.split(" ! ")[0].strip())
        terms[gid] = term

    # Wire children from parents (second pass; parents may appear later
    # in the file than their children).
    for t in terms.values():
        for p in list(t.parents):
            if p in terms:
                terms[p].children.add(t.id)

    return GoOntology(terms)


def save_meta_csv(
    onto: GoOntology, path: str, counts: Dict[str, int] | None = None,
    total_records: int = 0,
) -> None:
    """Write the per-term metadata CSV the h5 builder consumes (columns
    id,index,name,namespace,count,freq — superset of what the reference's
    create_h5_dataset reads, reference uniref_dataset.py:211)."""
    import csv

    counts = counts or {}
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "index", "name", "namespace", "count", "freq"])
        for gid in sorted(onto.terms, key=lambda g: onto.terms[g].index):
            t = onto.terms[gid]
            c = counts.get(gid, 0)
            freq = c / total_records if total_records else 0.0
            w.writerow([t.id, t.index, t.name, t.namespace, c, freq])


def load_meta_csv(path: str) -> List[dict]:
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        r["index"] = int(r["index"])
        r["count"] = int(float(r["count"]))
        r["freq"] = float(r["freq"])
    return rows
