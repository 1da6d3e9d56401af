"""Random-access FASTA reader (replaces the reference's pyfaidx dependency)
— a copy of `proteinbert_tpu/etl/fasta.py`.

The reference joins SQLite annotation records to sequences through
`pyfaidx.Faidx` (reference uniref_dataset.py:299-313). pyfaidx is not in
this image, and the join only ever needs whole-record fetches by id — so
this is a minimal two-level design: an index pass recording
(byte offset, sequence length, line layout) per record in `.fai` format
(samtools-compatible: name, rlen, offset, line bases, line bytes), and an
O(1) fetch that seeks and strips newlines. Gzip inputs are supported for
indexing by streaming (no random access; `fetch` requires the plain file).
"""

from __future__ import annotations

import gzip
import os
import tempfile
from typing import Dict, Iterator, Tuple


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Stream (name, sequence) pairs; name is the first word of the header."""
    name, parts = None, []
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name, parts = line[1:].split()[0] if len(line) > 1 else "", []
            elif line:
                parts.append(line.rstrip("\r"))
        if name is not None:
            yield name, "".join(parts)


def build_index(fasta_path: str, index_path: str | None = None,
                use_native: bool = True) -> str:
    """Write a samtools-style .fai index; returns its path.

    Dispatches to the C++ scanner (native/fasta_index.cpp) when available
    — UniRef90's FASTA is tens of GB and this loop is the index-build
    bottleneck; the pure-Python path below is the semantic ground truth
    (parity-tested in tests/test_torch_native.py) and the automatic fallback.

    The index is written to a temp path and renamed into place only on
    success: FastaReader trusts any existing .fai, so a build that raises
    (ragged input) must not leave a truncated index behind.
    """
    index_path = index_path or fasta_path + ".fai"
    # mkstemp (not a pid suffix): concurrent builders in the SAME process
    # (reader threads racing to index) must not share a temp file.
    fd, tmp_path = tempfile.mkstemp(
        prefix=os.path.basename(index_path) + ".tmp",
        dir=os.path.dirname(os.path.abspath(index_path)))
    os.close(fd)
    try:
        _build_index_impl(fasta_path, tmp_path, use_native)
        os.chmod(tmp_path, 0o644)  # mkstemp is 0600
        os.replace(tmp_path, index_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return index_path


def _build_index_impl(fasta_path: str, index_path: str,
                      use_native: bool) -> None:
    if use_native:
        from proteinbert_tpu_torch.native.fasta_index import build_fai_native

        if build_fai_native(fasta_path, index_path) is not None:
            return
    with open(fasta_path, "rb") as f, open(index_path, "w") as out:
        name = None
        rlen = 0
        seq_offset = 0
        line_bases = 0
        line_bytes = 0
        offset = 0
        short_line_seen = False  # a narrower line is only legal as the LAST
        for raw in f:
            if raw.startswith(b">"):
                if name is not None:
                    out.write(f"{name}\t{rlen}\t{seq_offset}\t{line_bases}\t{line_bytes}\n")
                header = raw[1:].split()
                name = header[0].decode() if header else ""
                rlen = 0
                line_bases = 0
                line_bytes = 0
                short_line_seen = False
                seq_offset = offset + len(raw)
            else:
                stripped = raw.rstrip(b"\r\n")
                if stripped:
                    # The offset arithmetic in fetch() only holds for
                    # uniformly wrapped records (all lines equal width,
                    # except possibly the last). Reject anything else
                    # rather than silently truncate.
                    if short_line_seen or (line_bases and len(stripped) > line_bases):
                        raise ValueError(
                            f"record {name!r} in {fasta_path} has non-uniform "
                            "line widths; re-wrap the FASTA before indexing")
                    if line_bases == 0:
                        line_bases = len(stripped)
                        line_bytes = len(raw)
                    elif len(stripped) < line_bases:
                        short_line_seen = True
                    rlen += len(stripped)
                elif line_bases:
                    # A blank line inside a record is a width-0 line: legal
                    # only if nothing follows (same rule as a short line).
                    short_line_seen = True
            offset += len(raw)
        if name is not None:
            out.write(f"{name}\t{rlen}\t{seq_offset}\t{line_bases}\t{line_bytes}\n")


class FastaReader:
    """O(1) whole-record fetch by id over an indexed plain-text FASTA."""

    def __init__(self, fasta_path: str):
        if fasta_path.endswith(".gz"):
            raise ValueError(
                "random access needs an uncompressed FASTA; gunzip first "
                "(indexing via iter_fasta works on .gz)"
            )
        fai = fasta_path + ".fai"
        if not os.path.exists(fai):
            build_index(fasta_path, fai)
        self.index: Dict[str, Tuple[int, int, int, int]] = {}
        with open(fai) as f:
            for line in f:
                name, rlen, off, lb, lw = line.rstrip("\n").split("\t")
                self.index[name] = (int(rlen), int(off), int(lb), int(lw))
        self._f = open(fasta_path, "rb")

    def __contains__(self, name: str) -> bool:
        return name in self.index

    def __len__(self) -> int:
        return len(self.index)

    def length(self, name: str) -> int:
        return self.index[name][0]

    def fetch(self, name: str) -> str:
        """Full sequence for `name` (KeyError if absent, like pyfaidx)."""
        return self.fetch_range(name, 0, self.index[name][0])

    def fetch_range(self, name: str, start: int, end: int) -> str:
        """Bases [start, end) (0-based) of record `name`, via
        coordinate→byte-offset arithmetic — one seek + one read, the
        random-access primitive the reference's ChromosomeReader builds
        its genome coordinates on (reference
        shared_utils/reference_genome.py:67-99)."""
        rlen, off, line_bases, line_bytes = self.index[name]
        start = max(0, start)
        end = min(rlen, end)
        if end <= start:
            return ""
        newline = line_bytes - line_bases
        byte_lo = off + start + (start // line_bases) * newline
        last = end - 1
        byte_hi = off + last + (last // line_bases) * newline + 1
        self._f.seek(byte_lo)
        raw = self._f.read(byte_hi - byte_lo)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
