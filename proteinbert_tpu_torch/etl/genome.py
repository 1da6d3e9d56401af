"""Reference-genome reader (reference C23 parity) — a copy of
`proteinbert_tpu/etl/genome.py`.

The reference vendors `GenomeReader`/`ChromosomeReader` — random-access
per-chromosome FASTA with coordinate→byte-offset arithmetic and
chromosome-name synonym resolution (X/23, Y/24, M/MT/25-26, 'chr'
prefixes; reference shared_utils/reference_genome.py:14-130). Unused by
the ProteinBERT path there and here, but part of the vendored surface, so
provided: the byte arithmetic lives in etl/fasta.FastaReader.fetch_range
(one implementation for proteins and genomes); this module adds the
genome-specific naming and 1-based coordinate conventions.
"""

from __future__ import annotations

from typing import Dict, List

from proteinbert_tpu_torch.etl.fasta import FastaReader

# Numeric aliases follow the reference's convention (reference
# shared_utils/reference_genome.py:103-126): X=23, Y=24, M/MT=25/26.
_NUMERIC_ALIASES = {"23": "X", "24": "Y", "25": "M", "26": "M"}
_MITO_ALIASES = {"M", "MT"}


class GenomeReader:
    """Random-access genome FASTA with chromosome-name resolution.

    `fetch(chrom, start, end)` uses 1-BASED INCLUSIVE coordinates (the
    genomics convention the reference reader follows); `fetch0` is the
    0-based half-open equivalent.
    """

    def __init__(self, fasta_path: str):
        self._reader = FastaReader(fasta_path)
        self._resolve: Dict[str, str] = {}
        for name in self._reader.index:
            for syn in self._synonyms(name):
                self._resolve.setdefault(syn, name)

    @staticmethod
    def _synonyms(name: str) -> List[str]:
        syns = [name, name.upper()]
        bare = name[3:] if name.lower().startswith("chr") else name
        syns += [bare, bare.upper(), "chr" + bare, "CHR" + bare.upper()]
        up = bare.upper()
        if up in _NUMERIC_ALIASES.values() or up in _MITO_ALIASES:
            canonical = "M" if up in _MITO_ALIASES else up
            for num, alias in _NUMERIC_ALIASES.items():
                if alias == canonical:
                    syns += [num, "chr" + num]
            if canonical == "M":
                syns += ["M", "MT", "chrM", "chrMT"]
        return syns

    def chromosome_name(self, chrom) -> str:
        """Resolve any accepted synonym to the FASTA's record name."""
        key = str(chrom)
        for cand in (key, key.upper(), _NUMERIC_ALIASES.get(key, key)):
            if cand in self._resolve:
                return self._resolve[cand]
        raise KeyError(f"unknown chromosome {chrom!r}")

    def __contains__(self, chrom) -> bool:
        try:
            self.chromosome_name(chrom)
            return True
        except KeyError:
            return False

    def length(self, chrom) -> int:
        return self._reader.length(self.chromosome_name(chrom))

    def fetch(self, chrom, start: int, end: int) -> str:
        """Bases [start, end] — 1-based inclusive."""
        return self._reader.fetch_range(
            self.chromosome_name(chrom), start - 1, end)

    def fetch0(self, chrom, start: int, end: int) -> str:
        """Bases [start, end) — 0-based half-open."""
        return self._reader.fetch_range(self.chromosome_name(chrom), start, end)

    def close(self) -> None:
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
