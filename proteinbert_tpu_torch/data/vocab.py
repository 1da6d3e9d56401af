"""Amino-acid vocabulary (reference C5) — a copy of
`proteinbert_tpu/data/vocab.py`, so the port tokenizes to the same ids.

Same token space as the reference `create_amino_acid_vocab`
(reference data_processing.py:337-348): the 22-char alphabet
'ACDEFGHIKLMNPQRSTUVWXY' (also re-declared at reference dummy_tests.py:16)
plus four specials. The reference builds it with torchtext and gets
<pad>=0, <sos>=1, <eos>=2, <unk>=3, then the AA chars at 4..25; we keep the
exact same ids (26 total) without the torchtext dependency, and expose a
numpy LUT-based encoder so tokenization is vectorizable (the reference
tokenizes one char at a time in a Python loop, data_processing.py:30-61).

Unknown characters map to <unk> (torchtext `set_default_index` parity,
reference data_processing.py:347).
"""

from __future__ import annotations

import functools

import numpy as np

ALPHABET = "ACDEFGHIKLMNPQRSTUVWXY"  # 22 chars, reference data_processing.py:338

PAD_ID = 0
SOS_ID = 1
EOS_ID = 2
UNK_ID = 3
N_SPECIAL = 4
SPECIALS = ("<pad>", "<sos>", "<eos>", "<unk>")

VOCAB_SIZE = N_SPECIAL + len(ALPHABET)  # 26


class Vocab:
    """Minimal char vocab with a 256-entry byte LUT for vectorized encode."""

    def __init__(self, alphabet: str = ALPHABET):
        self.alphabet = alphabet
        self.itos = list(SPECIALS) + list(alphabet)
        self.stoi = {s: i for i, s in enumerate(self.itos)}
        lut = np.full(256, UNK_ID, dtype=np.int32)
        for i, ch in enumerate(alphabet):
            lut[ord(ch)] = N_SPECIAL + i
            lut[ord(ch.lower())] = N_SPECIAL + i  # soft-masked FASTA residues
        self._lut = lut

    def __len__(self) -> int:
        return len(self.itos)

    def encode(self, seq: str) -> np.ndarray:
        """Encode an AA string to ids (no sos/eos added here)."""
        raw = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
        return self._lut[raw]

    def decode(self, ids) -> str:
        out = []
        for i in np.asarray(ids).tolist():
            tok = self.itos[i]
            out.append(tok if len(tok) == 1 else "")
        return "".join(out)

    @property
    def special_ids(self) -> np.ndarray:
        return np.arange(N_SPECIAL, dtype=np.int32)


@functools.lru_cache(maxsize=1)
def get_vocab() -> Vocab:
    return Vocab()
