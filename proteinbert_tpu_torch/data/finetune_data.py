"""Labeled fine-tuning data from TSV files — port of
`proteinbert_tpu/data/finetune_data.py` (numpy only).

The format is two columns, `sequence<TAB>label`, one protein a line, `#`
comments and blank lines allowed:

  token_classification    a label per residue: a digit string as long as
                          the sequence ("01123...") or comma-separated
                          ints ("0,1,12,3"); positions without a label
                          (<sos>, <eos>, <pad>, residues past the window)
                          are -1 in the batch and out of the loss
                          (train/finetune.task_loss).
  sequence_classification one int a line.
  sequence_regression     one float a line.

The parse errors name the line, as the JAX loader's do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from proteinbert_tpu_torch.data.transforms import tokenize_batch


def _parse_token_labels(raw: str, seq: str, lineno: int) -> List[int]:
    if "," in raw:
        labels = [int(x) for x in raw.split(",")]
    else:
        labels = [int(c) for c in raw]
    if len(labels) != len(seq):
        raise ValueError(
            f"line {lineno}: {len(labels)} labels for {len(seq)} residues")
    return labels


def load_task_tsv(path: str, kind: str,
                  seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens (N, seq_len) int32, labels): labels (N, seq_len) int32 with
    -1 at unlabeled positions for token_classification (residue j at token
    j+1, after <sos>), (N,) int32 for sequence_classification, (N,)
    float32 for sequence_regression."""
    seqs: List[str] = []
    raw_labels: List[str] = []
    linenos: List[int] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) != 2:
                raise ValueError(
                    f"line {lineno}: expected 'sequence<TAB>label', "
                    f"got {len(parts)} fields")
            seqs.append(parts[0])
            raw_labels.append(parts[1])
            linenos.append(lineno)

    tokens = tokenize_batch(seqs, seq_len)

    if kind == "token_classification":
        labels = np.full((len(seqs), seq_len), -1, np.int32)
        for i, (seq, raw) in enumerate(zip(seqs, raw_labels)):
            per_res = _parse_token_labels(raw, seq, linenos[i])
            # Residues past the window are dropped with their labels.
            n = min(len(per_res), seq_len - 2)
            labels[i, 1:1 + n] = per_res[:n]
        return tokens, labels
    if kind == "sequence_classification":
        return tokens, np.array([int(x) for x in raw_labels], np.int32)
    if kind == "sequence_regression":
        return tokens, np.array([float(x) for x in raw_labels], np.float32)
    raise ValueError(f"unknown task kind {kind!r}")


def batch_task_data(
    tokens: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
) -> List[Dict[str, np.ndarray]]:
    """Shuffle (with `rng`) and split into full batches; the remainder is
    dropped, so every step has one shape."""
    n = len(tokens)
    order = rng.permutation(n) if rng is not None else np.arange(n)
    batches = []
    for i in range(0, n - batch_size + 1, batch_size):
        idx = order[i:i + batch_size]
        batches.append({"tokens": tokens[idx], "labels": labels[idx]})
    return batches
