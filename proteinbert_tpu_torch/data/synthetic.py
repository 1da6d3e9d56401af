"""Synthetic data — port of `proteinbert_tpu/data/synthetic.py`
(`make_random_proteins`, `make_task_batches`): random amino-acid strings
and sparse annotation rows, and supervised task batches whose labels are
functions of the sequence; the fixtures of the tests and of
`chip_smoke.py`."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from proteinbert_tpu_torch.data.finetune_data import batch_task_data
from proteinbert_tpu_torch.data.transforms import tokenize_batch
from proteinbert_tpu_torch.data.vocab import ALPHABET, PAD_ID

_HYDROPHOBIC = set("AVILMFWC")


def make_random_proteins(
    n: int,
    rng: np.random.Generator,
    num_annotations: int = 512,
    max_len: int = 250,
    density: float = 0.005,
) -> Tuple[List[str], np.ndarray]:
    """n random AA strings of length 0..max_len and (n, A) sparse 0/1
    annotation rows (~`density` positive rate). The same draws from the
    same `rng` as the JAX function, so a seed gives the same proteins."""
    seqs = []
    for _ in range(n):
        L = int(rng.integers(0, max_len + 1))
        seqs.append("".join(rng.choice(list(ALPHABET), size=L)))
    ann = (rng.random((n, num_annotations)) < density).astype(np.float32)
    return seqs, ann


def make_task_batches(n: int, rng: np.random.Generator, kind: str,
                      num_outputs: int, seq_len: int, batch_size: int):
    """Supervised {"tokens", "labels"} numpy batches whose labels are
    deterministic functions of the sequence (the same draws from the same
    `rng` as the JAX function): token_classification — each token id mod
    num_outputs; sequence_classification — the most frequent of those
    classes over the real tokens; sequence_regression — the sequence's
    hydrophobic fraction."""
    seqs = []
    for _ in range(n):
        L = int(rng.integers(seq_len // 4, seq_len - 2))
        seqs.append("".join(rng.choice(list(ALPHABET), size=L)))
    tokens = tokenize_batch(seqs, seq_len)
    if kind == "token_classification":
        labels = (tokens % num_outputs).astype(np.int32)
    elif kind == "sequence_classification":
        per_tok = tokens % num_outputs
        labels = np.zeros(n, np.int32)
        for i in range(n):
            real = tokens[i] != PAD_ID
            labels[i] = np.bincount(per_tok[i][real],
                                    minlength=num_outputs).argmax()
    elif kind == "sequence_regression":
        labels = np.array([sum(c in _HYDROPHOBIC for c in s)
                           / max(len(s), 1) for s in seqs], np.float32)
    else:
        raise ValueError(f"unknown task kind {kind!r}")
    return batch_task_data(tokens, labels, batch_size)
