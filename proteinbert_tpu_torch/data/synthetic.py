"""Synthetic UniRef-like data — port of `proteinbert_tpu/data/synthetic.py`
(`make_random_proteins`): random amino-acid strings and sparse
annotation rows, the fixture of the tests and of `chip_smoke.py`."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from proteinbert_tpu_torch.data.vocab import ALPHABET


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
