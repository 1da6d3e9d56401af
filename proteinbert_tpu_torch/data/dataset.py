"""Pretraining dataset and batch iterator — port of the in-memory half of
`proteinbert_tpu/data/dataset.py`.

`InMemoryPretrainingDataset` tokenizes a table of sequences and
annotations into dense numpy arrays once; `make_pretrain_iterator` yields
shuffled, per-host sharded CLEAN {"tokens", "annotations"} numpy batches
(corruption happens on the device, `data/corruption.py`), and
`skip_batches` fast-forwards a resumed run without loading the consumed
batches. Row order, shards and crop windows are the JAX package's, so the
same seed gives the same token ids. `row_lengths`, `_epoch_order` and
`_make_fetch` are what the packed iterator (`data/packing.py`) reads from
a dataset. The HDF5 reader (a dataset with a `shuffle_block`, which
`_epoch_order` honours) and the bucketed iterator are not ported; the
bucketed iterator's `metrics` registry (`data_pad_fraction` and
`data_dropped_rows_total`, `strategy="bucketed"`) comes with it. The JAX
`make_pretrain_iterator` takes no registry, and neither does this one.
"""

from __future__ import annotations

import inspect
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from proteinbert_tpu_torch.data.transforms import (
    epoch_crop_seed, tokenize_batch,
)


def _window_seed(crop_seed: Optional[int], epoch: int) -> Optional[int]:
    """Per-epoch window seed, or None when cropping is off."""
    if crop_seed is None:
        return None
    return epoch_crop_seed(crop_seed, epoch)


class InMemoryPretrainingDataset:
    """Dense in-RAM dataset: seqs (N strings), annotations (N, A) 0/1,
    padded to seq_len. With `crop_seed`, rows longer than seq_len-2 take
    a counter-based window per (crop_seed, epoch, row); without it they
    are head-truncated once."""

    def __init__(
        self,
        seqs: Sequence[str],
        annotations: np.ndarray,
        seq_len: int,
        crop_seed: Optional[int] = None,
    ):
        annotations = np.asarray(annotations)
        if len(seqs) != len(annotations):
            raise ValueError(
                f"{len(seqs)} seqs vs {len(annotations)} annotation rows")
        self.seq_len = seq_len
        self.crop_seed = crop_seed
        self.tokens = tokenize_batch(seqs, seq_len)
        if crop_seed is not None:
            # Only long rows are re-tokenized per access.
            self._long_seqs = {
                i: s for i, s in enumerate(seqs) if len(s) > seq_len - 2
            }
            self._long = np.zeros(len(seqs), dtype=bool)
            self._long[list(self._long_seqs)] = True
        else:
            self._long_seqs = None
            self._long = None
        self.annotations = annotations.astype(np.float32)

    def row_lengths(self) -> np.ndarray:
        """(N,) tokenized lengths incl. <sos>/<eos> (crop-invariant)."""
        return (self.tokens != 0).sum(axis=1).astype(np.int64)

    def __len__(self) -> int:
        return len(self.tokens)

    def get_batch(self, idx: np.ndarray,
                  epoch: int = 0) -> Dict[str, np.ndarray]:
        """Vectorized gather; long rows take their (epoch, row) window."""
        tokens = self.tokens[idx]
        if self._long is not None:
            positions = np.flatnonzero(self._long[idx])
            if len(positions):
                ids = np.asarray(idx)[positions]
                tokens[positions] = tokenize_batch(
                    [self._long_seqs[int(i)] for i in ids], self.seq_len,
                    _window_seed(self.crop_seed, epoch), ids,
                )
        return {"tokens": tokens, "annotations": self.annotations[idx]}


def _epoch_order(n: int, rng: np.random.Generator, shuffle: bool,
                 block: Optional[int]) -> np.ndarray:
    """Epoch permutation; block-shuffled (blocks permuted, rows permuted
    within each block) when the dataset prefers block-local access."""
    if not shuffle:
        return np.arange(n)
    if not block or block >= n:
        return rng.permutation(n)
    starts = rng.permutation(np.arange(0, n, block))
    out = np.empty(n, dtype=np.int64)
    pos = 0
    for s in starts:
        hi = min(s + block, n)
        chunk = np.arange(s, hi)
        rng.shuffle(chunk)
        out[pos:pos + len(chunk)] = chunk
        pos += len(chunk)
    return out


def _make_fetch(dataset):
    """(row-index array, epoch) → {"tokens", "annotations"} batch, via the
    dataset's batched gather when it has one; a `get_batch` without an
    epoch parameter (nor **kwargs) is called without it."""
    get_batch = getattr(dataset, "get_batch", None)
    takes_epoch = False
    if get_batch is not None:
        try:
            params = inspect.signature(get_batch).parameters
            takes_epoch = "epoch" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values())
        except (TypeError, ValueError):
            takes_epoch = False

    def fetch(idx: np.ndarray, epoch: int = 0) -> Dict[str, np.ndarray]:
        if get_batch is not None:
            if takes_epoch:
                return get_batch(idx, epoch=epoch)
            return get_batch(idx)
        rows = [dataset[int(i)] for i in idx]
        return {"tokens": np.stack([r["tokens"] for r in rows]),
                "annotations": np.stack([r["annotations"] for r in rows])}

    return fetch


def _check_per_host(n: int, batch_size: int, process_count: int) -> int:
    per_host = n // process_count
    if per_host < batch_size:
        raise ValueError(
            f"per-host shard of {per_host} rows (n={n}, hosts="
            f"{process_count}) cannot fill a batch of {batch_size}")
    return per_host


def make_pretrain_iterator(
    dataset,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    num_epochs: Optional[int] = None,
    process_index: int = 0,
    process_count: int = 1,
    skip_batches: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite (or num_epochs-bounded) per-host sharded batch iterator
    over a dataset with `len` and `get_batch(idx, epoch)`. Each host sees a
    disjoint, equal-sized contiguous slice of every epoch's permutation.
    Raises if the per-host shard cannot fill one batch. `skip_batches`
    replays only the epoch permutations, so a resumed run yields the same
    batches as an uninterrupted one."""
    n = len(dataset)
    per_host = _check_per_host(n, batch_size, process_count)
    block = getattr(dataset, "shuffle_block", None)
    fetch = _make_fetch(dataset)
    rng = np.random.default_rng(seed)
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = _epoch_order(n, rng, shuffle, block)[:per_host * process_count]
        shard = order[process_index * per_host:(process_index + 1) * per_host]
        for lo in range(0, per_host - batch_size + 1, batch_size):
            if skip_batches > 0:
                skip_batches -= 1
                continue
            yield fetch(shard[lo:lo + batch_size], epoch)
        epoch += 1


class Subset:
    """Row-index view over a dataset (the train/eval split primitive);
    parent row ids key the crop windows. Proxies the iterator-facing
    surface (get_batch, row_lengths, seq_len, shuffle_block)."""

    def __init__(self, dataset, indices: np.ndarray):
        self._ds = dataset
        self._idx = np.asarray(indices, dtype=np.int64)
        self.seq_len = dataset.seq_len
        self._fetch = _make_fetch(dataset)

    def __len__(self) -> int:
        return len(self._idx)

    def get_batch(self, idx: np.ndarray, epoch: int = 0):
        return self._fetch(self._idx[np.asarray(idx)], epoch)

    def row_lengths(self) -> np.ndarray:
        return self._ds.row_lengths()[self._idx]

    @property
    def shuffle_block(self):
        # A sorted view walks its parent monotonically, so the parent's
        # block-local access survives the indirection; an unsorted one
        # loses it.
        if np.all(np.diff(self._idx) > 0):
            return getattr(self._ds, "shuffle_block", None)
        return None


def train_eval_split(dataset, eval_frac: float, seed: int = 0):
    """(train_view, eval_view): a deterministic shuffled split, each
    view's indices sorted, as the JAX package splits."""
    if not 0.0 < eval_frac < 1.0:
        raise ValueError(f"eval_frac must be in (0, 1), got {eval_frac}")
    n = len(dataset)
    order = np.random.default_rng(seed).permutation(n)
    n_eval = max(1, int(n * eval_frac))
    return (Subset(dataset, np.sort(order[n_eval:])),
            Subset(dataset, np.sort(order[:n_eval])))
