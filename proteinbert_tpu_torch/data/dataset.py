"""Pretraining datasets and batch iterators — port of
`proteinbert_tpu/data/dataset.py`.

`InMemoryPretrainingDataset` tokenizes a table of sequences and
annotations into dense numpy arrays once. `HDF5PretrainingDataset` reads
the reference's HDF5 corpus lazily (`seqs`, `seq_lengths`,
`annotation_masks`, `included_annotations`): raw strings and annotation
rows are cached per block of `BLOCK` rows and tokenized per batch.
`make_pretrain_iterator` yields shuffled, per-host sharded CLEAN
{"tokens", "annotations"} numpy batches (corruption happens on the
device, `data/corruption.py`); `make_bucketed_iterator` yields them
length-bucketed, each batch sliced to its bucket's length, with the
global-batch bookkeeping that keeps hosts in lockstep and a `metrics`
registry (`data_pad_fraction` and `data_dropped_rows_total`,
`strategy="bucketed"`). `skip_batches` fast-forwards a resumed run
without loading the consumed batches. Row order, shards, buckets and crop
windows are the JAX package's, so the same seed gives the same token
ids. `row_lengths`, `_epoch_order` and `_make_fetch` are also what the
packed iterator (`data/packing.py`) reads from a dataset.
"""

from __future__ import annotations

import collections
import inspect
import logging
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

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        """Epoch-0 view of row i: sugar for `get_row(i)`, through the one
        gather `get_batch` (so `ds[i]` is `get_batch([i])` row 0)."""
        return self.get_row(i)

    def get_row(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        batch = self.get_batch(np.array([int(i)]), epoch=epoch)
        return {k: v[0] for k, v in batch.items()}

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


class HDF5PretrainingDataset:
    """Lazy reader of the reference's HDF5 corpus (`seqs`, `seq_lengths`,
    `annotation_masks`; the layout `proteinbert_tpu.etl.h5_builder`
    writes). Raw strings and annotation rows are cached per block of
    `BLOCK` rows (an LRU of `cache_blocks` blocks) and tokenized per
    batch; rows longer than seq_len-2 take a counter-based crop window per
    (crop_seed, epoch, row) when `crop_seed` is given, else the head."""

    BLOCK = 1024

    def __init__(self, h5_path: str, seq_len: int, cache_blocks: int = 8,
                 crop_seed: Optional[int] = None):
        import h5py  # local import: only a corpus reader needs it

        self._f = h5py.File(h5_path, "r")
        self.seq_len = seq_len
        self.crop_seed = crop_seed
        self._n = int(self._f["seq_lengths"].shape[0])
        self.num_annotations = int(self._f["annotation_masks"].shape[1])
        self._cache: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict())
        self._cache_blocks = cache_blocks

    def __len__(self) -> int:
        return self._n

    def row_lengths(self) -> np.ndarray:
        """(N,) tokenized lengths incl. <sos>/<eos>, capped at seq_len
        (crop-invariant: a crop moves the window, not the length), from
        the `seq_lengths` column."""
        raw = self._f["seq_lengths"][:].astype(np.int64)
        return np.minimum(raw + 2, self.seq_len)

    @property
    def shuffle_block(self) -> int:
        return self.BLOCK

    def _load_block(self, b: int):
        blk = self._cache.get(b)
        if blk is None:
            lo, hi = b * self.BLOCK, min((b + 1) * self.BLOCK, self._n)
            raw = self._f["seqs"][lo:hi]
            seqs = [s.decode() if isinstance(s, bytes) else str(s)
                    for s in raw]
            ann = self._f["annotation_masks"][lo:hi].astype(np.float32)
            blk = (seqs, ann)
            self._cache[b] = blk
            if len(self._cache) > self._cache_blocks:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(b)
        return blk

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        """Epoch-0 view of row i: sugar for `get_row(i)`."""
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self.get_row(i)

    def get_row(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        batch = self.get_batch(np.array([int(i)]), epoch=epoch)
        return {k: v[0] for k, v in batch.items()}

    def get_batch(self, idx: np.ndarray,
                  epoch: int = 0) -> Dict[str, np.ndarray]:
        """Gather grouped by block, so each block is read and decoded
        once a batch."""
        order = np.argsort(idx // self.BLOCK, kind="stable")
        seqs_out: list = [None] * len(idx)
        ann_out: list = [None] * len(idx)
        for pos in order:
            i = int(idx[pos])
            seqs, ann = self._load_block(i // self.BLOCK)
            j = i % self.BLOCK
            seqs_out[pos] = seqs[j]
            ann_out[pos] = ann[j]
        return {
            "tokens": tokenize_batch(
                seqs_out, self.seq_len, _window_seed(self.crop_seed, epoch),
                np.asarray(idx, np.int64)),
            "annotations": np.stack(ann_out),
        }

    def close(self) -> None:
        self._f.close()


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


def make_bucketed_iterator(
    dataset,
    batch_size: int,
    buckets: Sequence[int],
    seed: int = 0,
    shuffle: bool = True,
    num_epochs: Optional[int] = None,
    process_index: int = 0,
    process_count: int = 1,
    skip_batches: int = 0,
    metrics=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Length-bucketed batch iterator: each row goes to the smallest
    bucket that holds its tokenized length, and a bucket emits a batch,
    sliced to the bucket's length, when it holds a GLOBAL batch
    (batch_size · process_count rows); each host then fetches only its
    slice, so every host runs the same bookkeeping and yields the same
    shapes step by step. `batch_size` is per host.

    Buckets must be ascending ints, the last equal to the dataset's
    seq_len. `skip_batches` replays only the bookkeeping (no data is
    fetched). Bucket remainders carry over epoch boundaries and are
    dropped only when the iterator ends (`num_epochs` reached); with a
    `metrics` registry the drop is counted in
    `data_dropped_rows_total{strategy="bucketed"}` and each batch sets
    `data_pad_fraction{strategy="bucketed"}`, the names the packed
    iterator reports."""
    if isinstance(buckets, str) or not hasattr(buckets, "__iter__"):
        raise ValueError(
            f"buckets must be a sequence of ints, got {buckets!r} "
            "(e.g. --set data.buckets=[512,1024,2048])")
    try:
        buckets = sorted(int(b) for b in buckets)
    except (TypeError, ValueError):
        raise ValueError(f"buckets must be ints, got {buckets!r}") from None
    if buckets[-1] != dataset.seq_len:
        raise ValueError(
            f"last bucket {buckets[-1]} must equal dataset seq_len "
            f"{dataset.seq_len}")
    lengths = dataset.row_lengths()
    n = len(dataset)
    per_host = _check_per_host(n, batch_size, process_count)
    global_batch = batch_size * process_count
    bucket_of = np.searchsorted(buckets, lengths)  # crop-invariant

    block = getattr(dataset, "shuffle_block", None)
    fetch = _make_fetch(dataset)
    rng = np.random.default_rng(seed)
    pending: Dict[int, list] = {b: [] for b in range(len(buckets))}
    pad_gauge = drop_counter = None
    if metrics is not None:
        pad_gauge = metrics.gauge("data_pad_fraction", strategy="bucketed")
        drop_counter = metrics.counter("data_dropped_rows_total",
                                       strategy="bucketed")
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = _epoch_order(n, rng, shuffle, block)[:per_host * process_count]
        for i in order:
            b = int(bucket_of[i])
            pending[b].append(i)
            if len(pending[b]) < global_batch:
                continue
            rows = pending[b]
            pending[b] = []
            if skip_batches > 0:
                skip_batches -= 1
                continue
            mine = np.asarray(rows[process_index * batch_size:
                                   (process_index + 1) * batch_size])
            batch = fetch(mine, epoch)
            batch["tokens"] = batch["tokens"][:, :buckets[b]]
            if pad_gauge is not None:
                pad_gauge.set(float((batch["tokens"] == 0).mean()))
            yield batch
        epoch += 1
    # End of data: a sub-global-batch remainder cannot be emitted at a
    # static shape; every host counts the same rows.
    dropped = sum(len(rows) for rows in pending.values())
    if dropped:
        if drop_counter is not None:
            drop_counter.inc(dropped)
        logging.getLogger(__name__).warning(
            "bucketed iterator ended with %d pending rows across %d "
            "buckets (static batch shapes cannot emit partial batches); "
            "counted in data_dropped_rows_total", dropped,
            sum(1 for rows in pending.values() if rows))


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

    def __getitem__(self, i: int):
        return self.get_row(i)

    def get_row(self, i: int, epoch: int = 0):
        batch = self.get_batch(np.array([int(i)]), epoch=epoch)
        return {k: v[0] for k, v in batch.items()}

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
