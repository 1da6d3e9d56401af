"""Segment-aware sequence packing — a copy of `proteinbert_tpu/data/
packing.py` (planner, online packer, row assembly), numpy only.

A packed batch is:

    tokens       (B, L)    int32 — each row is the concatenation of the
                           nonpad tokens (<sos> seq <eos>) of up to S
                           proteins, padded with <pad>=0 at the tail;
    segment_ids  (B, L)    int32 — 0 at pad, 1..S at the positions of
                           the row's 1st..S-th protein;
    annotations  (B, S, A) float32 — one annotation vector per packed
                           protein (zero rows for unused slots).

Downstream every cross-position op is segment-masked (the packed model
path, `kernels/fused_block.fused_local_track_segments`,
`kernels/attention.fused_packed_attention`), so a packed row is
numerically a batch of independent proteins.

`PackPlanner`: greedy FIRST-FIT over a bounded set of open rows, closing
the OLDEST row when the open set exceeds its bound — a deterministic
function of the length stream. `OnlinePacker`: the serving sibling, same
placement rule, with payloads and rows popped by the caller (the ragged
scheduler). `make_packed_iterator`: the training feed, the planner over
each epoch's order, in multi-host lockstep.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from proteinbert_tpu_torch.data.dataset import (
    _check_per_host, _epoch_order, _make_fetch,
)
from proteinbert_tpu_torch.data.vocab import PAD_ID

# A closed row slot below this many free positions cannot hold even an
# empty tokenized sequence (<sos><eos>), so the planner closes it early.
_MIN_FIT = 2


class PackPlanner:
    """Greedy first-fit packer over a bounded set of open rows.

    add(row_id, length) -> list of CLOSED rows (each a list of row ids),
    in deterministic closing order; flush() closes everything left.
    """

    def __init__(self, seq_len: int, max_segments: int, max_open: int):
        if max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, got {max_segments}")
        if max_open < 1:
            raise ValueError(f"max_open must be >= 1, got {max_open}")
        self.seq_len = seq_len
        self.max_segments = max_segments
        self.max_open = max_open
        # Each open row: [remaining_capacity, [row_ids...]]
        self._open: List[List] = []

    def add(self, row_id: int, length: int) -> List[List[int]]:
        length = int(min(length, self.seq_len))
        closed: List[List[int]] = []
        placed = None
        for slot in self._open:
            if slot[0] >= length and len(slot[1]) < self.max_segments:
                slot[0] -= length
                slot[1].append(row_id)
                placed = slot
                break
        if placed is None:
            placed = [self.seq_len - length, [row_id]]
            self._open.append(placed)
            if len(self._open) > self.max_open:
                # max_open >= 1, so the popped oldest is never `placed`.
                closed.append(self._open.pop(0)[1])
        # A row that can't take another sequence only wastes first-fit
        # scans — close it now (also bounds per-row segment count).
        if (placed[0] < _MIN_FIT
                or len(placed[1]) >= self.max_segments):
            self._open = [s for s in self._open if s is not placed]
            closed.append(placed[1])
        return closed

    def flush(self) -> List[List[int]]:
        closed = [slot[1] for slot in self._open]
        self._open = []
        return closed


class OnlinePacker:
    """Incremental first-fit packer for online serving.

    Each open row tracks `residual` capacity out of `seq_len` and an
    ordered list of (payload, start, span) items; a row takes a new item
    when `residual >= span` and it holds fewer than `max_segments` items.
    Rows pop oldest-first, so the FIRST item of the FIRST row is always
    the oldest pending payload (the max-wait trigger's anchor).
    """

    __slots__ = ("seq_len", "max_segments", "_rows")

    def __init__(self, seq_len: int, max_segments: int):
        if max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, got {max_segments}")
        if seq_len < _MIN_FIT:
            raise ValueError(f"seq_len must be >= {_MIN_FIT}, got {seq_len}")
        self.seq_len = int(seq_len)
        self.max_segments = int(max_segments)
        # Each row: [residual, [(payload, start, span), ...]]
        self._rows: List[List] = []

    def __len__(self) -> int:
        """Open row count."""
        return len(self._rows)

    def total_items(self) -> int:
        return sum(len(r[1]) for r in self._rows)

    def place(self, payload, span: int) -> int:
        """First-fit one item; returns the row index it landed in."""
        span = int(span)
        if not 0 < span <= self.seq_len:
            raise ValueError(f"span {span} not in (0, {self.seq_len}]")
        for i, row in enumerate(self._rows):
            if row[0] >= span and len(row[1]) < self.max_segments:
                row[1].append((payload, self.seq_len - row[0], span))
                row[0] -= span
                return i
        self._rows.append([self.seq_len - span, [(payload, 0, span)]])
        return len(self._rows) - 1

    def row_heads(self) -> List:
        """The first (oldest) payload of every open row."""
        return [row[1][0][0] for row in self._rows]

    def expire(self, predicate) -> List:
        """Remove every item whose payload satisfies `predicate` and drop
        rows that become empty; returns the removed payloads. A removed
        item's span stays dead space in its row (holes cost capacity, not
        correctness)."""
        removed: List = []
        rows: List[List] = []
        for row in self._rows:
            kept = []
            for item in row[1]:
                if predicate(item[0]):
                    removed.append(item[0])
                else:
                    kept.append(item)
            if kept:
                row[1] = kept
                rows.append(row)
        self._rows = rows
        return removed

    def pop_rows(self, n: int) -> List[List[Tuple]]:
        """Take the oldest `n` rows; each is its ordered
        [(payload, start, span), ...] list."""
        taken, self._rows = self._rows[:n], self._rows[n:]
        return [row[1] for row in taken]

    def drain_items(self) -> List:
        """Abort path: every pending payload, row-major, and reset."""
        items = [p for _, row in self._rows for p, _, _ in row]
        self._rows = []
        return items


def pack_rows(
    fetched_tokens: np.ndarray,
    fetched_annotations: np.ndarray,
    groups: List[List[int]],
    seq_len: int,
    max_segments: int,
) -> Dict[str, np.ndarray]:
    """Assemble per-sequence arrays into a packed batch: `groups[i]` lists
    positions into `fetched_*` for packed row i."""
    B = len(groups)
    A = fetched_annotations.shape[-1]
    tokens = np.zeros((B, seq_len), dtype=np.int32)
    segment_ids = np.zeros((B, seq_len), dtype=np.int32)
    annotations = np.zeros((B, max_segments, A), dtype=np.float32)
    for i, group in enumerate(groups):
        cursor = 0
        for s, pos in enumerate(group):
            row = fetched_tokens[pos]
            n = int((row != PAD_ID).sum())
            n = min(n, seq_len - cursor)
            tokens[i, cursor:cursor + n] = row[:n]
            segment_ids[i, cursor:cursor + n] = s + 1
            annotations[i, s] = fetched_annotations[pos]
            cursor += n
    return {"tokens": tokens, "segment_ids": segment_ids,
            "annotations": annotations}


def pad_fraction(tokens: np.ndarray) -> float:
    """Fraction of pad positions in a (B, L) token batch."""
    return float((tokens == PAD_ID).mean())


def make_packed_iterator(
    dataset,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    num_epochs: Optional[int] = None,
    process_index: int = 0,
    process_count: int = 1,
    skip_batches: int = 0,
    max_segments: int = 8,
    max_open: int = 0,
    metrics=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite (or num_epochs-bounded) per-host PACKED batch iterator:
    {"tokens" (B, L), "segment_ids" (B, L), "annotations" (B, S, A)} with
    B = batch_size, L = dataset.seq_len, S = max_segments.

    Every host runs the SAME planner over the same epoch permutation, so
    all hosts agree on the plan; when `batch_size * process_count` rows
    are ready each host fetches only its slice. `max_open` bounds the
    planner's open rows (0 = 2 × the global batch). `skip_batches` replays
    only the planner bookkeeping, so a resumed run yields the same batches
    without fetching the skipped ones. At the end of a bounded run the
    planner is flushed and every full global batch emitted; the remainder
    (fewer rows than a global batch) is dropped with a warning. `metrics`
    (an obs.MetricsRegistry) receives per-batch
    `data_pad_fraction{strategy="packed"}`, the `data_packed_segments_total`
    and `data_packed_rows_total` counters and, at the end,
    `data_dropped_rows_total{strategy="packed"}`, the JAX iterator's
    names; None = no reporting."""
    n = len(dataset)
    per_host = _check_per_host(n, batch_size, process_count)
    global_batch = batch_size * process_count
    if max_open <= 0:
        max_open = 2 * global_batch
    lengths = np.minimum(dataset.row_lengths(), dataset.seq_len)
    seq_len = dataset.seq_len
    block = getattr(dataset, "shuffle_block", None)
    fetch = _make_fetch(dataset)
    rng = np.random.default_rng(seed)
    gauge = counter_seg = counter_rows = counter_drop = None
    if metrics is not None:
        gauge = metrics.gauge("data_pad_fraction", strategy="packed")
        counter_seg = metrics.counter("data_packed_segments_total")
        counter_rows = metrics.counter("data_packed_rows_total")
        counter_drop = metrics.counter("data_dropped_rows_total",
                                       strategy="packed")
    planner = PackPlanner(seq_len, max_segments, max_open)
    ready: List[List[int]] = []

    def emit(groups: List[List[int]], epoch: int):
        mine = groups[process_index * batch_size:
                      (process_index + 1) * batch_size]
        flat = [r for g in mine for r in g]
        positions, pos = [], 0
        for g in mine:
            positions.append(list(range(pos, pos + len(g))))
            pos += len(g)
        data = fetch(np.asarray(flat, dtype=np.int64), epoch)
        batch = pack_rows(data["tokens"], data["annotations"], positions,
                          seq_len, max_segments)
        if metrics is not None:
            gauge.set(pad_fraction(batch["tokens"]))
            counter_seg.inc(len(flat))
            counter_rows.inc(len(mine))
        return batch

    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = _epoch_order(n, rng, shuffle, block)[:per_host * process_count]
        for i in order:
            ready.extend(planner.add(int(i), int(lengths[i])))
            while len(ready) >= global_batch:
                groups, ready = ready[:global_batch], ready[global_batch:]
                if skip_batches > 0:
                    skip_batches -= 1
                    continue
                yield emit(groups, epoch)
        epoch += 1
    ready.extend(planner.flush())
    while len(ready) >= global_batch:
        groups, ready = ready[:global_batch], ready[global_batch:]
        if skip_batches > 0:
            skip_batches -= 1
            continue
        yield emit(groups, epoch - 1 if epoch else 0)
    dropped = sum(len(g) for g in ready)
    if dropped:
        if counter_drop is not None:
            counter_drop.inc(dropped)
        logging.getLogger(__name__).warning(
            "packed iterator ended with %d pending sequences in %d partial "
            "rows (a sub-global-batch remainder cannot be emitted at a "
            "static shape)", dropped, len(ready))


def unpack_segments(
    batch: Dict[str, np.ndarray],
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split a packed batch back into per-sequence (tokens, annotation)
    pairs, in row-major segment order."""
    out = []
    tokens, seg, ann = (batch["tokens"], batch["segment_ids"],
                        batch["annotations"])
    for b in range(tokens.shape[0]):
        n_seg = int(seg[b].max())
        for s in range(1, n_seg + 1):
            mask = seg[b] == s
            out.append((tokens[b][mask], ann[b, s - 1]))
    return out
