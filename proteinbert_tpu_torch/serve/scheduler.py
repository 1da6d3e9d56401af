"""Continuous micro-batching schedulers — port of
`proteinbert_tpu/serve/scheduler.py` (`MicroBatchScheduler` and the
ragged `PackedBatchScheduler`, serial path: each batch is submitted and
finalized on the scheduler thread, the JAX package's pipeline depth 1).

One daemon thread drains the request queue under a two-knob policy:

- **max_batch**: a (kind, bucket) group that reaches `max_batch` queued
  rows dispatches immediately (throughput bound);
- **max_wait_s**: otherwise a group dispatches when its OLDEST member
  has waited `max_wait_s` (latency bound).

Requests group by (kind, bucket_len): only same-kind, same-bucket rows
share a batch. Within a group FIFO order holds end to end, so the batch
a request rides in is a deterministic function of arrival order and the
clock — tests drive `poll(now=)` single-threaded with a fake clock.

A dispatch failure fails THAT batch's futures and keeps the scheduler
alive for later batches.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from proteinbert_tpu_torch.data.packing import OnlinePacker
from proteinbert_tpu_torch.serve.errors import DeadlineExceededError
from proteinbert_tpu_torch.serve.queue import Request, RequestQueue

logger = logging.getLogger(__name__)

GroupKey = Tuple[str, int]  # (kind, bucket_len)


class MicroBatchScheduler:
    def __init__(
        self,
        queue: RequestQueue,
        dispatcher,
        finalize: Callable[[Request, object], None],
        max_batch: int = 8,
        max_wait_s: float = 0.01,
        clock=time.monotonic,
        latency_observer: Optional[Callable[[float], None]] = None,
        expire_observer: Optional[Callable[[Request], None]] = None,
    ):
        self.queue = queue
        self.dispatcher = dispatcher
        self.finalize = finalize
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.clock = clock
        self._latency = latency_observer or (lambda s: None)
        # Called per deadline-expired request (the Server counts these
        # as rejections).
        self._on_expire = expire_observer or (lambda req: None)
        # Normally scheduler-thread-private, but fail_pending (abort) and
        # pending_rows touch it from other threads.
        self._pending: "collections.OrderedDict[GroupKey, collections.deque]" \
            = collections.OrderedDict()      # guarded-by: _pending_lock
        self._pending_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self.batches_total = 0               # guarded-by: _pending_lock
        self.rows_total = 0                  # guarded-by: _pending_lock
        self.expired_total = 0               # guarded-by: _pending_lock

    # -------------------------------------------------------- formation

    def pending_rows(self) -> int:
        with self._pending_lock:
            return sum(len(d) for d in self._pending.values())

    def stats_counts(self) -> Tuple[int, int, int]:
        """(batches_total, rows_total, expired_total), one locked read."""
        with self._pending_lock:
            return (self.batches_total, self.rows_total,
                    self.expired_total)

    def _ingest(self, now: float) -> None:
        items = self.queue.pop_all()
        if not items:
            return
        with self._pending_lock:
            for req in items:
                key = (req.kind, req.bucket_len)
                group = self._pending.get(key)
                if group is None:
                    group = self._pending[key] = collections.deque()
                group.append(req)

    def _expire_requests(self, expired: List[Request], now: float) -> None:
        with self._pending_lock:
            self.expired_total += len(expired)
        for req in expired:
            req.future.set_exception(DeadlineExceededError(
                f"deadline passed after "
                f"{now - req.enqueued_at:.3f}s waiting for a batch"))
            self._on_expire(req)

    def _expire_pending(self, now: float) -> None:
        expired: List[Request] = []
        with self._pending_lock:
            for key in list(self._pending):
                group = self._pending[key]
                keep = collections.deque()
                for req in group:
                    if req.deadline is not None and now >= req.deadline:
                        expired.append(req)
                    else:
                        keep.append(req)
                if keep:
                    self._pending[key] = keep
                else:
                    del self._pending[key]
        self._expire_requests(expired, now)

    def _select_group(self, now: float) -> Optional[GroupKey]:
        """A full group first (fullest wins, ties to the oldest head),
        else the group whose head has waited past max_wait_s (oldest head
        wins), else — when draining — the oldest head outright."""
        with self._pending_lock:
            full = [(len(g), -g[0].enqueued_at, k)
                    for k, g in self._pending.items()
                    if len(g) >= self.max_batch]
            if full:
                return max(full)[2]
            overdue = [(g[0].enqueued_at, k)
                       for k, g in self._pending.items()
                       if now - g[0].enqueued_at >= self.max_wait_s]
            if overdue:
                return min(overdue)[1]
            if self.queue.closed and self._pending:
                return min((g[0].enqueued_at, k)
                           for k, g in self._pending.items())[1]
            return None

    # --------------------------------------------------------- dispatch

    def _dispatch(self, key: GroupKey, now: float) -> int:
        kind, bucket_len = key
        with self._pending_lock:
            group = self._pending.get(key)
            if not group:  # raced an abort's fail_pending
                return 0
            batch: List[Request] = [group.popleft()
                                    for _ in range(min(self.max_batch,
                                                       len(group)))]
            if not group:
                del self._pending[key]
        tokens = np.stack([r.tokens for r in batch])
        num_ann = self.dispatcher.cfg.model.num_annotations
        annotations = np.stack([
            r.annotations if r.annotations is not None
            else np.zeros(num_ann, np.float32)
            for r in batch])
        try:
            result = self.dispatcher.run(kind, tokens, annotations)
        except Exception as e:  # fail THIS batch, keep serving
            logger.exception("batch dispatch failed (%s, L=%d, rows=%d)",
                             kind, bucket_len, len(batch))
            self._fail(batch, e)
            return len(batch)
        if isinstance(result, dict):
            rows = [{k: v[i] for k, v in result.items()}
                    for i in range(len(batch))]
        else:
            rows = list(result)
        self._complete(batch, rows)
        return len(batch)

    @staticmethod
    def _fail(batch: List[Request], exc: Exception) -> None:
        for req in batch:
            if not req.future.done():
                req.future.set_exception(exc)

    def _complete(self, batch: List[Request], rows: List) -> None:
        """Finalize each request of a dispatched batch with its row."""
        done_t = self.clock()
        for req, row in zip(batch, rows):
            try:
                self.finalize(req, row)
            except Exception as e:
                if not req.future.done():
                    req.future.set_exception(e)
            self._latency(done_t - req.enqueued_at)
        with self._pending_lock:
            self.batches_total += 1
            self.rows_total += len(batch)

    def poll(self, now: Optional[float] = None) -> int:
        """One scheduling step: ingest, expire, dispatch AT MOST one
        micro-batch. Returns rows dispatched (0 = idle)."""
        if now is None:
            now = self.clock()
        self._ingest(now)
        self._expire_pending(now)
        key = self._select_group(now)
        if key is None:
            return 0
        return self._dispatch(key, now)

    # ---------------------------------------------------------- threading

    def run_forever(self) -> None:
        # Idle parking: wake at least every max_wait/2 so an under-full
        # group's max-wait trigger fires on time with no new pushes.
        park = max(min(self.max_wait_s / 2, 0.05), 0.001)
        while not self._stopped.is_set():
            if self.poll():
                continue
            # Drained only when the QUEUE is empty too: after close() no
            # new pushes are admitted, so empty-at-observation is final.
            if (self.queue.closed and not self.pending_rows()
                    and len(self.queue) == 0):
                return
            self.queue.wait(timeout=park)

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._thread = threading.Thread(target=self.run_forever,
                                        name="pbt-serve-scheduler",
                                        daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the drain to finish; True when the thread is gone."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self) -> None:
        """Hard stop (abort path): the loop exits at the next check;
        pending futures are the Server's to fail."""
        self._stopped.set()
        self.queue.close()

    def fail_pending(self, exc: Exception) -> List[Request]:
        """Abort path: fail every not-yet-dispatched request; returns
        the requests that were failed."""
        with self._pending_lock:
            reqs = [req for group in self._pending.values()
                    for req in group]
            self._pending.clear()
        failed = []
        for req in reqs:
            if not req.future.done():
                req.future.set_exception(exc)
                failed.append(req)
        return failed


class PackedBatchScheduler(MicroBatchScheduler):
    """RAGGED packed batch formation: admission places each request into
    an open packed row of its KIND by first-fit at its bucket-quantized
    span (`data/packing.OnlinePacker`); one dispatch runs
    `rows_per_batch` rows through the kind's fixed shape
    (`serve/dispatch.RaggedDispatcher`), carrying up to
    rows_per_batch x max_segments requests.

    Dispatch policy, per KIND:
    - a kind with MORE than `rows_per_batch` open rows dispatches its
      oldest `rows_per_batch` at once (the extra row is the open
      frontier, so the popped rows were already topped off by first-fit);
    - otherwise a kind dispatches when the oldest request of any of its
      open rows has waited `max_wait_s`, padding with empty rows;
    - when the queue is closed (drain), rows flush oldest kind first.

    Deadlines: every poll sweeps open rows (an expired request leaves a
    dead span in its row — capacity, never correctness) and dispatch
    re-checks at pop. Against `poll(now=)` the formation is a
    deterministic function of arrival order and the clock.
    """

    def __init__(
        self,
        queue: RequestQueue,
        dispatcher,
        finalize: Callable[[Request, object], None],
        rows_per_batch: int = 4,
        max_wait_s: float = 0.01,
        clock=time.monotonic,
        max_segments: int = 8,
        latency_observer: Optional[Callable[[float], None]] = None,
        expire_observer: Optional[Callable[[Request], None]] = None,
    ):
        super().__init__(
            queue, dispatcher, finalize, max_batch=rows_per_batch,
            max_wait_s=max_wait_s, clock=clock,
            latency_observer=latency_observer,
            expire_observer=expire_observer)
        self.rows_per_batch = int(rows_per_batch)
        self.max_segments = int(max_segments)
        self.seq_len = int(dispatcher.cfg.data.seq_len)
        # kind -> OnlinePacker of open rows (payloads are Requests).
        self._packers: "collections.OrderedDict[str, OnlinePacker]" = \
            collections.OrderedDict()        # guarded-by: _pending_lock

    # -------------------------------------------------------- formation

    def pending_rows(self) -> int:
        """Pending REQUESTS (not physical packed rows)."""
        with self._pending_lock:
            return sum(p.total_items() for p in self._packers.values())

    def _ingest(self, now: float) -> None:
        items = self.queue.pop_all()
        if not items:
            return
        with self._pending_lock:
            for req in items:
                packer = self._packers.get(req.kind)
                if packer is None:
                    packer = self._packers[req.kind] = OnlinePacker(
                        self.seq_len, self.max_segments)
                packer.place(req, req.bucket_len)

    def _expire_pending(self, now: float) -> None:
        expired: List[Request] = []
        with self._pending_lock:
            for kind in list(self._packers):
                packer = self._packers[kind]
                expired.extend(packer.expire(
                    lambda r: r.deadline is not None and now >= r.deadline))
                if len(packer) == 0:
                    del self._packers[kind]
        self._expire_requests(expired, now)

    def _select_group(self, now: float):
        """A kind holding MORE than rows_per_batch open rows first (most
        rows wins, ties to the oldest head), else the kind whose oldest
        row-head request waited past max_wait_s, else — draining — the
        oldest head outright."""
        def oldest(packer) -> float:
            return min(r.enqueued_at for r in packer.row_heads())

        with self._pending_lock:
            candidates = [(k, p) for k, p in self._packers.items()
                          if len(p)]
            full = [(len(p), -oldest(p), k) for k, p in candidates
                    if len(p) > self.rows_per_batch]
            if full:
                return max(full)[2]
            overdue = [(oldest(p), k) for k, p in candidates
                       if now - oldest(p) >= self.max_wait_s]
            if overdue:
                return min(overdue)[1]
            if self.queue.closed and candidates:
                return min((oldest(p), k) for k, p in candidates)[1]
            return None

    # --------------------------------------------------------- dispatch

    def _dispatch(self, key, now: float) -> int:
        kind = key
        R, L, S = self.rows_per_batch, self.seq_len, self.max_segments
        with self._pending_lock:
            packer = self._packers.get(kind)
            if packer is None or len(packer) == 0:  # raced fail_pending
                return 0
            rows = packer.pop_rows(R)
            if len(packer) == 0:
                del self._packers[kind]
        num_ann = self.dispatcher.cfg.model.num_annotations
        tokens = np.zeros((R, L), np.int32)
        segment_ids = np.zeros((R, L), np.int32)
        annotations = np.zeros((R, S, num_ann), np.float32)
        batch: List[Request] = []
        riders: List[Tuple[int, int, int, int]] = []
        expired: List[Request] = []
        for r, row in enumerate(rows):
            for s, (req, start, span) in enumerate(row):
                if req.deadline is not None and now >= req.deadline:
                    expired.append(req)  # raced in since the last sweep
                    continue
                tokens[r, start:start + span] = req.tokens
                segment_ids[r, start:start + span] = s + 1
                if req.annotations is not None:
                    annotations[r, s] = req.annotations
                batch.append(req)
                riders.append((r, s, start, span))
        self._expire_requests(expired, now)
        if not batch:
            return len(expired)
        try:
            outs = self.dispatcher.run_packed(kind, tokens, segment_ids,
                                              annotations, riders)
        except Exception as e:  # fail THIS batch, keep serving
            logger.exception("packed batch dispatch failed "
                             "(%s, rows=%d, segments=%d)", kind, R,
                             len(batch))
            self._fail(batch, e)
            return len(batch)
        self._complete(batch, outs)
        return len(batch)

    def fail_pending(self, exc: Exception) -> List[Request]:
        with self._pending_lock:
            reqs: List[Request] = []
            for packer in self._packers.values():
                reqs.extend(packer.drain_items())
            self._packers.clear()
        failed = []
        for req in reqs:
            if not req.future.done():
                req.future.set_exception(exc)
                failed.append(req)
        return failed
