"""Continuous micro-batching scheduler — port of
`proteinbert_tpu/serve/scheduler.py` (`MicroBatchScheduler`, serial
path: each batch is submitted and finalized on the scheduler thread, the
JAX package's pipeline depth 1).

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

    def _ingest(self) -> None:
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
            self.expired_total += len(expired)
        for req in expired:
            req.future.set_exception(DeadlineExceededError(
                f"deadline passed after "
                f"{now - req.enqueued_at:.3f}s waiting for a batch"))
            self._on_expire(req)

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

    def _dispatch(self, key: GroupKey) -> int:
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
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            return len(batch)
        done_t = self.clock()
        for i, req in enumerate(batch):
            if isinstance(result, dict):
                row = {k: v[i] for k, v in result.items()}
            else:
                row = result[i]
            try:
                self.finalize(req, row)
            except Exception as e:
                if not req.future.done():
                    req.future.set_exception(e)
            self._latency(done_t - req.enqueued_at)
        with self._pending_lock:
            self.batches_total += 1
            self.rows_total += len(batch)
        return len(batch)

    def poll(self, now: Optional[float] = None) -> int:
        """One scheduling step: ingest, expire, dispatch AT MOST one
        micro-batch. Returns rows dispatched (0 = idle)."""
        if now is None:
            now = self.clock()
        self._ingest()
        self._expire_pending(now)
        key = self._select_group(now)
        if key is None:
            return 0
        return self._dispatch(key)

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
