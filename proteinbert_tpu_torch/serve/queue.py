"""Thread-safe bounded request queue with admission control — a copy of
`proteinbert_tpu/serve/queue.py`.

The serving front door: client threads `push()` requests, the
scheduler thread drains them. Three contracts, all typed (serve/
errors.py) and all OBSERVED by the affected request's future — nothing
is ever silently dropped:

- **bounded depth / oldest-first rejection**: when the queue is full,
  the OLDEST queued request is evicted and its future fails with
  `QueueFullError`, and the new request is admitted. Newest-work-wins
  is the right default for interactive traffic: the oldest request is
  the one most likely to have already blown its client timeout, so it
  is the cheapest to reject (the classic bounded-mailbox policy).
- **closed state**: after `close()`, `push` raises `ServerClosedError`
  (drain: queued work still completes); `fail_all` empties the queue
  onto an exception (abort).

Per-request deadlines are enforced scheduler-side: every `poll()`
drains the queue via `pop_all()` first, so overdue requests are failed
with `DeadlineExceededError` by `MicroBatchScheduler._expire_pending`
before they waste a batch slot — one expiry implementation, not two.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from proteinbert_tpu_torch.serve.errors import QueueFullError, ServerClosedError


@dataclasses.dataclass
class Request:
    """One admitted unit of work.

    tokens are already sliced to the request's bucket length
    (tokenization + bucket routing happen at submit time on the CLIENT
    thread, keeping the scheduler thread's work per request O(1));
    `deadline` is an absolute clock value or None; `future` carries the
    result or the typed rejection."""

    kind: str
    seq: str
    tokens: np.ndarray                       # (bucket_len,) int32
    bucket_len: int
    future: Future
    enqueued_at: float
    annotations: Optional[np.ndarray] = None  # (A,) float32 or None
    deadline: Optional[float] = None          # absolute clock value
    top_k: Optional[int] = None               # predict_go only
    cache_key: Optional[str] = None           # None = uncacheable/disabled
    trace: Optional[object] = None            # serve/trace.RequestTrace
                                              # (None = telemetry off)
    head: Optional[object] = None             # heads/registry.LoadedHead
                                              # (predict_task only),
                                              # resolved at admission: a
                                              # hot remove_head drains
                                              # queued work instead of
                                              # failing it


class RequestQueue:
    """FIFO of admitted requests, bounded at `max_depth`."""

    def __init__(self, max_depth: int = 64):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self._items: "collections.deque[Request]" = collections.deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False
        self.evicted_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def closed(self) -> bool:
        return self._closed

    def push(self, req: Request) -> List[Request]:
        """Admit one request; returns the evicted requests (oldest-first
        overflow victims — already failed with QueueFullError, returned
        so the caller can count/emit them). Raises ServerClosedError
        when draining/closed."""
        evicted: List[Request] = []
        with self._lock:
            if self._closed:
                raise ServerClosedError(
                    "server is draining; not accepting new requests")
            while len(self._items) >= self.max_depth:
                evicted.append(self._items.popleft())
                self.evicted_total += 1
            self._items.append(req)
            self._nonempty.notify()
        for old in evicted:
            old.future.set_exception(QueueFullError(
                f"queue overflowed (depth {self.max_depth}); oldest "
                "request evicted to admit newer work"))
        return evicted

    def pop_all(self) -> List[Request]:
        """Drain every queued request (scheduler side)."""
        with self._lock:
            items = list(self._items)
            self._items.clear()
        return items

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is non-empty or closed; True if there
        is (probably) work. The scheduler's idle parking spot."""
        with self._lock:
            if self._items or self._closed:
                return bool(self._items)
            self._nonempty.wait(timeout)
            return bool(self._items)

    def close(self) -> None:
        """Stop admitting; queued work remains for the drain."""
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()

    def fail_all(self, exc: Exception) -> List[Request]:
        """Abort path: empty the queue onto `exc`; returns the failed
        requests."""
        failed = self.pop_all()
        for req in failed:
            req.future.set_exception(exc)
        return failed
