"""Background batch prefetching — port of `proteinbert_tpu/data/prefetch.py`.

The train step is enqueued on the card asynchronously, so the host is free
while the card computes; what is left to hide is the HOST cost of making
the next batch (HDF5 reads, tokenization, numpy gathers). One daemon
thread fills a queue of `depth` batches; `prefetch()` wraps any batch
iterator.

The producer thread makes numpy only: it runs the source iterator and
touches no tensor and no CUDA stream. The batch goes to the card on the
train thread, inside the step (`train/train_state.py`), so no stream or
event ordering between the two threads is needed.

An exception raised by the source iterator is re-raised at the consumer's
`next()` with its own traceback, and `close()` (or garbage collection)
stops the thread: it leaves within one 0.1 s put attempt.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

_SENTINEL = object()


class PrefetchIterator:
    """Iterator over `source` with `depth` batches produced ahead.

    `wait_s` sums the seconds the CONSUMER spent blocked on an empty queue
    (the host feed falling behind the card) and `batches` counts the
    batches delivered: the trainer exports them as the `data_wait_seconds`
    and `data_batches_total` gauges."""

    def __init__(self, source: Iterator, depth: int = 2):
        self._stop = threading.Event()  # first: __del__ reads it
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._error = None
        self._done = False
        self._source = source
        self.wait_s = 0.0
        self.batches = 0
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._source:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._error = e
        while not self._stop.is_set():
            try:
                self._q.put(_SENTINEL, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def _raise_pending_error(self):
        """Re-raise the producer's exception on the consumer, with the
        producer frame's traceback."""
        err, self._error = self._error, None
        self._done = True
        raise err.with_traceback(err.__traceback__)

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                # The producer is gone only after its sentinel or after
                # close(): nothing more comes, so never block forever; a
                # producer that died on an exception surfaces it here.
                if self._stop.is_set() or not self._thread.is_alive():
                    if self._error is not None:
                        self.wait_s += time.perf_counter() - t0
                        self._raise_pending_error()
                    self._done = True
                    raise StopIteration from None
        self.wait_s += time.perf_counter() - t0
        if item is _SENTINEL:
            if self._error is not None:
                self._raise_pending_error()
            self._done = True
            raise StopIteration
        self.batches += 1
        return item

    def close(self):
        self._stop.set()

    def __del__(self):
        self.close()


def prefetch(source: Iterator, depth: int = 2) -> PrefetchIterator:
    """`source` with its batches produced `depth` ahead on a background
    thread (depth 0 is the caller's choice: pass the source through)."""
    return PrefetchIterator(source, depth)
