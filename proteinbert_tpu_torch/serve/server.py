"""`Server` — the online-inference facade, bucketed and ragged modes —
port of `proteinbert_tpu/serve/server.py`.

Ties the queue, scheduler, dispatcher and cache together behind the
capabilities of the offline surface (inference.py): `embed`,
`predict_go`, `predict_residues`, each a blocking call or a `submit()`
future.

Request life cycle:

  submit() [client thread]                    scheduler thread
  ├─ over-length policy (reject/truncate+count)
  ├─ tokenize + bucket-route (serve/dispatch)
  ├─ cache lookup — a hit returns a resolved future, nothing enqueues
  └─ queue.push (may evict the oldest    ──►  poll(): group by
     request with QueueFullError)             (kind, bucket), dispatch at
                                              max_batch/max_wait, then
                                              finalize per row: cache put
                                              + future.set_result

`serve_mode="ragged"` replaces the (kind, bucket) grouping with packing:
requests pack into fixed-shape (max_batch rows, seq_len) batches at their
bucket-quantized spans (`RaggedDispatcher`, `PackedBatchScheduler`), up to
`pack_max_segments` per row, and answer as the bucketed mode does.

`quant="int8"` serves int8 weights quantized once at load (either mode;
`"int8_act"` adds int8 fake-quant of the trunk's outputs, bucketed only),
with a fp32 parity shadow every `quant_parity_every` batches; None takes
`cfg.serve.quant` / `cfg.serve.quant_parity_every`. `stats()["quant"]`
reports the arm (serve/dispatch.py).

Shutdown is two-mode: `drain()` closes the queue (new submits raise
ServerClosedError), finishes every queued request, then stops the
scheduler; `abort()` fails queued and pending work with
ServerClosedError.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np

from proteinbert_tpu_torch import DeviceLike
from proteinbert_tpu_torch import inference
from proteinbert_tpu_torch.configs import PretrainConfig
from proteinbert_tpu_torch.serve.cache import EmbeddingCache, content_key
from proteinbert_tpu_torch.serve.dispatch import (
    KINDS, BucketDispatcher, RaggedDispatcher,
)
from proteinbert_tpu_torch.serve.errors import (
    SequenceTooLongError, ServerClosedError,
)
from proteinbert_tpu_torch.serve.queue import Request, RequestQueue
from proteinbert_tpu_torch.serve.scheduler import (
    MicroBatchScheduler, PackedBatchScheduler,
)

REJECT_REASONS = ("queue_full", "deadline", "too_long", "closed")
SERVE_MODES = ("bucketed", "ragged")


def nearest_rank(sorted_values, fraction: float) -> Optional[float]:
    """Nearest-rank pick from an ascending list; `fraction` in [0, 1]."""
    if not sorted_values:
        return None
    idx = min(len(sorted_values) - 1,
              max(0, int(round(fraction * (len(sorted_values) - 1)))))
    return sorted_values[idx]


class LatencyWindow:
    """Bounded ring of recent request latencies with percentile reads
    (a local copy of the JAX package's obs QuantileWindow). Thread-safe:
    the scheduler observes while stats() reads from client threads."""

    def __init__(self, capacity: int = 2048):
        self._ring: "collections.deque[float]" = collections.deque(
            maxlen=capacity)               # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._ring.append(float(seconds))

    def summary(self) -> Dict[str, Optional[float]]:
        with self._lock:
            if not self._ring:
                return {"n": 0, "p50_s": None, "p99_s": None, "mean_s": None}
            data = sorted(self._ring)
        return {"n": len(data),
                "p50_s": round(nearest_rank(data, 0.50), 6),
                "p99_s": round(nearest_rank(data, 0.99), 6),
                "mean_s": round(sum(data) / len(data), 6)}


class Server:
    """Online serving facade over a trunk on `device` (None → "cuda")."""

    def __init__(
        self,
        params,
        cfg: PretrainConfig,
        *,
        device: DeviceLike = None,
        buckets=None,
        max_batch: int = 8,
        max_wait_s: float = 0.01,
        queue_depth: int = 64,
        cache_size: int = 1024,
        default_deadline_s: Optional[float] = None,
        on_long: str = "truncate",
        clock=time.monotonic,
        warm_kinds=("embed",),
        batch_classes=None,
        serve_mode: str = "bucketed",
        pack_max_segments: int = 8,
        quant: Optional[str] = None,
        quant_parity_every: Optional[int] = None,
    ):
        if on_long not in ("truncate", "reject"):
            raise ValueError(f"on_long must be 'truncate' or 'reject', "
                             f"got {on_long!r}")
        if serve_mode not in SERVE_MODES:
            raise ValueError(f"serve_mode must be one of {SERVE_MODES}, "
                             f"got {serve_mode!r}")
        if quant is None:
            quant = cfg.serve.quant
        if quant_parity_every is None:
            quant_parity_every = cfg.serve.quant_parity_every
        self.quant = quant
        self.cfg = cfg
        self.on_long = on_long
        self.default_deadline_s = default_deadline_s
        self.clock = clock
        self.cache = EmbeddingCache(cache_size)
        self.queue = RequestQueue(queue_depth)
        self.latencies = LatencyWindow()
        self.serve_mode = serve_mode
        if serve_mode == "ragged":
            # `max_batch` means packed ROWS per batch here; a batch
            # carries up to max_batch * pack_max_segments requests.
            if batch_classes is not None:
                raise ValueError(
                    "batch_classes is meaningless in ragged mode — the "
                    "device shape is fixed at (max_batch, seq_len)")
            self.dispatcher = RaggedDispatcher(
                params, cfg, buckets=buckets, rows_per_batch=max_batch,
                max_segments=pack_max_segments, device=device, quant=quant,
                quant_parity_every=quant_parity_every)
            self.scheduler = PackedBatchScheduler(
                self.queue, self.dispatcher, self._finalize,
                rows_per_batch=max_batch, max_wait_s=max_wait_s,
                clock=clock, max_segments=pack_max_segments,
                latency_observer=self.latencies.observe,
                expire_observer=self._count_expiry)
        else:
            self.dispatcher = BucketDispatcher(
                params, cfg, buckets=buckets, max_batch=max_batch,
                batch_classes=batch_classes, device=device, quant=quant,
                quant_parity_every=quant_parity_every)
            self.scheduler = MicroBatchScheduler(
                self.queue, self.dispatcher, self._finalize,
                max_batch=max_batch, max_wait_s=max_wait_s, clock=clock,
                latency_observer=self.latencies.observe,
                expire_observer=self._count_expiry)
        self._warm_kinds = tuple(warm_kinds)
        self._started = False
        self.completed_total = 0  # one writer: the scheduler thread
        # Bumped from concurrent client threads: the read-modify-write
        # needs the lock.
        self._mirror_lock = threading.Lock()
        self.cache_hit_returns = 0           # guarded-by: _mirror_lock
        self.truncated_total = 0             # guarded-by: _mirror_lock
        self.rejected_total = {r: 0 for r in REJECT_REASONS}

    def _bump(self, mirror: str, reason: Optional[str] = None) -> None:
        with self._mirror_lock:
            if reason is None:
                setattr(self, mirror, getattr(self, mirror) + 1)
            else:
                self.rejected_total[reason] += 1

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "Server":
        """Warm the shape classes and start the scheduler."""
        if self._started:
            raise RuntimeError("server already started")
        self.dispatcher.warmup(self._warm_kinds)
        self.scheduler.start()
        self._started = True
        return self

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close(drain=exc_type is None)
        return False

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting, finish everything queued,
        then stop. Returns False if the scheduler did not exit within
        `timeout`."""
        self.queue.close()
        return self.scheduler.join(timeout)

    def abort(self) -> None:
        """Hard shutdown: fail all queued + pending work with
        ServerClosedError. A batch already running finishes normally."""
        self.scheduler.stop()
        exc = ServerClosedError("server aborted before this request ran")
        self.queue.fail_all(exc)
        self.scheduler.join(timeout=30.0)
        self.scheduler.fail_pending(exc)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        if drain:
            self.drain(timeout)
        else:
            self.abort()

    # ------------------------------------------------------------- submit

    def submit(self, kind: str, seq: str, annotations=None,
               deadline_s: Optional[float] = None,
               top_k: Optional[int] = None) -> Future:
        """Enqueue one request; returns its future. Raises
        SequenceTooLongError (on_long="reject", or a '?' beyond the
        window for predict_residues) and ServerClosedError synchronously;
        QueueFullError / DeadlineExceededError land on futures (the
        evicted/expired request's — never silently dropped)."""
        if kind not in KINDS:
            raise ValueError(f"unknown request kind {kind!r}; have {KINDS}")
        if not seq:
            raise ValueError("empty sequence")
        window = self.cfg.data.seq_len - 2
        if len(seq) > window:
            if (self.on_long == "reject"
                    or (kind == "predict_residues"
                        and inference.MASK_CHAR in seq[window:])):
                self._bump("rejected_total", "too_long")
                raise SequenceTooLongError(
                    f"sequence of {len(seq)} residues exceeds the model "
                    f"window of {window}"
                    + (" (and masks a position the model would never "
                       "see)" if kind == "predict_residues" else
                       "; the server is configured to reject rather "
                       "than truncate"))
            self._bump("truncated_total")
        if annotations is not None:
            annotations = inference.check_annotations(
                np.asarray(annotations, np.float32)[None], 1, self.cfg)[0]
        future: Future = Future()
        key = None
        if self.cache.capacity:
            key = content_key(kind, seq, annotations)
            hit = self.cache.get(key)
            if hit is not None:
                self._bump("cache_hit_returns")
                future.set_result(self._present(kind, hit, top_k))
                return future
        bucket_len = self.dispatcher.bucket_len(len(seq))
        tokens = inference._tokenize_masked(
            [seq], self.cfg.data.seq_len, on_overflow="count")[0, :bucket_len]
        now = self.clock()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = Request(
            kind=kind, seq=seq, tokens=tokens, bucket_len=bucket_len,
            future=future, enqueued_at=now, annotations=annotations,
            deadline=(now + deadline_s if deadline_s is not None else None),
            top_k=top_k, cache_key=key)
        try:
            evicted = self.queue.push(req)
        except ServerClosedError:
            self._bump("rejected_total", "closed")
            raise
        for _ in evicted:
            self._bump("rejected_total", "queue_full")
        return future

    # -------------------------------------------------------- sync facade

    def embed(self, seq: str, annotations=None,
              timeout: Optional[float] = None,
              deadline_s: Optional[float] = None) -> Dict[str, np.ndarray]:
        """{"global": (G,), "local_mean": (C,)} float32 for one
        sequence — the serving form of inference.embed."""
        return self.submit("embed", seq, annotations,
                           deadline_s=deadline_s).result(timeout)

    def predict_go(self, seq: str, top_k: Optional[int] = None,
                   timeout: Optional[float] = None,
                   deadline_s: Optional[float] = None):
        """(A,) sigmoid probabilities, or the top-k
        [(annotation_index, prob), ...] list."""
        return self.submit("predict_go", seq, top_k=top_k,
                           deadline_s=deadline_s).result(timeout)

    def predict_residues(self, seq: str, timeout: Optional[float] = None,
                         deadline_s: Optional[float] = None):
        """(filled_seq, probs (bucket_len, V)) — '?' positions filled
        with the argmax amino acid, like inference.predict_residues."""
        return self.submit("predict_residues", seq,
                           deadline_s=deadline_s).result(timeout)

    # ------------------------------------------------------- finalization

    def _present(self, kind: str, value, top_k: Optional[int]):
        """Shape a cached/computed value for one caller (top_k is a
        per-request view over the cached full probability row)."""
        if kind == "predict_go" and top_k is not None:
            probs = value
            k = min(top_k, probs.shape[0])
            idx = np.argsort(-probs)[:k]
            return [(int(j), float(probs[j])) for j in idx]
        return value

    def _finalize(self, req: Request, row) -> None:
        """Scheduler callback: one request's model row → its result
        (+ cache insert)."""
        if req.kind == "embed":
            value = {"global": np.asarray(row["global"]),
                     "local_mean": np.asarray(row["local_mean"])}
        elif req.kind == "predict_go":
            value = np.asarray(row)
        else:  # predict_residues: fill '?' via the argmax amino acid
            probs = np.asarray(row)
            value = (inference.fill_masked_residues(
                req.seq, probs, self.cfg.data.seq_len - 2), probs)
        if req.cache_key is not None:
            self.cache.put(req.cache_key, value)
        self.completed_total += 1
        if not req.future.done():
            req.future.set_result(self._present(req.kind, value, req.top_k))

    def _count_expiry(self, req: Request) -> None:
        self._bump("rejected_total", "deadline")

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._mirror_lock:
            mirrors = {
                "cache_hit_returns": self.cache_hit_returns,
                "truncated": self.truncated_total,
                "rejected": dict(self.rejected_total),
            }
        batches, rows, expired = self.scheduler.stats_counts()
        return {
            "mode": self.serve_mode,
            "completed": self.completed_total,
            **mirrors,
            "warmup_seconds": round(self.dispatcher.warmup_seconds_total, 6),
            "batches": batches,
            "batched_rows": rows,
            "queue_depth": len(self.queue),
            "evicted": self.queue.evicted_total,
            "expired": expired,
            "cache": self.cache.stats(),
            "latency": self.latencies.summary(),
            "quant": ({"mode": self.quant, **self.dispatcher.quant_report}
                      if self.quant != "fp32" else None),
        }
