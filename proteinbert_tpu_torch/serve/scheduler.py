"""Continuous micro-batching schedulers — port of
`proteinbert_tpu/serve/scheduler.py` (`MicroBatchScheduler`, the ragged
`PackedBatchScheduler` and the pipelined in-flight window).

One daemon thread drains the request queue under a two-knob policy:

- **max_batch**: a (kind, bucket) group that reaches `max_batch` queued
  rows dispatches immediately (throughput bound);
- **max_wait_s**: otherwise a group dispatches when its OLDEST member
  has waited `max_wait_s` (latency bound).

Task heads: every `predict_task` request has the kind "predict_task",
whatever head it names, so one micro-batch (bucketed) or one packed batch
(ragged) mixes heads: the dispatcher runs the shared trunk once and each
distinct head's tail, and each request keeps its own head's output. The
request carries the head it was admitted with (`Request.head`), so a head
removed meanwhile still answers its queued requests.

Requests group by (kind, bucket_len): only same-kind, same-bucket rows
share a warm shape. Within a group FIFO order holds end to end, so the
batch a request rides in is a deterministic function of arrival order and
the clock — tests drive `poll(now=)` single-threaded with a fake clock.

Pipelined dispatch: a dispatch SUBMITS the batch (`run_timed_async` →
an `InFlightBatch`, once the batch is enqueued on the card) into a
bounded window of `pipeline_depth` batches; FINALIZE (wait for the
device, per-request fan-out, future sealing) happens on a completer
thread that `start()` runs when the depth is above 1, so batch N+1 forms
and is submitted while batch N computes. Without a completer (depth 1, or
`poll()` driven by hand) every submit finalizes inline — the serial path,
bit for bit, which keeps the fake-clock formation tests deterministic.
Drain and abort resolve every batch already submitted exactly once.

A dispatch failure fails THAT batch's futures and keeps the scheduler
alive for later batches; the error is also a `note` on the telemetry
stream.

Observability: every request's queue wait (push → popped for dispatch)
lands in the `serve_queue_wait_seconds` histogram plus a local mirror for
`Server.stats()`; batches feed `serve_batch_seconds`, `serve_batch_rows`,
`serve_batch_occupancy`, `serve_finalize_seconds`,
`serve_inflight_batches` and `serve_overlap_ratio`, and emit
`serve_batch` / `serve_reject` events. Requests that carry a
`RequestTrace` get per-stage clock marks (ingest / pop / execute) and a
terminal `complete_observer` callback (outcome ∈ ok/error/expired) the
Server uses to seal the trace. All marks use the injected clock.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from proteinbert_tpu_torch.data.packing import OnlinePacker
from proteinbert_tpu_torch.obs import as_telemetry
from proteinbert_tpu_torch.obs.metrics import Histogram
from proteinbert_tpu_torch.serve.errors import DeadlineExceededError
from proteinbert_tpu_torch.serve.queue import Request, RequestQueue

logger = logging.getLogger(__name__)

GroupKey = Tuple[str, int]  # (kind, bucket_len)


class _ReadyBatch:
    """An already-resolved result wearing the in-flight handle shape —
    for stub dispatchers with no `run_*_async` entry (their blocking call
    already happened on the scheduler thread)."""

    def __init__(self, result, timings):
        self._result = (result, timings)

    def finalize(self):
        return self._result


class _FailedBatch:
    """A submit-time dispatch failure carried through the in-flight
    window so the ONE finalize path handles every batch outcome; the
    original traceback rides on the exception object."""

    def __init__(self, exc: BaseException):
        self._exc = exc

    def finalize(self):
        raise self._exc


class MicroBatchScheduler:
    def __init__(
        self,
        queue: RequestQueue,
        dispatcher,
        finalize: Callable[[Request, object], None],
        max_batch: int = 8,
        max_wait_s: float = 0.01,
        clock=time.monotonic,
        telemetry=None,
        latency_observer: Optional[Callable[[float], None]] = None,
        expire_observer: Optional[Callable[[Request], None]] = None,
        complete_observer: Optional[
            Callable[[Request, str, float, Optional[BaseException],
                      Optional[dict]], None]] = None,
        replica_id: Optional[str] = None,
        pipeline_depth: int = 2,
    ):
        self.queue = queue
        self.dispatcher = dispatcher
        self.finalize = finalize
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.clock = clock
        # Stamped onto every serve_batch event.
        self.replica_id = replica_id
        self._replica_fields = (
            {"replica_id": replica_id} if replica_id else {})
        self.tele = as_telemetry(telemetry)
        self._latency = latency_observer or (lambda s: None)
        # Called per deadline-expired request (the Server counts these
        # as rejections).
        self._on_expire = expire_observer or (lambda req: None)
        # Called once per terminal request the scheduler decides
        # (outcome "ok" | "error" | "expired", with the clock's now, the
        # error if any, and batch context) — the trace/SLO hook.
        self._on_complete = complete_observer or (
            lambda req, outcome, now, err, ctx: None)
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
        self._occupancy_g = self.tele.metrics.gauge("serve_batch_occupancy")
        self._rows_h = self.tele.metrics.histogram("serve_batch_rows")
        self._batch_h = self.tele.metrics.histogram("serve_batch_seconds")
        self._qwait_h = self.tele.metrics.histogram(
            "serve_queue_wait_seconds")
        # Live mirror for Server.stats(): under NULL telemetry the
        # registry instrument is a shared no-op.
        self.queue_wait = Histogram()
        # Timed dispatch (prep/device split + pad scan) costs an
        # O(rows*L) token scan per batch, so it runs only when something
        # consumes it: a sampled rider in the batch, or this flag (the
        # Server sets it when SLO attribution needs every request).
        self.time_batches = False
        # The in-flight window between SUBMIT and FINALIZE (module doc).
        # The Condition is also the mutex of the fields annotated with
        # it.
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._inflight_lock = threading.Condition()
        self._inflight = collections.deque()  # guarded-by: _inflight_lock
        self.inflight_max = 0                 # guarded-by: _inflight_lock
        self.finalize_seconds_total = 0.0     # guarded-by: _inflight_lock
        self.overlap_seconds_total = 0.0      # guarded-by: _inflight_lock
        self._completer: Optional[threading.Thread] = None
        self._completer_stop = threading.Event()
        self._inflight_g = self.tele.metrics.gauge("serve_inflight_batches")
        self._overlap_g = self.tele.metrics.gauge("serve_overlap_ratio")
        self._finalize_h = self.tele.metrics.histogram(
            "serve_finalize_seconds")

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
                if req.trace is not None:
                    req.trace.mark_ingested(now)
                key = (req.kind, req.bucket_len)
                group = self._pending.get(key)
                if group is None:
                    group = self._pending[key] = collections.deque()
                group.append(req)

    def _observe_wait(self, req: Request, now: float) -> None:
        wait = max(0.0, now - req.enqueued_at)
        self._qwait_h.observe(wait)
        self.queue_wait.observe(wait)

    def _expire_requests(self, expired: List[Request], now: float) -> None:
        if not expired:
            return
        # Depth at rejection time: what is still ahead of a new arrival,
        # after dropping the expired rows themselves.
        depth = self.pending_rows() + len(self.queue)
        with self._pending_lock:
            self.expired_total += len(expired)
        for req in expired:
            self._observe_wait(req, now)
            req.future.set_exception(DeadlineExceededError(
                f"deadline passed after "
                f"{now - req.enqueued_at:.3f}s waiting for a batch"))
            self.tele.emit("serve_reject", reason="deadline",
                           kind=req.kind, queue_depth=depth)
            self._on_expire(req)
            self._on_complete(req, "expired", now, None, None)

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
        # A dispatcher without a class ladder (a stub) runs the rows
        # as they are.
        batch_class = getattr(self.dispatcher, "batch_class", None)
        cls = len(batch) if batch_class is None else batch_class(len(batch))
        tracing = False
        timed = self.time_batches
        for req in batch:
            self._observe_wait(req, now)
            if req.trace is not None:
                tracing = True
                if req.trace.sampled:
                    timed = True
                req.trace.mark_popped(now)
        tokens = np.stack([r.tokens for r in batch])
        num_ann = self.dispatcher.cfg.model.num_annotations
        annotations = np.stack([
            r.annotations if r.annotations is not None
            else np.zeros(num_ann, np.float32)
            for r in batch])
        ctx = {"rows": len(batch), "batch_class": cls,
               "bucket_len": bucket_len}
        # predict_task rows carry their own head: the dispatcher runs the
        # shared trunk once and each head's tail.
        heads = ([r.head for r in batch]
                 if batch[0].head is not None else None)
        extra = {"heads": heads} if heads is not None else {}
        if heads is not None:
            ctx["heads"] = sorted({h.head_id for h in heads})
        self._wait_for_slot()
        t0 = time.perf_counter()
        run0 = self.clock()
        try:
            # The async entry returns once the batch is enqueued; the
            # blocking host fetch moves to _finalize_batch. run_timed /
            # plain run() keep stub dispatchers working. Untimed batches
            # still go through timed=False, not run(): the quantized arm
            # stamps its event fields unconditionally.
            run_async = getattr(self.dispatcher, "run_timed_async", None)
            run_timed = getattr(self.dispatcher, "run_timed", None)
            if run_async is not None:
                handle = run_async(kind, tokens, annotations,
                                   timed=bool(tracing and timed), **extra)
            elif run_timed is not None:
                result, timings = run_timed(kind, tokens, annotations,
                                            timed=bool(tracing and timed),
                                            **extra)
                handle = _ReadyBatch(result, timings)
            else:
                handle = _ReadyBatch(
                    self.dispatcher.run(kind, tokens, annotations,
                                        **extra), {})
        except Exception as e:  # submit failed; finalize path fails it
            handle = _FailedBatch(e)
        self._enqueue_inflight({
            "mode": "bucketed", "batch": batch, "handle": handle,
            "ctx": ctx, "kind": kind, "bucket_len": bucket_len,
            "cls": cls, "run0": run0, "t0": t0})
        return len(batch)

    def _finalize_batch(self, entry: Dict) -> None:
        """Resolve one in-flight micro-batch: blocking host fetch,
        per-request finalize/fan-out, trace marks, counters, the
        serve_batch event and the terminal complete callback. Runs on
        the completer thread when one is live, else inline right after
        submit. Trace stages: `execute` is submit → fetch-complete
        (run0 → run1) and `finalize` is fetch-complete → sealed."""
        batch: List[Request] = entry["batch"]
        ctx, run0 = entry["ctx"], entry["run0"]
        kind, bucket_len, cls = (entry["kind"], entry["bucket_len"],
                                 entry["cls"])
        tf0 = time.perf_counter()
        try:
            result, timings = entry["handle"].finalize()
        except Exception as e:  # fail THIS batch, keep serving
            logger.exception("batch dispatch failed (%s, L=%d, rows=%d)",
                             kind, bucket_len, len(batch))
            self.tele.emit("note", source="serve", error=str(e),
                           kind=kind, bucket_len=bucket_len)
            fail_t = self.clock()
            for req in batch:
                if req.trace is not None:
                    req.trace.mark_run(run0, fail_t)
                    req.trace.mark_batch(
                        bucket_len, cls, len(batch),
                        pad_fraction=ctx.get("pad_fraction"))
                if not req.future.done():
                    req.future.set_exception(e)
                self._on_complete(req, "error", fail_t, e, ctx)
            return
        ctx.update(timings)
        dt = time.perf_counter() - entry["t0"]
        run1 = self.clock()
        self._batch_h.observe(dt)
        self._finalize_h.observe(time.perf_counter() - tf0)
        done_t = self.clock()
        for i, req in enumerate(batch):
            if isinstance(result, dict):
                row = {k: v[i] for k, v in result.items()}
            else:
                row = result[i]
            outcome, err = "ok", None
            try:
                self.finalize(req, row)
            except Exception as e:
                outcome, err = "error", e
                if not req.future.done():
                    req.future.set_exception(e)
            self._latency(done_t - req.enqueued_at)
            if req.trace is not None:
                req.trace.mark_run(run0, run1)
                req.trace.mark_batch(
                    bucket_len, cls, len(batch),
                    pad_fraction=ctx.get("pad_fraction"),
                    prep_s=ctx.get("prep_s"),
                    device_s=ctx.get("device_s"))
            self._on_complete(req, outcome, self.clock(), err, ctx)
        with self._pending_lock:
            self.batches_total += 1
            self.rows_total += len(batch)
        self._occupancy_g.set(len(batch) / cls)
        self._rows_h.observe(len(batch))
        # Quant fields ride only when the arm set them: the event
        # contract is absent-means-fp32, not null.
        quant_fields = {k: ctx[k] for k in ("quant", "quant_parity_max")
                        if ctx.get(k) is not None}
        self.tele.emit("serve_batch", kind=kind, bucket_len=bucket_len,
                       rows=len(batch), batch_class=cls,
                       batch_seconds=round(dt, 6),
                       pad_fraction=ctx.get("pad_fraction"),
                       heads=ctx.get("heads"), **quant_fields,
                       **self._replica_fields)

    # ------------------------------------------------- in-flight window

    def _wait_for_slot(self) -> None:
        """Backpressure: block until the in-flight window has room.
        Only meaningful with a live completer (the sync path never
        leaves an entry behind); bounded wait steps keep an abort's
        stop() from wedging a full-window scheduler."""
        if self._completer is None:
            return
        with self._inflight_lock:
            while (len(self._inflight) >= self.pipeline_depth
                   and not self._stopped.is_set()):
                self._inflight_lock.wait(0.05)

    def _enqueue_inflight(self, entry: Dict) -> None:
        with self._inflight_lock:
            self._inflight.append(entry)
            n = len(self._inflight)
            if n > self.inflight_max:
                self.inflight_max = n
            self._inflight_lock.notify_all()
        self._inflight_g.set(n)
        if self._completer is None:
            self._drain_inflight()

    def _drain_inflight(self) -> None:
        """Finalize every windowed batch on the CALLING thread — the
        sync path (no completer), and the epilogue that resolves
        still-in-flight work when run_forever exits without one."""
        while True:
            with self._inflight_lock:
                if not self._inflight:
                    return
                entry = self._inflight.popleft()
                n = len(self._inflight)
                self._inflight_lock.notify_all()
            self._inflight_g.set(n)
            self._observe_finalize(entry, overlapped=n > 0)

    def _inflight_idle(self) -> bool:
        with self._inflight_lock:
            return not self._inflight

    def _observe_finalize(self, entry: Dict, overlapped: bool) -> None:
        """_finalize_batch plus the dispatch/finalize overlap
        accounting: finalize wall-seconds spent while ANOTHER batch was
        in the window are overlapped — the device had work the whole
        time the host was fetching/sealing."""
        t0 = time.perf_counter()
        self._finalize_batch(entry)
        fsec = time.perf_counter() - t0
        with self._inflight_lock:
            overlapped = overlapped or bool(self._inflight)
            self.finalize_seconds_total += fsec
            if overlapped:
                self.overlap_seconds_total += fsec
            total = self.finalize_seconds_total
            overlap = self.overlap_seconds_total
        if total > 0:
            self._overlap_g.set(round(overlap / total, 6))

    def _complete_forever(self) -> None:
        """Completer-thread loop: pop the oldest in-flight batch,
        finalize it, repeat — exiting only once run_forever has signaled
        stop AND the window is empty, so drain/abort both resolve every
        already-submitted batch exactly once."""
        while True:
            with self._inflight_lock:
                if not self._inflight:
                    if self._completer_stop.is_set():
                        return
                    self._inflight_lock.wait(0.05)
                    continue
                entry = self._inflight.popleft()
                n = len(self._inflight)
                self._inflight_lock.notify_all()
            self._inflight_g.set(n)
            self._observe_finalize(entry, overlapped=n > 0)

    def pipeline_stats(self) -> Dict:
        """One coherent read of the pipeline counters."""
        with self._inflight_lock:
            total = self.finalize_seconds_total
            overlap = self.overlap_seconds_total
            return {
                "depth": self.pipeline_depth,
                "inflight_max": self.inflight_max,
                "finalize_seconds_total": round(total, 6),
                "overlap_seconds_total": round(overlap, 6),
                "overlap_ratio": (round(overlap / total, 6)
                                  if total > 0 else 0.0),
            }

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
        try:
            while not self._stopped.is_set():
                if self.poll():
                    continue
                # Drained only when the QUEUE is empty too (after close()
                # no new pushes are admitted, so empty-at-observation is
                # final) and the in-flight window is idle: a submitted
                # batch's futures stay unsealed until it is finalized.
                if (self.queue.closed and not self.pending_rows()
                        and len(self.queue) == 0
                        and self._inflight_idle()):
                    return
                self.queue.wait(timeout=park)
        finally:
            # Drain/abort epilogue: every batch already SUBMITTED seals
            # exactly once — the completer exits once the window empties
            # (or the window resolves inline without one). Only then does
            # join() return, so Server.abort's fail_pending never races
            # a live finalize.
            self._completer_stop.set()
            with self._inflight_lock:
                self._inflight_lock.notify_all()
            if self._completer is not None:
                self._completer.join()
            else:
                self._drain_inflight()

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        if self.pipeline_depth > 1:
            self._completer = threading.Thread(
                target=self._complete_forever,
                name="pbt-serve-completer", daemon=True)
            self._completer.start()
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
        the requests that were failed (the Server seals their traces)."""
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
        telemetry=None,
        latency_observer: Optional[Callable[[float], None]] = None,
        expire_observer: Optional[Callable[[Request], None]] = None,
        complete_observer=None,
        replica_id: Optional[str] = None,
        pipeline_depth: int = 2,
    ):
        super().__init__(
            queue, dispatcher, finalize, max_batch=rows_per_batch,
            max_wait_s=max_wait_s, clock=clock, telemetry=telemetry,
            latency_observer=latency_observer,
            expire_observer=expire_observer,
            complete_observer=complete_observer, replica_id=replica_id,
            pipeline_depth=pipeline_depth)
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
                if req.trace is not None:
                    req.trace.mark_ingested(now)
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
        riders: List[Tuple[Request, int, int, int, int]] = []
        expired: List[Request] = []
        tracing = False
        timed = self.time_batches
        for r, row in enumerate(rows):
            for s, (req, start, span) in enumerate(row):
                if req.deadline is not None and now >= req.deadline:
                    expired.append(req)  # raced in since the last sweep
                    continue
                tokens[r, start:start + span] = req.tokens
                segment_ids[r, start:start + span] = s + 1
                if req.annotations is not None:
                    annotations[r, s] = req.annotations
                riders.append((req, r, s, start, span))
                self._observe_wait(req, now)
                if req.trace is not None:
                    tracing = True
                    if req.trace.sampled:
                        timed = True
                    req.trace.mark_popped(now)
        self._expire_requests(expired, now)
        if not riders:
            return len(expired)
        geom = [(r, s, start, span) for (_, r, s, start, span) in riders]
        heads = ([req.head for req, *_ in riders]
                 if riders[0][0].head is not None else None)
        n_riders = len(riders)
        ctx = {"rows": R, "batch_class": R, "bucket_len": L,
               "segments": n_riders,
               "segments_per_row": round(n_riders / R, 4),
               "mode": "ragged"}
        if heads is not None:
            ctx["heads"] = sorted({h.head_id for h in heads})
        self._wait_for_slot()
        t0 = time.perf_counter()
        run0 = self.clock()
        try:
            # Same rule as the bucketed scheduler: untimed batches run
            # timed=False; the async entry moves the host fetch and
            # fan-out into _finalize_batch.
            run_async = getattr(self.dispatcher,
                                "run_packed_timed_async", None)
            if run_async is not None:
                handle = run_async(kind, tokens, segment_ids,
                                   annotations, geom, heads=heads,
                                   timed=bool(tracing and timed))
            else:
                outs, timings = self.dispatcher.run_packed_timed(
                    kind, tokens, segment_ids, annotations, geom,
                    heads=heads, timed=bool(tracing and timed))
                handle = _ReadyBatch(outs, timings)
        except Exception as e:  # submit failed; finalize path fails it
            handle = _FailedBatch(e)
        self._enqueue_inflight({
            "mode": "ragged", "riders": riders, "handle": handle,
            "ctx": ctx, "kind": kind, "n_riders": n_riders,
            "run0": run0, "t0": t0})
        return n_riders

    def _finalize_batch(self, entry: Dict) -> None:
        """Packed-batch finalize: host fetch + per-rider fan-out via
        the in-flight handle, then the marks, counters and serve_batch
        event (mode="ragged")."""
        riders = entry["riders"]
        ctx, run0 = entry["ctx"], entry["run0"]
        kind, n_riders = entry["kind"], entry["n_riders"]
        R, L, S = self.rows_per_batch, self.seq_len, self.max_segments
        tf0 = time.perf_counter()
        try:
            outs, timings = entry["handle"].finalize()
        except Exception as e:  # fail THIS batch, keep serving
            logger.exception("packed batch dispatch failed "
                             "(%s, rows=%d, segments=%d)",
                             kind, R, n_riders)
            self.tele.emit("note", source="serve", error=str(e),
                           kind=kind, bucket_len=L, mode="ragged")
            fail_t = self.clock()
            for req, _, _, _, span in riders:
                if req.trace is not None:
                    req.trace.mark_run(run0, fail_t)
                    req.trace.mark_batch(
                        span, R, R,
                        pad_fraction=ctx.get("pad_fraction"),
                        segments=n_riders,
                        segments_per_row=ctx["segments_per_row"],
                        mode="ragged")
                if not req.future.done():
                    req.future.set_exception(e)
                self._on_complete(req, "error", fail_t, e, ctx)
            return
        ctx.update(timings)
        dt = time.perf_counter() - entry["t0"]
        run1 = self.clock()
        self._batch_h.observe(dt)
        self._finalize_h.observe(time.perf_counter() - tf0)
        done_t = self.clock()
        for (req, _, _, _, span), out in zip(riders, outs):
            outcome, err = "ok", None
            try:
                self.finalize(req, out)
            except Exception as e:
                outcome, err = "error", e
                if not req.future.done():
                    req.future.set_exception(e)
            self._latency(done_t - req.enqueued_at)
            if req.trace is not None:
                req.trace.mark_run(run0, run1)
                req.trace.mark_batch(
                    span, R, R,
                    pad_fraction=ctx.get("pad_fraction"),
                    prep_s=ctx.get("prep_s"),
                    device_s=ctx.get("device_s"),
                    segments=n_riders,
                    segments_per_row=ctx["segments_per_row"],
                    mode="ragged")
            self._on_complete(req, outcome, self.clock(), err, ctx)
        with self._pending_lock:
            self.batches_total += 1
            self.rows_total += n_riders
        # Occupancy for a packed grid is token occupancy (1 - pad
        # fraction) when the batch was timed, else segment-slot fill.
        pad = ctx.get("pad_fraction")
        self._occupancy_g.set(1.0 - pad if pad is not None
                              else n_riders / (R * S))
        self._rows_h.observe(n_riders)
        quant_fields = {k: ctx[k] for k in ("quant", "quant_parity_max")
                        if ctx.get(k) is not None}
        self.tele.emit("serve_batch", kind=kind, bucket_len=L,
                       rows=R, batch_class=R,
                       batch_seconds=round(dt, 6),
                       pad_fraction=pad,
                       segments=n_riders,
                       segments_per_row=ctx["segments_per_row"],
                       mode="ragged", heads=ctx.get("heads"),
                       **quant_fields,
                       **self._replica_fields)

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
