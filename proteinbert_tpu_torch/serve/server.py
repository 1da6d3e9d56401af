"""`Server` — the online-inference facade, bucketed and ragged modes —
port of `proteinbert_tpu/serve/server.py` (the blue-green rollout arm is
not ported yet).

Ties the queue, scheduler, dispatcher and cache together behind the
capabilities of the offline surface (inference.py): `embed`,
`predict_go`, `predict_residues`, and `predict_task` for a registered
task head, each a blocking call or a `submit()` future (serve/http.py is
a thin JSON shim over exactly this facade).

Task heads: `registry=` (a `heads.HeadRegistry` or its directory) and
`heads=` (head ids to load from it, or `LoadedHead`s). A head id loads
through the registry against the resident trunk's fingerprint
(`trunk_fp()`, computed once), so a head trained against another trunk
raises `TrunkMismatchError`. `add_head` / `remove_head` work on a live
server (a `note` event each) and capture no trunk graph; a `predict_task`
for a head that is not registered raises the typed `UnknownHeadError`
and counts as `rejected{reason="unknown_head"}`. Task results are cached
under "predict_task:<head_id>".

Neighbours: `index=` (an `index.scorer.NeighborIndex` on the server's
device) and `nprobe=8` attach the int8 IVF index; `neighbors(seq, k)` and
`/v1/neighbors` answer {"neighbors": [(corpus id, cosine), ...]}. The
request rides the embed batches (the dispatchers normalise the kind, so a
neighbours batch replays the embed graph and serving neighbours captures
no graph of its own); in finalize the request's global vector probes the
index on the server's own lookup stream, apart from the graph replays,
and the lookup's answer is on the host (its stream done) before the
future resolves (`trace` stage `lookup`, a sampled `neighbor_query`
event). The index pins its trunk: a
fingerprint other than `trunk_fp()` raises `TrunkMismatchError` at
attach. Answers are cached under "neighbors:<digest16>:k<k>:p<nprobe>";
`neighbors_requests_total{outcome=}` counts every neighbours request's
outcome (`stats()["neighbors"]`).

Request life cycle:

  submit() [client thread]                    scheduler thread
  ├─ over-length policy (reject/truncate+count)
  ├─ tokenize + bucket-route (serve/dispatch)
  ├─ cache lookup — a hit returns a resolved future, nothing enqueues
  └─ queue.push (may evict the oldest    ──►  poll(): group by
     request with QueueFullError)             (kind, bucket), dispatch
                                              at max_batch/max_wait —
                                              submit only; a completer
                                              thread fetches results,
                                              finalizes per row: cache
                                              put + future.set_result

Pipelined dispatch: dispatch is split into submit (the batch's graph
replay is enqueued on the card) and finalize (the wait for its outputs +
per-request fan-out), joined by a bounded in-flight window
(`pipeline_depth`, default `cfg.serve.pipeline_depth`). Batch N+1 forms
and is submitted while batch N computes; the completer thread drains the
window in FIFO order. Depth 1 runs no completer and is the serial path
bit for bit.

`serve_mode="ragged"` replaces the (kind, bucket) grouping with packing:
requests pack into fixed-shape (max_batch rows, seq_len) batches at their
bucket-quantized spans (`RaggedDispatcher`, `PackedBatchScheduler`), up to
`pack_max_segments` per row, and answer as the bucketed mode does.

`quant="int8"` serves int8 weights quantized once at load (either mode;
`"int8_act"` adds int8 fake-quant of the trunk's outputs, bucketed only),
with a fp32 parity shadow every `quant_parity_every` batches; None takes
`cfg.serve.quant` / `cfg.serve.quant_parity_every`. `stats()["quant"]`
reports the arm (serve/dispatch.py).

Shutdown is two-mode:

- `drain()` — the queue closes (new submits raise ServerClosedError),
  every queued and in-flight request completes, then the scheduler
  thread exits; emits `serve_end{outcome=drained}`.
- `abort()` — queued + pending futures fail with ServerClosedError,
  batches already in flight finish, a `note` lands on the telemetry
  stream and the flight recorder dumps; emits `serve_end{outcome=aborted}`.

Request tracing + SLOs: with telemetry enabled, every request carries a
`serve/trace.RequestTrace` that collects one clock mark per stage
boundary (submit → queue → batch_form → dispatch → execute → finalize).
Traces SAMPLED at `trace_sample_rate` — plus ALL requests that end in an
error or rejection — emit a `serve_request` event and, when the telemetry
carries a span collector, Perfetto spans on a per-request lane. Every
request's outcome also feeds the optional `obs/slo.SLOEvaluator`
(latency/error-rate objectives; burn rates on `/metrics` and
`stats()["slo"]`; a breach can start a `torch.profiler` capture into
`slo_profile_dir`). With the NULL facade no trace objects are created and
every touchpoint is a None check.

Telemetry (all optional): `serve_start`/`serve_batch`/`serve_reject`/
`serve_request`/`slo_breach`/`serve_end` events; `serve_queue_depth`,
`serve_batch_occupancy`, `serve_cache_hit_rate`, `serve_inflight_batches`,
`serve_overlap_ratio`, `slo_burn_rate{objective=}` gauges; the
`serve_latency` quantile window; `serve_requests_total{kind=}`,
`serve_rejected_total{reason=}`, `serve_truncated_total`,
`serve_cache_*_total` counters; `serve_latency_seconds`,
`serve_queue_wait_seconds`, `serve_batch_seconds`, `serve_batch_rows`,
`serve_finalize_seconds` histograms. The event schema is the JAX
package's, so its validator and `pbt diagnose --serve` read the stream.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike
from proteinbert_tpu_torch import inference
from proteinbert_tpu_torch.configs import PretrainConfig
from proteinbert_tpu_torch.heads.registry import (
    HeadRegistry, LoadedHead, TrunkMismatchError, UnknownHeadError,
    trunk_fingerprint,
)
from proteinbert_tpu_torch.obs import as_telemetry
from proteinbert_tpu_torch.obs.events import (
    SERVE_REJECT_REASONS, SERVE_REQUEST_OUTCOMES,
)
from proteinbert_tpu_torch.obs.slo import ProfileTrigger, SLOEvaluator
from proteinbert_tpu_torch.serve.cache import EmbeddingCache, content_key
from proteinbert_tpu_torch.serve.dispatch import (
    KINDS, NEIGHBORS_KIND, TASK_KIND, BucketDispatcher, RaggedDispatcher,
)
from proteinbert_tpu_torch.serve.errors import (
    SequenceTooLongError, ServerClosedError,
)
from proteinbert_tpu_torch.serve.queue import Request, RequestQueue
from proteinbert_tpu_torch.serve.scheduler import (
    MicroBatchScheduler, PackedBatchScheduler,
)
from proteinbert_tpu_torch.serve.trace import RequestTrace, stride_sampled

SERVE_MODES = ("bucketed", "ragged")

# Default result size for `/v1/neighbors` when the request carries no `k`
# — the recall gate's k (recall@10).
DEFAULT_NEIGHBORS_K = 10


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
        telemetry=None,
        clock=time.monotonic,
        warm_kinds=("embed",),
        batch_classes=None,
        trace_sample_rate: Optional[float] = 1.0,
        slos=None,
        slo_profile_dir: Optional[str] = None,
        slo_breach_cooldown_s: float = 60.0,
        serve_mode: str = "bucketed",
        pack_max_segments: int = 8,
        quant: Optional[str] = None,
        quant_parity_every: Optional[int] = None,
        replica_id: Optional[str] = None,
        pipeline_depth: Optional[int] = None,
        registry=None,
        heads=None,
        index=None,
        nprobe: int = 8,
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
        if pipeline_depth is None:
            pipeline_depth = cfg.serve.pipeline_depth
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.quant = quant
        self.cfg = cfg
        self.on_long = on_long
        self.default_deadline_s = default_deadline_s
        self.clock = clock
        self.serve_mode = serve_mode
        # Stamped onto every serve_request / serve_batch event.
        self.replica_id = replica_id
        self.tele = as_telemetry(telemetry)
        metrics = self.tele.metrics
        self.cache = EmbeddingCache(cache_size, metrics=metrics)
        self.queue = RequestQueue(queue_depth)
        observers = dict(latency_observer=self._observe_latency,
                         expire_observer=self._count_expiry,
                         complete_observer=self._on_complete)
        if serve_mode == "ragged":
            # `max_batch` means packed ROWS per batch here; a batch
            # carries up to max_batch * pack_max_segments requests.
            if batch_classes is not None:
                raise ValueError(
                    "batch_classes is meaningless in ragged mode — the "
                    "device shape is fixed at (max_batch, seq_len)")
            self.dispatcher = RaggedDispatcher(
                params, cfg, buckets=buckets, rows_per_batch=max_batch,
                max_segments=pack_max_segments, device=device,
                metrics=metrics, quant=quant,
                quant_parity_every=quant_parity_every)
            self.scheduler = PackedBatchScheduler(
                self.queue, self.dispatcher, self._finalize,
                rows_per_batch=max_batch, max_wait_s=max_wait_s,
                clock=clock, max_segments=pack_max_segments,
                telemetry=telemetry, replica_id=replica_id,
                pipeline_depth=self.pipeline_depth, **observers)
        else:
            self.dispatcher = BucketDispatcher(
                params, cfg, buckets=buckets, max_batch=max_batch,
                batch_classes=batch_classes, device=device, metrics=metrics,
                quant=quant, quant_parity_every=quant_parity_every)
            self.scheduler = MicroBatchScheduler(
                self.queue, self.dispatcher, self._finalize,
                max_batch=max_batch, max_wait_s=max_wait_s, clock=clock,
                telemetry=telemetry, replica_id=replica_id,
                pipeline_depth=self.pipeline_depth, **observers)
        # One ring serves stats(), /metrics and the percentile gauges; a
        # disabled registry returns a live unregistered window.
        self.latencies = metrics.quantile_window("serve_latency")
        # Request tracing: None disables trace objects entirely; a rate
        # in [0, 1] traces every request cheaply and EMITS the sampled
        # fraction (errors/rejections always emit). NULL telemetry also
        # disables: there is nowhere to emit to.
        if trace_sample_rate is not None and not self.tele.enabled:
            trace_sample_rate = None
        self.trace_sample_rate = trace_sample_rate
        self._req_ids = itertools.count(1)
        self._id_prefix = f"{os.getpid():x}-"
        self.slo = None
        self.profile_trigger = None
        if slos:
            on_breach = None
            if slo_profile_dir:
                self.profile_trigger = ProfileTrigger(slo_profile_dir,
                                                      clock=clock)
                on_breach = self.profile_trigger
            self.slo = SLOEvaluator(
                slos, metrics=metrics, telemetry=self.tele, clock=clock,
                on_breach=on_breach,
                breach_cooldown_s=slo_breach_cooldown_s)
            stage_objs = [o.name for o in self.slo.objectives
                          if o.kind == "latency" and o.stage != "e2e"]
            if stage_objs and self.trace_sample_rate is None:
                raise ValueError(
                    f"stage-scoped slo objective(s) {stage_objs} need "
                    "request tracing for per-stage durations, but "
                    "tracing is off (telemetry disabled or "
                    "trace_sample_rate=None) — they would never "
                    "observe anything")
            # SLO violation attribution consumes pad/prep/device per
            # request, so every batch is timed, not just sampled ones.
            self.scheduler.time_batches = True
        self._warm_kinds = tuple(warm_kinds)
        self._started = False
        self._ended = False
        self._depth_g = metrics.gauge("serve_queue_depth")
        self._latency_h = metrics.histogram("serve_latency_seconds")
        self._truncated_c = metrics.counter("serve_truncated_total")
        self._req_c = {k: metrics.counter("serve_requests_total", kind=k)
                       for k in KINDS + (TASK_KIND, NEIGHBORS_KIND)}
        self._rej_c = {r: metrics.counter("serve_rejected_total", reason=r)
                       for r in SERVE_REJECT_REASONS}
        # Every neighbours request lands in exactly one outcome bucket
        # through the _seal funnel.
        self._nbr_c = {o: metrics.counter("neighbors_requests_total",
                                          outcome=o)
                       for o in SERVE_REQUEST_OUTCOMES}
        self.completed_total = 0  # one writer: the finalizing thread
        # Local mirrors of the labeled counters (stats() reports real
        # numbers under the NULL facade too). Bumped from concurrent
        # client threads: the read-modify-write needs the lock.
        self._mirror_lock = threading.Lock()
        self.cache_hit_returns = 0           # guarded-by: _mirror_lock
        self.truncated_total = 0             # guarded-by: _mirror_lock
        self.rejected_total = {r: 0 for r in self._rej_c}
        self.neighbors_total = {o: 0 for o in self._nbr_c}  # same lock
        if isinstance(registry, str):
            registry = HeadRegistry(registry)
        self.registry = registry
        self._trunk_fp: Optional[str] = None
        for h in (heads or ()):
            self.add_head(h)
        # The neighbour index pins the trunk it was built from; a
        # mismatch gets the mis-trunked head's typed refusal before the
        # server can serve garbage neighbours.
        self.index = index
        self.nprobe = int(nprobe)
        self._lookup_stream = None
        if index is not None:
            if self.nprobe < 1:
                raise ValueError(f"nprobe must be >= 1, got {nprobe}")
            fp = self.trunk_fp()
            if index.model_fingerprint != fp:
                raise TrunkMismatchError(
                    "neighbor index was built from embeddings of trunk "
                    f"{index.model_fingerprint[:12]}…, but this server "
                    f"holds trunk {fp[:12]}… — rebuild it with "
                    "`build_index` over this model's embedding store")
            if index.device.type == "cuda":
                # Lookups run on their own stream, apart from the graph
                # replays; each waits for its stream before returning.
                self._lookup_stream = torch.cuda.Stream(index.device)

    def _bump(self, mirror: str, reason: Optional[str] = None) -> None:
        with self._mirror_lock:
            if reason is None:
                setattr(self, mirror, getattr(self, mirror) + 1)
            else:
                self.rejected_total[reason] += 1

    def _reject(self, reason: str, kind: str, queue_depth: int) -> None:
        """Count one rejection (counter + mirror) and emit it."""
        self._rej_c[reason].inc()
        self._bump("rejected_total", reason)
        self.tele.emit("serve_reject", reason=reason, kind=kind,
                       queue_depth=queue_depth)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "Server":
        """Warm the shape classes (capture their graphs on the card) and
        start the scheduler."""
        if self._started:
            raise RuntimeError("server already started")
        warmed = self.dispatcher.warmup(self._warm_kinds)
        if self.index is not None:
            # Warm the single-request lookup shape — (Q=1, nprobe,
            # k=DEFAULT_NEIGHBORS_K) — so the first /v1/neighbors request
            # pays lookup time, not first-use set-up.
            with self._on_lookup_stream():
                self.index.lookup_rows(
                    np.zeros((1, self.index.dim), np.float32),
                    k=DEFAULT_NEIGHBORS_K, nprobe=self.nprobe)
        self.tele.emit("serve_start", pid=os.getpid(), config={
            "serve_mode": self.serve_mode,
            "buckets": list(self.dispatcher.buckets),
            "batch_classes": list(self.dispatcher.batch_classes),
            "pack_max_segments": getattr(self.dispatcher,
                                         "max_segments", None),
            "max_batch": self.scheduler.max_batch,
            "max_wait_s": self.scheduler.max_wait_s,
            "queue_depth": self.queue.max_depth,
            "cache_size": self.cache.capacity,
            "on_long": self.on_long,
            "warmed_executables": warmed,
            "trace_sample_rate": self.trace_sample_rate,
            "slos": ([o.name for o in self.slo.objectives]
                     if self.slo else []),
            "device": str(self.dispatcher.device),
            "quant": self.quant,
            "quant_report": self.dispatcher.quant_report or None,
            "pipeline_depth": self.pipeline_depth,
            "replica_id": self.replica_id,
            "heads": sorted(self.dispatcher.heads),
            "warmup": self.dispatcher.warmup_report,
            "neighbor_index": (self.index.digest
                               if self.index is not None else None),
            "nprobe": self.nprobe if self.index is not None else None,
        })
        self.scheduler.start()
        self._started = True
        return self

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close(drain=exc_type is None)
        return False

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting, finish everything queued
        and in flight, then emit `serve_end{drained}`. Returns False if
        the scheduler did not exit within `timeout`."""
        self.queue.close()
        done = self.scheduler.join(timeout)
        if not self._ended:
            self._ended = True
            self.tele.emit("serve_end", outcome="drained",
                           stats=self.stats())
        return done

    def abort(self) -> None:
        """Hard shutdown: fail all queued + pending work with
        ServerClosedError, leave a flight-recorder trail, emit
        `serve_end{aborted}`. Batches already in flight finish; their
        futures resolve normally."""
        self.scheduler.stop()
        exc = ServerClosedError("server aborted before this request ran")
        failed = self.queue.fail_all(exc)
        self.scheduler.join(timeout=30.0)
        failed += self.scheduler.fail_pending(exc)
        now = self.clock()
        for req in failed:
            self._seal(req.trace, "aborted", now, error=exc,
                       e2e_fallback=max(0.0, now - req.enqueued_at),
                       kind=req.kind)
        if not self._ended:
            self._ended = True
            self.tele.emit("note", source="serve", kind="abort",
                           failed_requests=len(failed))
            self.tele.emit("serve_end", outcome="aborted",
                           stats=self.stats())
            self.tele.dump_flight("serve_abort")

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        if drain:
            self.drain(timeout)
        else:
            self.abort()

    # ---------------------------------------------------------- task heads

    def trunk_fp(self) -> str:
        """The resident trunk's fingerprint (the JAX package's digest of
        the same weights), computed on first use and kept: every registry
        load is checked against it."""
        if self._trunk_fp is None:
            self._trunk_fp = trunk_fingerprint(self.dispatcher.params,
                                               self.cfg.model.scan_blocks)
        return self._trunk_fp

    def add_head(self, head) -> str:
        """Add a head to a (possibly live) server: a head id loaded
        through the registry against `trunk_fp()` (TrunkMismatchError for
        a head of another trunk, UnknownHeadError for an id the registry
        lacks), or a `LoadedHead`. On a live server its tail is warmed;
        no trunk graph is captured. Returns the head id."""
        if isinstance(head, str):
            if self.registry is None:
                raise ValueError(
                    f"cannot resolve head id {head!r}: this server has "
                    "no registry (pass registry= or a LoadedHead)")
            head = self.registry.load(head, trunk_fp=self.trunk_fp())
        if not isinstance(head, LoadedHead):
            raise TypeError(f"a head is a head id or a LoadedHead, got "
                            f"{type(head).__name__}")
        warm_s = self.dispatcher.add_head(head, warm=self._started)
        self.tele.emit("note", source="serve", kind="head_added",
                       head_id=head.head_id, name=head.name,
                       task=head.task.kind, warm_s=round(warm_s, 6))
        return head.head_id

    def remove_head(self, head_id: str) -> None:
        """Remove a head: new submits for it get the typed
        UnknownHeadError; queued and in-flight requests for it complete
        (each carries its own head)."""
        head = self.dispatcher.remove_head(head_id)
        self.tele.emit("note", source="serve", kind="head_removed",
                       head_id=head.head_id, name=head.name)

    def list_heads(self):
        """[{head_id, name, kind, num_outputs}] of the servable heads."""
        return self.dispatcher.list_heads()

    # ------------------------------------------------------------- submit

    def submit(self, kind: str, seq: str, annotations=None,
               deadline_s: Optional[float] = None,
               top_k: Optional[int] = None,
               head_id: Optional[str] = None,
               trace_id: Optional[str] = None) -> Future:
        """Enqueue one request; returns its future (which carries the
        trace id as `.pbt_request_id` when tracing is on — the caller's
        `trace_id` when one is given, so one id names the request across
        processes). Raises SequenceTooLongError (on_long="reject", or a
        '?' beyond the window for predict_residues), UnknownHeadError
        (predict_task for a head not registered: the typed 404) and
        ServerClosedError synchronously; QueueFullError /
        DeadlineExceededError land on futures (the evicted/expired
        request's — never silently dropped)."""
        if kind not in KINDS and kind not in (TASK_KIND, NEIGHBORS_KIND):
            raise ValueError(f"unknown request kind {kind!r}; have "
                             f"{KINDS + (TASK_KIND, NEIGHBORS_KIND)}")
        if kind == NEIGHBORS_KIND and self.index is None:
            raise ValueError(
                "this server has no neighbor index attached — start it "
                "with index= to serve /v1/neighbors")
        if not seq:
            raise ValueError("empty sequence")
        if (kind == TASK_KIND) != (head_id is not None):
            raise ValueError(
                f"head_id is required for kind {TASK_KIND!r} and invalid "
                "for every other kind")
        now0 = self.clock()
        trace = None
        if self.trace_sample_rate is not None:
            n = next(self._req_ids)
            trace = RequestTrace(
                f"{self._id_prefix}{n:x}", kind, now0,
                sampled=stride_sampled(n, self.trace_sample_rate))
            trace.join(trace_id, self.replica_id)
            trace.head_id = head_id
            # Which arm serves this request (`quant` on serve_request;
            # absent on the fp32 arm).
            if self.quant != "fp32":
                trace.quant = self.quant
        head = None
        if kind == TASK_KIND:
            try:
                head = self.dispatcher.get_head(head_id)
            except UnknownHeadError as exc:
                # The typed 404: never added, or removed.
                self._rej_c["unknown_head"].inc()
                self._bump("rejected_total", "unknown_head")
                self.tele.emit("serve_reject", reason="unknown_head",
                               kind=kind, queue_depth=len(self.queue),
                               head_id=head_id)
                self._seal(trace, "rejected", self.clock(), kind=kind)
                if trace is not None:
                    exc.pbt_request_id = trace.public_id()
                raise
        window = self.cfg.data.seq_len - 2
        if len(seq) > window:
            if (self.on_long == "reject"
                    or (kind == "predict_residues"
                        and inference.MASK_CHAR in seq[window:])):
                self._reject("too_long", kind, len(self.queue))
                self._seal(trace, "rejected", self.clock(), kind=kind)
                exc = SequenceTooLongError(
                    f"sequence of {len(seq)} residues exceeds the model "
                    f"window of {window}"
                    + (" (and masks a position the model would never "
                       "see)" if kind == "predict_residues" else
                       "; the server is configured to reject rather "
                       "than truncate"))
                if trace is not None:
                    exc.pbt_request_id = trace.public_id()
                raise exc
            self._truncated_c.inc()
            self._bump("truncated_total")
        if annotations is not None:
            annotations = inference.check_annotations(
                np.asarray(annotations, np.float32)[None], 1, self.cfg)[0]
        self._req_c[kind].inc()
        future: Future = Future()
        if trace is not None:
            future.pbt_request_id = trace.public_id()
        key = None
        if self.cache.capacity:
            if trace is not None:
                trace.cache = "miss"
            if kind == NEIGHBORS_KIND:
                # The answer depends on the exact index contents (its
                # identity digest), k and the probe breadth: all three
                # scope the key, so a rebuilt index or another k never
                # aliases a stale answer.
                scope = (f"{kind}:{self.index.digest[:16]}"
                         f":k{top_k or DEFAULT_NEIGHBORS_K}"
                         f":p{self.nprobe}")
            elif head is None:
                scope = kind
            else:
                # A head id addresses its weights, task and trunk, so
                # the scope keys a task answer to the head that made it.
                scope = f"{kind}:{head.head_id}"
            key = content_key(scope, seq, annotations)
            hit = self.cache.get(key)
            if hit is not None:
                self._bump("cache_hit_returns")
                if trace is not None:
                    trace.cache = "hit"
                future.set_result(self._present(kind, hit, top_k))
                self._seal(trace, "cache_hit", self.clock(), kind=kind)
                return future
        bucket_len = self.dispatcher.bucket_len(len(seq))
        tokens = inference._tokenize_masked(
            [seq], self.cfg.data.seq_len, on_overflow="count")[0, :bucket_len]
        now = self.clock()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        if trace is not None:
            trace.mark_enqueued(now)
        req = Request(
            kind=kind, seq=seq, tokens=tokens, bucket_len=bucket_len,
            future=future, enqueued_at=now, annotations=annotations,
            deadline=(now + deadline_s if deadline_s is not None else None),
            top_k=top_k, cache_key=key, trace=trace, head=head)
        try:
            evicted = self.queue.push(req)
        except ServerClosedError as exc:
            self._reject("closed", kind, len(self.queue))
            self._seal(trace, "rejected", self.clock(), kind=kind)
            if trace is not None:
                exc.pbt_request_id = trace.public_id()
            raise
        if evicted:
            now2 = self.clock()
            for old in evicted:
                self._reject("queue_full", old.kind, self.queue.max_depth)
                self._seal(old.trace, "evicted", now2,
                           e2e_fallback=max(0.0, now2 - old.enqueued_at),
                           kind=old.kind)
        self._depth_g.set(len(self.queue))
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

    def neighbors(self, seq: str, k: Optional[int] = None,
                  timeout: Optional[float] = None,
                  deadline_s: Optional[float] = None):
        """{"neighbors": [(corpus_id, cosine_score), ...]} best-first for
        one query sequence: it embeds through the trunk (riding whatever
        batch is forming), then its global vector probes the attached
        int8 IVF index. Requires a server started with `index=`."""
        return self.submit(NEIGHBORS_KIND, seq, top_k=k,
                           deadline_s=deadline_s).result(timeout)

    def predict_task(self, head_id: str, seq: str, annotations=None,
                     timeout: Optional[float] = None,
                     deadline_s: Optional[float] = None) -> np.ndarray:
        """One registered head's float32 output for one sequence:
        (bucket_len, num_outputs) logits for token_classification,
        (num_outputs,) logits for sequence_classification, (1,) for
        sequence_regression — the serving form of
        heads/apply.predict_task_rows. The request rides whatever batch
        forms for its bucket, beside requests for other heads."""
        return self.submit(TASK_KIND, seq, annotations,
                           deadline_s=deadline_s,
                           head_id=head_id).result(timeout)

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
        (+ cache insert). Runs on the finalizing thread — the completer
        when pipeline_depth > 1, else the scheduler thread; exactly one
        of the two ever calls this."""
        if req.kind == NEIGHBORS_KIND:
            # The embed leg already ran (dispatch served this request as
            # an embed row); the lookup leg probes the resident index
            # here, timed into its own `lookup` trace stage.
            g = np.asarray(row["global"])
            k = req.top_k if req.top_k else DEFAULT_NEIGHBORS_K
            t0 = self.clock()
            with self._on_lookup_stream():
                pairs = self.index.lookup_one(g, k=k, nprobe=self.nprobe)
            t1 = self.clock()
            if req.trace is not None:
                req.trace.mark_lookup(t1)
            if req.trace is not None and req.trace.sampled:
                self.tele.emit(
                    "neighbor_query", k=int(k), nprobe=self.nprobe,
                    candidates=min(
                        self.index.num_vectors,
                        self.nprobe * int(self.index.members.shape[1])),
                    lookup_s=round(max(0.0, t1 - t0), 9),
                    outcome="ok", request_id=req.trace.request_id)
            value = {"neighbors": pairs}
        elif req.kind == "embed":
            value = {"global": np.asarray(row["global"]),
                     "local_mean": np.asarray(row["local_mean"])}
        elif req.kind in ("predict_go", TASK_KIND):
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
        self._depth_g.set(len(self.queue))

    def _on_lookup_stream(self):
        """The context a lookup runs in: the server's lookup stream on the
        card (`lookup_rows` waits for it before returning), else none."""
        if self._lookup_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._lookup_stream)

    def _count_expiry(self, req: Request) -> None:
        """Scheduler callback per deadline-expired request: the expiry IS
        a rejection (the serve_reject event is emitted scheduler-side)."""
        self._rej_c["deadline"].inc()
        self._bump("rejected_total", "deadline")

    def _observe_latency(self, seconds: float) -> None:
        """Scheduler callback per successfully batched row: one ring
        serves stats(), /metrics and the percentile gauges."""
        self.latencies.observe(seconds)
        self._latency_h.observe(seconds)

    def _on_complete(self, req: Request, outcome: str, now: float,
                     error: Optional[BaseException],
                     ctx: Optional[dict]) -> None:
        """Scheduler callback per terminal request (ok/error/expired):
        seal the trace, emit, feed the SLO evaluator."""
        self._seal(req.trace, outcome, now, error=error,
                   e2e_fallback=max(0.0, now - req.enqueued_at),
                   kind=req.kind)

    def _seal(self, trace: Optional[RequestTrace], outcome: str,
              now: float, error: Optional[BaseException] = None,
              e2e_fallback: float = 0.0,
              kind: Optional[str] = None) -> None:
        """The single terminal funnel: every request reaches this
        exactly once per outcome path. Emits the serve_request event +
        spans for sampled or failed requests; feeds every completion
        (traced or not) to the SLO evaluator."""
        stages = None
        e2e = e2e_fallback
        rid = None
        if trace is not None:
            if not trace.finish(outcome, now, error):
                return  # already sealed by an earlier outcome path
            e2e = trace.e2e_s()
            rid = trace.request_id
            emit = trace.sampled or outcome not in ("ok", "cache_hit")
            if emit or self.slo:
                # Stage decomposition only when something consumes it.
                stages = trace.stages()
            if emit:
                self.tele.emit("serve_request",
                               **trace.event_fields(stages=stages))
                if self.tele.spans is not None:
                    trace.export_spans(self.tele.spans)
        if kind == NEIGHBORS_KIND:
            c = self._nbr_c.get(outcome)
            if c is not None:
                c.inc()
            with self._mirror_lock:
                self.neighbors_total[outcome] = \
                    self.neighbors_total.get(outcome, 0) + 1
        if self.slo:
            if stages is not None and trace.pad_fraction \
                    and "execute" in stages:
                # Synthetic attribution stage: the share of device time
                # spent computing padding — the ragged-serving lever.
                stages = dict(stages)
                stages["pad_wasted"] = round(
                    stages["execute"] * trace.pad_fraction, 9)
            self.slo.observe(outcome, e2e, stages=stages,
                             request_id=rid, now=now)

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._mirror_lock:
            mirrors = {
                "cache_hit_returns": self.cache_hit_returns,
                "truncated": self.truncated_total,
                "rejected": dict(self.rejected_total),
            }
            neighbors_by_outcome = dict(self.neighbors_total)
        qw = self.scheduler.queue_wait
        batches, rows, expired = self.scheduler.stats_counts()
        out = {
            "mode": self.serve_mode,
            "completed": self.completed_total,
            **mirrors,
            # Captured CUDA graphs (the JAX executables) and the
            # cumulative warmup seconds.
            "executables": self.dispatcher.executable_count,
            "warmup_seconds": round(self.dispatcher.warmup_seconds_total,
                                    6),
            "batches": batches,
            "batched_rows": rows,
            "queue_depth": len(self.queue),
            "evicted": self.queue.evicted_total,
            "expired": expired,
            "cache": self.cache.stats(),
            "latency": self.latencies.summary(),
            "queue_wait": {
                "count": qw.count,
                "mean_s": (round(qw.total / qw.count, 6)
                           if qw.count else None),
                "max_s": (round(qw.max, 6) if qw.count else None),
            },
            "quant": ({"mode": self.quant, **self.dispatcher.quant_report}
                      if self.quant != "fp32" else None),
            "heads": len(self.dispatcher.heads),
            # Window depth, the deepest the window got, and the share of
            # finalize seconds that overlapped a later batch's compute.
            "pipeline": self.scheduler.pipeline_stats(),
        }
        # The neighbour-index arm: which index serves, its size, and how
        # many distinct lookup shapes have run.
        out["neighbors"] = (None if self.index is None else {
            "index_digest": self.index.digest,
            "corpus_digest": self.index.corpus_digest,
            "num_vectors": self.index.num_vectors,
            "nprobe": self.nprobe,
            "lookup_executables": self.index.executables(),
            "by_outcome": neighbors_by_outcome,
        })
        if self.slo:
            out["slo"] = self.slo.status()
        return out
