"""Per-request trace context for the serving path — a copy of
`proteinbert_tpu/serve/trace.py`.

A `RequestTrace` rides on a `Request` from `Server.submit()` through
queue → scheduler → dispatcher → cache → response, collecting one clock
mark per stage boundary. All marks come from the SERVER's injected
clock (`time.monotonic` in production, a fake clock in tests), so a
trace's stage durations are deterministic under `poll(now=)` and the
stage decomposition is exact by construction: stages are CONTIGUOUS
intervals between consecutive marks, so they always sum to the
end-to-end latency (the acceptance property `bench.py --serve` checks
on live traffic).

Stage names, in request order:

| stage        | interval                               | covers |
|--------------|----------------------------------------|--------|
| `submit`     | submit() entry → queue push            | admission, tokenize, cache lookup |
| `queue`      | queue push → scheduler ingest          | waiting for the scheduler to wake |
| `batch_form` | ingest → popped into a batch           | waiting for max_batch / max_wait |
| `dispatch`   | popped → model call                    | stacking, padding, device_put (+compile on a cold shape) |
| `execute`    | model call → outputs on host           | device execute + host fetch |
| `lookup`     | outputs on host → ANN answer           | neighbor-index probe (`neighbors` requests only) |
| `finalize`   | outputs on host → future resolved      | cache insert, result shaping |

The `lookup` stage exists only on `/v1/neighbors` requests (the
embed-leg stages before it are unchanged); when present it is inserted
between `execute` and `finalize`, so the stage set still tiles the
end-to-end interval by construction — `pbt diagnose --serve` splits
neighbor latency into embed leg (everything before `lookup`) and
lookup leg on exactly that property.

A request that exits early (cache hit, eviction, rejection, abort)
simply has fewer marks; its last present stage absorbs the remainder.

Cost contract: a trace is ~10 float slots plus one clock read per
stage boundary — cheap enough that EVERY request carries one whenever
telemetry is enabled (errors/rejections must trace even when sampled
out). Emission (the `serve_request` event + Perfetto spans) happens
only for sampled or non-`ok` requests. With the NULL telemetry facade
no trace is created at all and every touchpoint is a `None` check.

Stdlib-only (no jax, no numpy): importable anywhere obs is.
"""

from __future__ import annotations

import math
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

# Spans shorter than this are dropped from the Perfetto export (not
# from the event's stages dict): zero-width slices only clutter the UI.
_MIN_SPAN_S = 1e-7

STAGES = ("submit", "queue", "batch_form", "dispatch", "execute",
          "lookup", "finalize")


def stride_sampled(seq: int, rate: float) -> bool:
    """Deterministic stride sampling: True for floor(seq*rate) ticks —
    exactly `rate` of consecutive sequence numbers, no RNG state."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return math.floor(seq * rate) != math.floor((seq - 1) * rate)


class RequestTrace:
    """Stage-mark accumulator for one served request."""

    __slots__ = (
        "request_id", "kind", "sampled", "wall0",
        "t_submit", "t_enqueued", "t_ingested", "t_popped",
        "t_run0", "t_run1", "t_lookup", "t_done",
        "bucket_len", "batch_class", "rows", "pad_fraction",
        "prep_s", "device_s", "cache", "outcome", "error", "head_id",
        "segments", "segments_per_row", "mode", "quant",
        "trace_id", "parent", "replica_id",
    )

    def __init__(self, request_id: str, kind: str, now: float,
                 sampled: bool = True, wall: Optional[float] = None):
        self.request_id = request_id
        self.kind = kind
        self.sampled = sampled
        # Wall-clock anchor for Perfetto (monotonic marks are offsets
        # from t_submit); taken once so a fake clock stays fake.
        self.wall0 = time.time() if wall is None else wall
        self.t_submit = now
        self.t_enqueued: Optional[float] = None
        self.t_ingested: Optional[float] = None
        self.t_popped: Optional[float] = None
        self.t_run0: Optional[float] = None
        self.t_run1: Optional[float] = None
        self.t_lookup: Optional[float] = None
        self.t_done: Optional[float] = None
        self.bucket_len: Optional[int] = None
        self.batch_class: Optional[int] = None
        self.rows: Optional[int] = None
        self.pad_fraction: Optional[float] = None
        self.prep_s: Optional[float] = None
        self.device_s: Optional[float] = None
        self.cache: str = "off"          # off | miss | hit
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.head_id: Optional[str] = None  # predict_task tenant id —
                                            # per-head latency/error
                                            # attribution in
                                            # `pbt diagnose --serve`
        # Ragged packed serving: how many requests (segments)
        # shared the rider's packed batch, the batch's mean occupancy,
        # and which dispatch mode ran it. None on the bucketed path.
        self.segments: Optional[int] = None
        self.segments_per_row: Optional[float] = None
        self.mode: Optional[str] = None
        # Quantized executable arm: "int8"/"int8_act" when
        # a quantized executable served this request, None on fp32.
        self.quant: Optional[str] = None
        # Fleet-scope causal context: `trace_id` is the
        # router-minted id this request joined via the X-PBT-Trace
        # header (None = self-rooted, standalone server), `parent` the
        # enclosing fleet request's id (== trace_id in the current
        # two-level router→replica topology), `replica_id` the serving
        # process's --replica-id identity. All ride the serve_request
        # event so the fleet collector can join cross-process records
        # without inferring identity from ports.
        self.trace_id: Optional[str] = None
        self.parent: Optional[str] = None
        self.replica_id: Optional[str] = None

    def join(self, trace_id: Optional[str],
             replica_id: Optional[str] = None) -> None:
        """Adopt a propagated fleet-scope trace context (no-ops on
        None): after joining, public_id() answers with the FLEET id —
        the X-PBT-Request-Id value clients see end-to-end."""
        if trace_id:
            self.trace_id = trace_id
            self.parent = trace_id
        if replica_id:
            self.replica_id = replica_id

    def public_id(self) -> str:
        """The id this request answers to externally: the fleet-scope
        trace id when joined, the local request id when self-rooted."""
        return self.trace_id or self.request_id

    # ------------------------------------------------------------ marks

    def mark_enqueued(self, now: float) -> None:
        self.t_enqueued = now

    def mark_ingested(self, now: float) -> None:
        self.t_ingested = now

    def mark_popped(self, now: float) -> None:
        self.t_popped = now

    def mark_run(self, t0: float, t1: float) -> None:
        self.t_run0 = t0
        self.t_run1 = t1

    def mark_lookup(self, now: float) -> None:
        """End of the neighbor-index probe. Setting it
        splits the interval after `execute` into `lookup` (ANN) and
        `finalize` (cache insert / result shaping); without it the
        stage set is unchanged."""
        self.t_lookup = now

    def mark_batch(self, bucket_len: int, batch_class: int, rows: int,
                   pad_fraction: Optional[float] = None,
                   prep_s: Optional[float] = None,
                   device_s: Optional[float] = None,
                   segments: Optional[int] = None,
                   segments_per_row: Optional[float] = None,
                   mode: Optional[str] = None) -> None:
        """Batch-level context, stamped onto every rider of the batch
        (same executable, same padded grid — the attribution is shared
        by construction). On the ragged path `bucket_len` is the
        rider's SPAN (its bucket-quantized length inside the packed
        row), `batch_class` the executable's fixed row count, and
        `segments`/`segments_per_row`/`mode` describe the packing."""
        self.bucket_len = bucket_len
        self.batch_class = batch_class
        self.rows = rows
        self.pad_fraction = pad_fraction
        self.prep_s = prep_s
        self.device_s = device_s
        self.segments = segments
        self.segments_per_row = segments_per_row
        self.mode = mode

    # ---------------------------------------------------------- finish

    @property
    def finished(self) -> bool:
        return self.outcome is not None

    def finish(self, outcome: str, now: float,
               error: Optional[BaseException] = None) -> bool:
        """Seal the trace; False if it was already sealed (a request
        must reach exactly one terminal outcome — double-finish would
        mean orphaned/duplicated spans)."""
        if self.outcome is not None:
            return False
        self.outcome = outcome
        self.t_done = now
        if error is not None:
            self.error = f"{type(error).__name__}: {error}"
        return True

    # ------------------------------------------------------- derived

    def _chain(self) -> Tuple[List[Tuple[str, float]], float]:
        """(present marks clamped MONOTONIC, end). Marks come from two
        threads' reads of the same clock (a scheduler poll() takes its
        `now` once, so a request enqueued mid-poll can carry
        t_enqueued > t_ingested by a few ms): clamping each mark to its
        predecessor — and the end to the last mark — keeps the
        stages-tile-e2e invariant exact instead of intermittently off
        by the thread-interleave gap."""
        marks = [("submit", self.t_submit), ("queue", self.t_enqueued),
                 ("batch_form", self.t_ingested),
                 ("dispatch", self.t_popped), ("execute", self.t_run0)]
        if self.t_lookup is not None:
            # Neighbor request: the interval after the device run
            # splits into the ANN probe and the true finalize tail.
            marks += [("lookup", self.t_run1),
                      ("finalize", self.t_lookup)]
        else:
            marks += [("finalize", self.t_run1)]
        present: List[Tuple[str, float]] = []
        prev = None
        for name, t in marks:
            if t is None:
                continue
            if prev is not None and t < prev:
                t = prev
            present.append((name, t))
            prev = t
        end = self.t_done if self.t_done is not None else self.t_submit
        if prev is not None:
            end = max(end, prev)
        return present, end

    def _segments(self) -> List[Tuple[str, float, float]]:
        """Contiguous (stage, start, end) intervals from the present
        marks. Each stage ends at the NEXT present mark (finally at
        the trace end), so the intervals tile [t_submit, end] exactly."""
        present, end = self._chain()
        segments = []
        for i, (name, t0) in enumerate(present):
            t1 = present[i + 1][1] if i + 1 < len(present) else end
            segments.append((name, t0, max(t0, t1)))
        return segments

    def stages(self) -> Dict[str, float]:
        return {name: round(t1 - t0, 9)
                for name, t0, t1 in self._segments()}

    def e2e_s(self) -> float:
        _, end = self._chain()
        return max(0.0, end - self.t_submit)

    def event_fields(self, stages: Optional[Dict[str, float]] = None,
                     ) -> Dict[str, Any]:
        """Payload for the `serve_request` event (schema: obs/events).
        Pass `stages` when the caller already derived them (the seal
        path) to avoid re-walking the mark chain per request."""
        fields: Dict[str, Any] = {
            "request_id": self.request_id,
            "kind": self.kind,
            "outcome": self.outcome or "ok",
            "stages": self.stages() if stages is None else stages,
            "e2e_s": round(self.e2e_s(), 9),
            "cache": self.cache,
            "sampled": self.sampled,
        }
        for name in ("bucket_len", "batch_class", "rows", "pad_fraction",
                     "prep_s", "device_s", "error", "head_id",
                     "segments", "segments_per_row", "mode", "quant",
                     "trace_id", "parent", "replica_id"):
            v = getattr(self, name)
            if v is not None:
                fields[name] = v
        return fields

    def export_spans(self, collector) -> None:
        """Replay the trace into a SpanCollector as one parent span
        (`serve.request`) plus one child per stage, on a per-request
        synthetic lane (tid = crc32 of the id) so concurrent requests
        do not nest into each other."""
        tid = zlib.crc32(self.request_id.encode()) & 0x7FFFFFFF
        base_args = {"request_id": self.request_id, "kind": self.kind,
                     "outcome": self.outcome or "ok"}
        if self.head_id is not None:
            base_args["head_id"] = self.head_id
        if self.bucket_len is not None:
            base_args["bucket_len"] = self.bucket_len
        if self.batch_class is not None:
            base_args["batch_class"] = self.batch_class
        if self.error is not None:
            base_args["error"] = self.error
        if self.trace_id is not None:
            base_args["trace_id"] = self.trace_id
        collector.add("serve.request", self.wall0, self.e2e_s(),
                      depth=0, tid=tid, **base_args)
        for name, t0, t1 in self._segments():
            if t1 - t0 < _MIN_SPAN_S:
                continue
            collector.add(f"serve.{name}", self.wall0 + (t0 - self.t_submit),
                          t1 - t0, depth=1, tid=tid,
                          request_id=self.request_id,
                          outcome=self.outcome or "ok")
