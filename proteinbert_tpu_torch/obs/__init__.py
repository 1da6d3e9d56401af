"""Unified telemetry — the port of `proteinbert_tpu/obs/` for training runs.

Four cooperating pieces behind one `Telemetry` facade, each a copy of its
JAX module (which differences each copy has, its docstring says):

- **events** — append-only, schema-versioned JSONL run events
  (`run_start`, `step`, `ckpt_stage`, `eval`, `requeue`, `nan_halt`,
  `run_end`, `note`) with crash-safe line-buffered writes; the same
  schema as the JAX package's, so one validator reads both streams;
- **metrics** — a labeled counter/gauge/histogram registry absorbing
  StepTimer summaries, overlap accounting and the data pipeline's
  counters; exports JSONL snapshots and a Prometheus-style textfile;
- **tracing** — nested host `span()`s that forward to
  `torch.profiler.record_function` while a torch profiler records and
  dump Perfetto-compatible trace-event JSON;
- **flight** — a bounded ring of the last N event records, dumped to
  `flight_<pid>.json` on SIGTERM / NaN-halt / unhandled exception.

This module copies the JAX `obs/__init__.py`'s `Telemetry`, `NULL` and
`as_telemetry`, and exports the same names, the serving SLO half
(`obs/slo.py`: `SLObjective`, `SLOEvaluator`, `ExemplarHistogram`,
`ProfileTrigger`, `parse_slo(s)`) included. `obs/diagnose.py` is not
ported: the JAX `pbt diagnose` reads the port's streams (one schema).

Overhead contract: `NULL` (the default when no telemetry is passed) is
a do-nothing facade — `emit` returns None, `span` is a shared
nullcontext, `metrics` is a disabled registry — so instrumented code
paths cost ~zero when telemetry is off.

No torch import: the package is stdlib-only, like the JAX one.
"""

from __future__ import annotations

import contextlib
import os
import threading as _threading
import time
from typing import Any, Dict, Optional

from proteinbert_tpu_torch.obs.events import (
    CKPT_PHASES, EVENT_FIELDS, FLEET_REPLICA_STATES,
    FLEET_REQUEST_OUTCOMES, INDEX_BUILD_STATES, INDEX_SHARD_STATES,
    MAP_OUTCOMES, MAP_SHARD_STATES, OUTCOMES,
    SCHEMA_VERSION,
    SERVE_OUTCOMES, SERVE_REJECT_REASONS, SERVE_REQUEST_OUTCOMES,
    EventLog,
    build_record, make_example, make_record, read_events, sanitize,
    validate_record,
)
from proteinbert_tpu_torch.obs.flight import (
    FlightRecorder, flight_path, validate_flight_dump,
)
from proteinbert_tpu_torch.obs.metrics import MetricsRegistry, QuantileWindow
from proteinbert_tpu_torch.obs.slo import (
    ExemplarHistogram, ProfileTrigger, SLObjective, SLOEvaluator,
    parse_slo, parse_slos,
)
from proteinbert_tpu_torch.obs.tracing import SpanCollector, span

_NULL_CTX = contextlib.nullcontext()


class Telemetry:
    """Bundle of event log + metrics registry + flight recorder +
    optional span collector, with one `emit()` that feeds both the
    durable stream and the crash ring."""

    enabled = True

    def __init__(
        self,
        events_path: Optional[str] = None,
        metrics: bool = True,
        flight_capacity: int = 256,
        flight_dir: Optional[str] = None,
        spans: bool = False,
    ):
        self.events = EventLog(events_path) if events_path else None
        self.metrics = MetricsRegistry(enabled=metrics)
        if flight_dir is None:
            flight_dir = (os.path.dirname(os.path.abspath(events_path))
                          if events_path else ".")
        self.flight = FlightRecorder(capacity=flight_capacity,
                                     directory=flight_dir)
        self.spans = SpanCollector() if spans else None
        self._seq = 0          # guarded-by: _lock
        self._last_t = 0.0     # guarded-by: _lock
        self._lock = _threading.Lock()

    def emit(self, event: str, **fields) -> Optional[Dict[str, Any]]:
        """Append one event record to the JSONL stream (when configured)
        AND to the flight ring. Never raises."""
        if self.events is not None:
            rec = self.events.emit(event, **fields)
        else:
            # Flight/metrics-only mode: the SAME construction contract
            # as the EventLog path (shared build_record: validation +
            # never-raises), with its own locked seq (the checkpoint
            # stager thread emits concurrently) and clamped t.
            with self._lock:
                t = max(time.time(), self._last_t)
                self._last_t = t
                rec = build_record(event, self._seq, t, fields)
                if rec is not None:
                    self._seq += 1
        if rec is not None:
            self.flight.record(rec)
        return rec

    def span(self, name: str, step: Optional[int] = None, **args):
        return span(name, collector=self.spans, step=step, **args)

    def dump_flight(self, reason: str) -> Optional[str]:
        return self.flight.dump(reason)

    def close(self) -> None:
        # Deliberately does NOT uninstall a flight excepthook: close()
        # runs in `finally` blocks BEFORE an escaping exception reaches
        # sys.excepthook, and the crash dump must still fire then (the
        # ring and dump path don't depend on the closed event file).
        if self.events is not None:
            self.events.close()


class _NullTelemetry:
    """Do-nothing stand-in: the default when no telemetry is configured.
    All instrumented call sites go through this with ~zero cost."""

    enabled = False
    events = None
    spans = None
    flight = None
    metrics = MetricsRegistry(enabled=False)

    def emit(self, event: str, **fields) -> None:
        return None

    def span(self, name: str, step: Optional[int] = None, **args):
        return _NULL_CTX

    def dump_flight(self, reason: str) -> None:
        return None

    def close(self) -> None:
        pass


NULL = _NullTelemetry()


def as_telemetry(t: Optional[Telemetry]) -> Any:
    """`telemetry or NULL` with an explicit name at every call site."""
    return t if t is not None else NULL


__all__ = [
    "Telemetry", "NULL", "as_telemetry",
    "EventLog", "read_events", "validate_record", "make_record",
    "make_example", "sanitize",
    "SCHEMA_VERSION", "EVENT_FIELDS", "CKPT_PHASES", "OUTCOMES",
    "SERVE_OUTCOMES", "SERVE_REJECT_REASONS", "SERVE_REQUEST_OUTCOMES",
    "FLEET_REPLICA_STATES", "FLEET_REQUEST_OUTCOMES",
    "INDEX_BUILD_STATES", "INDEX_SHARD_STATES",
    "MAP_OUTCOMES", "MAP_SHARD_STATES",
    "MetricsRegistry", "QuantileWindow",
    "SpanCollector", "span",
    "FlightRecorder", "flight_path", "validate_flight_dump",
    "SLObjective", "SLOEvaluator", "ExemplarHistogram", "ProfileTrigger",
    "parse_slo", "parse_slos",
]
