"""Structured run-event log: append-only, schema-versioned JSONL — a copy
of `proteinbert_tpu/obs/events.py` with the same schema (`SCHEMA_VERSION`
1, the same `EVENT_FIELDS`), so one validator reads both packages'
streams. Only the docstrings differ, and the comments, which drop the
JAX tree's issue numbers. The port's `run_start` sends
`jax_version="none"` (the field is required) and adds `torch_version`.

One stream per run, one JSON object per line. Every record carries the
schema version (`v`), the event type (`event`), a per-process monotonic
sequence number (`seq`), and a monotonically non-decreasing wall-clock
stamp (`t`) — so a reader can order records even across a torn tail and
correlate them with external logs. Writes are line-buffered appends: a
crash loses at most the partially-written last line, never an earlier
record, and `read_events` skips a torn tail instead of dying on it.

This module is deliberately stdlib-only (no jax import): the schema
validator (`tools/validate_events.py`) and `pbt diagnose` must work on
machines that only hold the artifacts.

Event types and their required payload fields are in EVENT_FIELDS;
`validate_record` is the single source of truth the writer, the
validator tool, and the tier-1 round-trip test all share.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1

# Per-type REQUIRED payload fields (name -> type or tuple of types).
# Extra fields are always allowed — the schema bounds the floor, not the
# ceiling, so emitters can attach context without a schema bump.
EVENT_FIELDS: Dict[str, Dict[str, Any]] = {
    # Run manifest: everything needed to interpret the rest of the
    # stream without the shell history (config, mesh, jax version).
    "run_start": {"config": dict, "jax_version": str, "pid": int},
    # One per log cadence; `metrics` is the logged metrics dict
    # (loss/acc + StepTimer summary incl. window_* rates).
    "step": {"step": int, "metrics": dict},
    # Checkpoint boundary lifecycle: phase in CKPT_PHASES.
    "ckpt_stage": {"step": int, "phase": str},
    # One per eval bracket (sync or overlap-resolved — same payload).
    "eval": {"step": int, "metrics": dict},
    # Preemption (SIGTERM/SIGINT): the run exits 75 for a supervisor.
    "requeue": {"step": int, "reason": str},
    # Non-finite loss/grad watch fired (on_nan halt or warn).
    "nan_halt": {"step": int, "metrics": dict},
    # Terminal record; outcome in OUTCOMES, perf is StepTimer.summary().
    "run_end": {"outcome": str, "perf": dict},
    # Generic annotated event for tools (tpu_watch, bench) that share
    # the stream format without being training runs.
    "note": {"source": str},
    # ---- online serving lifecycle (proteinbert_tpu/serve/) ----
    # Server manifest: serving config (buckets, batch classes, queue
    # depth, cache size) — the serving counterpart of run_start.
    "serve_start": {"config": dict, "pid": int},
    # One per dispatched micro-batch: which compiled shape class ran and
    # how full it was (rows ≤ the padded batch class size). Ragged
    # packed batches additionally carry `mode` ("ragged"),
    # `segments` (requests packed into the batch), `segments_per_row`,
    # and `pad_fraction` of the fixed (rows, seq_len) grid — typed
    # below when present.
    "serve_batch": {"kind": str, "bucket_len": int, "rows": int},
    # One per rejected request: reason in SERVE_REJECT_REASONS
    # (+ queue_depth at rejection time, when the emitter knows it).
    "serve_reject": {"reason": str},
    # Terminal serving record; outcome in SERVE_OUTCOMES, stats is
    # Server.stats() (requests/rejections/cache hit rate/latency).
    "serve_end": {"outcome": str, "stats": dict},
    # ---- per-request serve tracing + SLOs ----
    # One per SAMPLED (or failed/rejected — always sampled) request:
    # the request's stage-duration breakdown. `stages` maps stage name
    # (submit/queue/batch_form/dispatch/execute/finalize) → seconds;
    # stages are contiguous clock intervals, so their sum equals e2e_s
    # up to float rounding. outcome in SERVE_REQUEST_OUTCOMES. Extra
    # fields: e2e_s, bucket_len, batch_class, rows, pad_fraction,
    # cache, sampled, error.
    "serve_request": {"kind": str, "outcome": str, "request_id": str,
                      "stages": dict},
    # An SLO objective's burn rate crossed 1.0 (error budget burning
    # faster than it accrues). Extra fields: window_s, bad, total,
    # bad_fraction, attribution, profile_path.
    "slo_breach": {"objective": str, "burn_rate": (int, float)},
    # ---- multi-tenant head registry ----
    # A finetuned head landed in the registry (train/finetune.finetune
    # with registry=, or `pbt finetune --register-head`). `kind` is the
    # TaskConfig kind. Extra fields: name, trunk_fingerprint, metrics.
    "head_registered": {"head_id": str, "kind": str},
    # One downstream-task eval of a registered head (heads/eval.py,
    # `pbt eval-heads`, bench.py --heads). `metrics` carries the
    # per-task numbers (per_residue_accuracy / accuracy+auc_proxy /
    # spearman+mse) plus a normalized `score` — the series the bench-
    # trajectory sentinel fits so finetune-quality regressions gate
    # like perf does. Extra fields: kind, name.
    "head_eval": {"head_id": str, "metrics": dict},
    # ---- elastic topology ----
    # One checkpoint resharded onto a new mesh layout
    # (parallel/reshard.py, `pbt reshard`). `target_mesh` is the axis
    # dict the state was restored onto ({} = unsharded single device);
    # `wire_bytes` is the collective schedule's per-collective output
    # bytes from the HLO byte-counter (zero.collective_bytes_from_hlo),
    # or {"total": 0} with schedule="host_staged" when source and
    # target device sets differ and the move goes through the host.
    # Extra fields: source_mesh, zero_update, schedule, parity, src,
    # dst.
    "reshard": {"step": int, "target_mesh": dict, "wire_bytes": dict},
    # ---- serve fleet: router in front of N replicas ----
    # Router manifest (replica URLs, retry/health policy) — the fleet
    # counterpart of serve_start.
    "fleet_start": {"config": dict, "pid": int},
    # One replica state transition: state in FLEET_REPLICA_STATES.
    # Extra fields: url, reason, consecutive_failures, burn_rate.
    "fleet_replica": {"replica": str, "state": str},
    # One terminal routed request: outcome in FLEET_REQUEST_OUTCOMES
    # (every request the router ACCEPTS seals in exactly one of these —
    # the fleet-level funnel the drill harness audits). Typed optional
    # fields: replica, retries, status, trace_id, replica_id.
    "fleet_request": {"outcome": str, "path": str},
    # One forward attempt under a routed request: the
    # sibling record that turns a retry/hedge into a causal chain —
    # `trace_id` joins it to its `fleet_request` seal (and to the
    # replica-side `serve_request` records carrying the same id),
    # `attempt` is the 0-based index (== retries spent so far), outcome
    # in FLEET_ATTEMPT_OUTCOMES. Typed optional fields: status,
    # backoff_s (the wait that FOLLOWED a failed attempt), path.
    "fleet_attempt": {"trace_id": str, "attempt": int, "replica": str,
                      "outcome": str},
    # Terminal router record; outcome in SERVE_OUTCOMES, stats is
    # FleetRouter.stats().
    "fleet_end": {"outcome": str, "stats": dict},
    # ---- offline batch inference (`pbt map`) ----
    # Run manifest: the resolved map configuration (store dir, corpus
    # size, shard/block/row geometry, trunk fingerprint) — the mapping
    # counterpart of run_start.
    "map_start": {"config": dict, "pid": int},
    # One shard lifecycle transition: state in MAP_SHARD_STATES
    # (start/resume/done/halted/failed). Typed optional fields: blocks,
    # next, size (non-negative ints), reason, cursor_source.
    "map_shard": {"shard": int, "state": str},
    # One durably COMMITTED block (emitted only after the cursor
    # advance — the engine's commit point, so counting these across
    # incarnations measures re-work exactly). `digest` is the block
    # payload's sha256. Typed optional fields: retries, quarantined,
    # start, end (non-negative ints), seqs_per_s (non-negative finite).
    "map_block": {"shard": int, "block": int, "digest": str, "n": int},
    # Terminal mapping record; outcome in MAP_OUTCOMES, stats is the
    # run_map result (blocks/seqs/quarantined/retries/rework/...).
    "map_end": {"outcome": str, "stats": dict},
    # ---- neighbor index (`pbt index` + /v1/neighbors) ----
    # Build lifecycle: state in INDEX_BUILD_STATES ("start" opens the
    # run with stats={} + extra config/pid; the terminal record carries
    # the builder's stats dict — vectors/blocks/rework/bytes ratio).
    "index_build": {"state": str, "stats": dict},
    # One index-shard lifecycle transition: state in
    # INDEX_SHARD_STATES. Typed optional fields: blocks, next, size,
    # tail_reworked (non-negative ints), cursor_source.
    "index_shard": {"shard": int, "state": str},
    # One served /v1/neighbors lookup (sampled like serve_request —
    # failures always sampled): k/nprobe are the executable's static
    # shape. Typed optional fields: candidates (non-negative int),
    # lookup_s (non-negative finite seconds, the ANN leg),
    # outcome (SERVE_REQUEST_OUTCOMES).
    "neighbor_query": {"k": int, "nprobe": int},
    # ---- blue-green trunk rollout ----
    # One rollout lifecycle transition (controller or replica):
    # state in ROLLOUT_STATES. Typed optional fields: source,
    # fingerprint, reason (strings), windows_green (non-negative int),
    # flip_seconds (non-negative finite seconds).
    "rollout_state": {"state": str},
    # One closed shadow window: verdict in ROLLOUT_VERDICTS. Typed
    # optional fields: parity_max (non-negative finite; absent when a
    # structural mismatch made it unbounded), slo_burn_delta /
    # heads_eval_delta (finite — deltas, negative = the candidate
    # improved), shadow_ok / shadow_failed (non-negative ints).
    "rollout_window": {"window": int, "verdict": str},
    # One mirrored shadow attempt: the `shadow=true` sibling of a live
    # fleet_request under the SAME trace_id — never retried, never
    # user-visible, never cache-writing, and deliberately NOT a
    # fleet_attempt (attempts == retries+1 stays exact). outcome in
    # ROLLOUT_SHADOW_OUTCOMES; `shadow` is the literal-true flag
    # downstream filters key on. Typed optional fields: status (HTTP
    # code, or 0 for a transport failure), parity_max, path.
    "rollout_shadow": {"trace_id": str, "replica": str, "outcome": str,
                      "shadow": bool},
    # One atomic arm swap on a replica: phase in ROLLOUT_FLIP_PHASES;
    # `seconds` is the swap-lock flip (or re-replication rollback)
    # latency. Typed optional fields: fingerprint (the NEW resident
    # trunk), ok (bool).
    "rollout_flip": {"replica": str, "phase": str,
                     "seconds": (int, float)},
    # Fleet trunk-coherence transition from the router's health sweep:
    # state in ROLLOUT_FLEET_STATES; optional `fingerprints` counts the
    # distinct resident fingerprints over routable replicas.
    "rollout_fleet": {"state": str},
}

CKPT_PHASES = ("dispatch", "landed", "save")
OUTCOMES = ("completed", "preempted", "early_stopped", "nan_halt", "error")
SERVE_OUTCOMES = ("drained", "aborted")
SERVE_REJECT_REASONS = ("queue_full", "deadline", "closed", "too_long",
                        "unknown_head")
# Terminal per-request outcomes: ok/cache_hit resolve a result; error is
# a dispatch/finalize failure; expired missed its deadline; evicted lost
# its queue slot to newer work; rejected never got past admission;
# aborted was killed by a hard shutdown.
SERVE_REQUEST_OUTCOMES = ("ok", "cache_hit", "error", "expired",
                          "evicted", "rejected", "aborted")
# Fleet replica health states (serve/fleet.py): up (routable),
# degraded (SLO burn > threshold — deprioritized), dead (health checks
# failing), draining (operator drain: no new work, in-flight finishes),
# admitted (re-admitted after drain or recovery from dead).
FLEET_REPLICA_STATES = ("up", "degraded", "dead", "draining", "admitted")
# Terminal fleet-routed request outcomes: ok (first replica answered),
# cache_hit (the shared result cache short-circuited), retried_ok (a
# retry on another replica answered after a failure), shed (load shed —
# a typed 429/503 passthrough or router-side no-capacity 503), failed
# (a non-retryable error reached the client).
FLEET_REQUEST_OUTCOMES = ("ok", "cache_hit", "retried_ok", "shed",
                          "failed")
# Per-attempt outcomes under one routed request: ok (the
# replica answered 200), transport_failed (connection-level failure —
# the retry path's trigger), retryable (the replica answered a
# RETRYABLE status, 503), shed (typed backpressure passthrough,
# 429/504), failed (a non-retryable error answer).
FLEET_ATTEMPT_OUTCOMES = ("ok", "transport_failed", "retryable", "shed",
                          "failed")
# Map shard lifecycle states (mapper/engine.py): start (fresh cursor),
# resume (an existing cursor was picked up — incl. a torn-cursor /
# torn-tail fallback), done (shard exhausted), halted (non-finite
# embeddings — flight dump taken), failed (retry budget exhausted).
MAP_SHARD_STATES = ("start", "resume", "done", "halted", "failed")
# Terminal map-run outcomes: completed (every shard done), preempted
# (SIGTERM/SIGINT or a max-blocks bound — resumable, CLI exits 75),
# halted (a shard hit non-finite output), error (a shard exhausted its
# retry budget).
MAP_OUTCOMES = ("completed", "preempted", "halted", "error")
# Index-build lifecycle states (index/store.py, duplicated here because
# this module must stay import-light): start (run opened), completed,
# preempted (SIGTERM/SIGINT or --max-blocks — resumable, CLI exits
# 75), error.
INDEX_BUILD_STATES = ("start", "completed", "preempted", "error")
# Index shard lifecycle: start (fresh cursor), resume (existing cursor
# picked up — incl. torn-tail / prev-generation fallback), done,
# preempted (stopped mid-shard, resumable).
INDEX_SHARD_STATES = ("start", "resume", "done", "preempted")
# Blue-green rollout lifecycle (rollout/controller.py + serve/server.py)
# : candidate_loaded/candidate_unloaded are replica-side arm
# events; shadowing → (refused | promoting → promoted → rolled_back) and
# aborted are controller transitions.
ROLLOUT_STATES = ("candidate_loaded", "candidate_unloaded", "shadowing",
                  "refused", "promoting", "promoted", "rolled_back",
                  "aborted")
ROLLOUT_VERDICTS = ("pass", "fail")
ROLLOUT_SHADOW_OUTCOMES = ("ok", "failed")
ROLLOUT_FLIP_PHASES = ("flip", "rollback")
ROLLOUT_FLEET_STATES = ("coherent", "degraded")


def sanitize(value: Any) -> Any:
    """Recursively make `value` strict-JSON-safe: non-finite floats
    become None (a NaN-halt record must stay parseable — NaN/Inf are the
    one payload this log exists to capture and the one thing json.dumps
    emits invalid JSON for), numpy scalars collapse to Python scalars
    via their item()/float semantics, unknown objects become str()."""
    if isinstance(value, bool) or value is None or isinstance(value, str):
        return value
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, dict):
        return {str(k): sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set)):
        return [sanitize(v) for v in value]
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return sanitize(item())
        except Exception:
            pass
    return str(value)


def make_record(event: str, seq: int, t: float, **fields) -> Dict[str, Any]:
    return {"v": SCHEMA_VERSION, "event": event, "seq": seq,
            "t": round(float(t), 6), **sanitize(fields)}


def build_record(event: str, seq: int, t: float,
                 fields: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """make_record + validate under the never-raises contract: a
    malformed payload (schema violation, or a field colliding with a
    record key — TypeError from make_record) is logged and returns
    None. The ONE construction path for both EventLog.emit and the
    Telemetry facade's flight-only mode."""
    try:
        rec = make_record(event, seq=seq, t=t, **fields)
        validate_record(rec)
        return rec
    except (ValueError, TypeError):
        logger.warning("dropping malformed %r event", event, exc_info=True)
        return None


_SERVE_MODES = ("bucketed", "ragged")
# Quantized serving arms (parallel/quant.SERVE_QUANT_MODES;
# duplicated here because this module must stay stdlib-only). "fp32"
# is never emitted (the field is absent on the fp32 arm) but accepted.
_SERVE_QUANT_MODES = ("fp32", "int8", "int8_act")


def _validate_quant_fields(event: str, rec: Dict[str, Any]) -> None:
    """Optional quantized-arm fields shared by serve_batch and
    serve_request: `quant` (which executable arm served)
    and, on parity-sampled batches, `quant_parity_max` (worst abs
    deviation vs the fp32 shadow). Typed when present."""
    q = rec.get("quant")
    if q is not None and q not in _SERVE_QUANT_MODES:
        raise ValueError(f"{event}.quant {q!r} not in "
                         f"{_SERVE_QUANT_MODES}")
    pm = rec.get("quant_parity_max")
    if pm is not None and (isinstance(pm, bool)
                           or not isinstance(pm, (int, float))
                           or not math.isfinite(pm) or pm < 0):
        raise ValueError(f"{event}.quant_parity_max must be a "
                         f"non-negative finite number, got {pm!r}")


def _validate_packed_fields(event: str, rec: Dict[str, Any]) -> None:
    """Optional ragged-packing fields shared by serve_batch and
    serve_request: typed when present, absent on older
    streams and the bucketed path."""
    seg = rec.get("segments")
    if seg is not None and (not isinstance(seg, int)
                            or isinstance(seg, bool) or seg < 0):
        raise ValueError(f"{event}.segments must be a non-negative int, "
                         f"got {seg!r}")
    spr = rec.get("segments_per_row")
    if spr is not None and (isinstance(spr, bool)
                            or not isinstance(spr, (int, float))
                            or not math.isfinite(spr) or spr < 0):
        raise ValueError(f"{event}.segments_per_row must be a "
                         f"non-negative finite number, got {spr!r}")
    mode = rec.get("mode")
    if mode is not None and mode not in _SERVE_MODES:
        raise ValueError(f"{event}.mode {mode!r} not in {_SERVE_MODES}")
    pf = rec.get("pad_fraction")
    if pf is not None and (isinstance(pf, bool)
                           or not isinstance(pf, (int, float))
                           or not math.isfinite(pf)
                           or not 0.0 <= pf <= 1.0):
        raise ValueError(f"{event}.pad_fraction must be a number in "
                         f"[0, 1], got {pf!r}")


def _validate_trace_fields(event: str, rec: Dict[str, Any]) -> None:
    """Optional fleet-trace join fields shared by
    serve_request, serve_batch, and fleet_request: `trace_id` (the
    fleet-scope id the router minted and the X-PBT-Trace header
    propagated), `parent` (the enclosing fleet request's id), and
    `replica_id` (the --replica-id identity stamped at emit). All
    strings, typed when present — absent on pre-fleet streams and
    standalone servers."""
    for name in ("trace_id", "parent", "replica_id"):
        v = rec.get(name)
        if v is not None and not isinstance(v, str):
            raise ValueError(f"{event}.{name} must be a string, "
                             f"got {v!r}")


def validate_record(rec: Any) -> None:
    """Raise ValueError (with a pinpointing message) unless `rec` is a
    well-formed event record. The writer, tools/validate_events.py, and
    the tier-1 round-trip test all call THIS function — one schema."""
    if not isinstance(rec, dict):
        raise ValueError(f"record is not an object: {type(rec).__name__}")
    if rec.get("v") != SCHEMA_VERSION:
        raise ValueError(f"schema version {rec.get('v')!r} != {SCHEMA_VERSION}")
    event = rec.get("event")
    if event not in EVENT_FIELDS:
        raise ValueError(f"unknown event type {event!r} "
                         f"(have {sorted(EVENT_FIELDS)})")
    seq = rec.get("seq")
    if not isinstance(seq, int) or isinstance(seq, bool) or seq < 0:
        raise ValueError(f"seq must be a non-negative int, got {seq!r}")
    t = rec.get("t")
    if not isinstance(t, (int, float)) or isinstance(t, bool) \
            or not math.isfinite(t):
        raise ValueError(f"t must be a finite number, got {t!r}")
    for name, typ in EVENT_FIELDS[event].items():
        if name not in rec:
            raise ValueError(f"{event}: missing required field {name!r}")
        if not isinstance(rec[name], typ):
            raise ValueError(
                f"{event}.{name}: expected {typ}, got {type(rec[name]).__name__}")
    if "step" in rec:
        s = rec["step"]
        if not isinstance(s, int) or isinstance(s, bool) or s < 0:
            raise ValueError(f"step must be a non-negative int, got {s!r}")
    if event == "ckpt_stage" and rec["phase"] not in CKPT_PHASES:
        raise ValueError(f"ckpt_stage.phase {rec['phase']!r} not in "
                         f"{CKPT_PHASES}")
    if event == "run_end" and rec["outcome"] not in OUTCOMES:
        raise ValueError(f"run_end.outcome {rec['outcome']!r} not in "
                         f"{OUTCOMES}")
    if event == "serve_end" and rec["outcome"] not in SERVE_OUTCOMES:
        raise ValueError(f"serve_end.outcome {rec['outcome']!r} not in "
                         f"{SERVE_OUTCOMES}")
    if event == "serve_reject":
        if rec["reason"] not in SERVE_REJECT_REASONS:
            raise ValueError(f"serve_reject.reason {rec['reason']!r} not in "
                             f"{SERVE_REJECT_REASONS}")
        # queue_depth is optional (older streams predate it) but typed.
        qd = rec.get("queue_depth")
        if qd is not None and (not isinstance(qd, int)
                               or isinstance(qd, bool) or qd < 0):
            raise ValueError(f"serve_reject.queue_depth must be a "
                             f"non-negative int, got {qd!r}")
    if event == "serve_batch":
        for field in ("bucket_len", "rows"):
            v = rec[field]
            if isinstance(v, bool) or v < 0:
                raise ValueError(
                    f"serve_batch.{field} must be a non-negative int, "
                    f"got {v!r}")
        _validate_packed_fields(event, rec)
        _validate_quant_fields(event, rec)
        _validate_trace_fields(event, rec)
    if event == "serve_request":
        _validate_packed_fields(event, rec)
        _validate_quant_fields(event, rec)
        _validate_trace_fields(event, rec)
        if rec["outcome"] not in SERVE_REQUEST_OUTCOMES:
            raise ValueError(f"serve_request.outcome {rec['outcome']!r} "
                             f"not in {SERVE_REQUEST_OUTCOMES}")
        for name, v in rec["stages"].items():
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or not math.isfinite(v) or v < 0:
                raise ValueError(
                    f"serve_request.stages[{name!r}] must be a "
                    f"non-negative finite number, got {v!r}")
        # head_id is optional (only predict_task requests carry one —
        # the per-tenant attribution field of diagnose --serve) but
        # typed when present.
        hid = rec.get("head_id")
        if hid is not None and not isinstance(hid, str):
            raise ValueError(f"serve_request.head_id must be a string, "
                             f"got {hid!r}")
    if event == "head_eval":
        for name, v in rec["metrics"].items():
            if isinstance(v, bool) or (
                    not isinstance(v, (int, float, str))
                    and v is not None):
                raise ValueError(
                    f"head_eval.metrics[{name!r}] must be a number, "
                    f"string, or null, got {type(v).__name__}")
    if event == "slo_breach":
        br = rec["burn_rate"]
        if isinstance(br, bool) or not math.isfinite(br) or br < 0:
            raise ValueError(f"slo_breach.burn_rate must be a "
                             f"non-negative finite number, got {br!r}")
    if event == "reshard":
        for name, v in rec["wire_bytes"].items():
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"reshard.wire_bytes[{name!r}] must be a "
                    f"non-negative int, got {v!r}")
        for k in rec["target_mesh"]:
            if not isinstance(k, str):
                raise ValueError(
                    f"reshard.target_mesh keys must be axis names, "
                    f"got {k!r}")
    if event == "fleet_replica" and rec["state"] not in FLEET_REPLICA_STATES:
        raise ValueError(f"fleet_replica.state {rec['state']!r} not in "
                         f"{FLEET_REPLICA_STATES}")
    if event == "fleet_request":
        if rec["outcome"] not in FLEET_REQUEST_OUTCOMES:
            raise ValueError(f"fleet_request.outcome {rec['outcome']!r} "
                             f"not in {FLEET_REQUEST_OUTCOMES}")
        retries = rec.get("retries")
        if retries is not None and (not isinstance(retries, int)
                                    or isinstance(retries, bool)
                                    or retries < 0):
            raise ValueError(f"fleet_request.retries must be a "
                             f"non-negative int, got {retries!r}")
        status = rec.get("status")
        if status is not None and (not isinstance(status, int)
                                   or isinstance(status, bool)
                                   or not 100 <= status <= 599):
            raise ValueError(f"fleet_request.status must be an HTTP "
                             f"status code, got {status!r}")
        rep = rec.get("replica")
        if rep is not None and not isinstance(rep, str):
            raise ValueError(f"fleet_request.replica must be a string, "
                             f"got {rep!r}")
        _validate_trace_fields(event, rec)
    if event == "fleet_attempt":
        if rec["outcome"] not in FLEET_ATTEMPT_OUTCOMES:
            raise ValueError(f"fleet_attempt.outcome {rec['outcome']!r} "
                             f"not in {FLEET_ATTEMPT_OUTCOMES}")
        att = rec["attempt"]
        if isinstance(att, bool) or att < 0:
            raise ValueError(f"fleet_attempt.attempt must be a "
                             f"non-negative int, got {att!r}")
        status = rec.get("status")
        if status is not None and (not isinstance(status, int)
                                   or isinstance(status, bool)
                                   or not 100 <= status <= 599):
            raise ValueError(f"fleet_attempt.status must be an HTTP "
                             f"status code, got {status!r}")
        bo = rec.get("backoff_s")
        if bo is not None and (isinstance(bo, bool)
                               or not isinstance(bo, (int, float))
                               or not math.isfinite(bo) or bo < 0):
            raise ValueError(f"fleet_attempt.backoff_s must be a "
                             f"non-negative finite number, got {bo!r}")
        path = rec.get("path")
        if path is not None and not isinstance(path, str):
            raise ValueError(f"fleet_attempt.path must be a string, "
                             f"got {path!r}")
    if event == "fleet_end" and rec["outcome"] not in SERVE_OUTCOMES:
        raise ValueError(f"fleet_end.outcome {rec['outcome']!r} not in "
                         f"{SERVE_OUTCOMES}")
    if event in ("map_shard", "map_block"):
        for name in ("shard", "block", "n", "blocks", "next", "size",
                     "start", "end", "retries", "quarantined"):
            v = rec.get(name)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 0):
                raise ValueError(f"{event}.{name} must be a "
                                 f"non-negative int, got {v!r}")
    if event == "map_shard" and rec["state"] not in MAP_SHARD_STATES:
        raise ValueError(f"map_shard.state {rec['state']!r} not in "
                         f"{MAP_SHARD_STATES}")
    if event == "map_block":
        dg = rec["digest"]
        if len(dg) != 64 or any(c not in "0123456789abcdef" for c in dg):
            raise ValueError(f"map_block.digest must be a lowercase "
                             f"sha256 hex digest, got {dg!r}")
        sps = rec.get("seqs_per_s")
        if sps is not None and (isinstance(sps, bool)
                                or not isinstance(sps, (int, float))
                                or not math.isfinite(sps) or sps < 0):
            raise ValueError(f"map_block.seqs_per_s must be a "
                             f"non-negative finite number, got {sps!r}")
    if event == "map_end" and rec["outcome"] not in MAP_OUTCOMES:
        raise ValueError(f"map_end.outcome {rec['outcome']!r} not in "
                         f"{MAP_OUTCOMES}")
    if event == "index_build" and rec["state"] not in INDEX_BUILD_STATES:
        raise ValueError(f"index_build.state {rec['state']!r} not in "
                         f"{INDEX_BUILD_STATES}")
    if event == "index_shard":
        if rec["state"] not in INDEX_SHARD_STATES:
            raise ValueError(f"index_shard.state {rec['state']!r} not "
                             f"in {INDEX_SHARD_STATES}")
        for name in ("shard", "blocks", "next", "size", "tail_reworked"):
            v = rec.get(name)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 0):
                raise ValueError(f"index_shard.{name} must be a "
                                 f"non-negative int, got {v!r}")
    if event == "neighbor_query":
        for name in ("k", "nprobe"):
            v = rec[name]
            if isinstance(v, bool) or v < 1:
                raise ValueError(f"neighbor_query.{name} must be a "
                                 f"positive int, got {v!r}")
        cand = rec.get("candidates")
        if cand is not None and (not isinstance(cand, int)
                                 or isinstance(cand, bool) or cand < 0):
            raise ValueError(f"neighbor_query.candidates must be a "
                             f"non-negative int, got {cand!r}")
        ls = rec.get("lookup_s")
        if ls is not None and (isinstance(ls, bool)
                               or not isinstance(ls, (int, float))
                               or not math.isfinite(ls) or ls < 0):
            raise ValueError(f"neighbor_query.lookup_s must be a "
                             f"non-negative finite number, got {ls!r}")
        oc = rec.get("outcome")
        if oc is not None and oc not in SERVE_REQUEST_OUTCOMES:
            raise ValueError(f"neighbor_query.outcome {oc!r} not in "
                             f"{SERVE_REQUEST_OUTCOMES}")
    if event == "rollout_state":
        if rec["state"] not in ROLLOUT_STATES:
            raise ValueError(f"rollout_state.state {rec['state']!r} not "
                             f"in {ROLLOUT_STATES}")
        for name in ("source", "fingerprint", "reason"):
            v = rec.get(name)
            if v is not None and not isinstance(v, str):
                raise ValueError(f"rollout_state.{name} must be a "
                                 f"string, got {v!r}")
        wg = rec.get("windows_green")
        if wg is not None and (not isinstance(wg, int)
                               or isinstance(wg, bool) or wg < 0):
            raise ValueError(f"rollout_state.windows_green must be a "
                             f"non-negative int, got {wg!r}")
        fs = rec.get("flip_seconds")
        if fs is not None and (isinstance(fs, bool)
                               or not isinstance(fs, (int, float))
                               or not math.isfinite(fs) or fs < 0):
            raise ValueError(f"rollout_state.flip_seconds must be a "
                             f"non-negative finite number, got {fs!r}")
    if event == "rollout_window":
        if rec["verdict"] not in ROLLOUT_VERDICTS:
            raise ValueError(f"rollout_window.verdict "
                             f"{rec['verdict']!r} not in "
                             f"{ROLLOUT_VERDICTS}")
        w = rec["window"]
        if isinstance(w, bool) or w < 0:
            raise ValueError(f"rollout_window.window must be a "
                             f"non-negative int, got {w!r}")
        pm = rec.get("parity_max")
        if pm is not None and (isinstance(pm, bool)
                               or not isinstance(pm, (int, float))
                               or not math.isfinite(pm) or pm < 0):
            raise ValueError(f"rollout_window.parity_max must be a "
                             f"non-negative finite number, got {pm!r}")
        for name in ("slo_burn_delta", "heads_eval_delta"):
            v = rec.get(name)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))
                                  or not math.isfinite(v)):
                raise ValueError(f"rollout_window.{name} must be a "
                                 f"finite number, got {v!r}")
        for name in ("shadow_ok", "shadow_failed"):
            v = rec.get(name)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 0):
                raise ValueError(f"rollout_window.{name} must be a "
                                 f"non-negative int, got {v!r}")
    if event == "rollout_shadow":
        if rec["outcome"] not in ROLLOUT_SHADOW_OUTCOMES:
            raise ValueError(f"rollout_shadow.outcome "
                             f"{rec['outcome']!r} not in "
                             f"{ROLLOUT_SHADOW_OUTCOMES}")
        if rec["shadow"] is not True:
            # The invisibility audit filters on shadow==true; a record
            # claiming to be a shadow while flagging false would let
            # shadow traffic masquerade as live (or vice versa).
            raise ValueError(f"rollout_shadow.shadow must be literally "
                             f"true, got {rec['shadow']!r}")
        status = rec.get("status")
        if status is not None and (not isinstance(status, int)
                                   or isinstance(status, bool)
                                   or not (status == 0
                                           or 100 <= status <= 599)):
            raise ValueError(f"rollout_shadow.status must be an HTTP "
                             f"status code (or 0 for a transport "
                             f"failure), got {status!r}")
        pm = rec.get("parity_max")
        if pm is not None and (isinstance(pm, bool)
                               or not isinstance(pm, (int, float))
                               or not math.isfinite(pm) or pm < 0):
            raise ValueError(f"rollout_shadow.parity_max must be a "
                             f"non-negative finite number, got {pm!r}")
        path = rec.get("path")
        if path is not None and not isinstance(path, str):
            raise ValueError(f"rollout_shadow.path must be a string, "
                             f"got {path!r}")
    if event == "rollout_flip":
        if rec["phase"] not in ROLLOUT_FLIP_PHASES:
            raise ValueError(f"rollout_flip.phase {rec['phase']!r} not "
                             f"in {ROLLOUT_FLIP_PHASES}")
        s = rec["seconds"]
        if isinstance(s, bool) or not math.isfinite(s) or s < 0:
            raise ValueError(f"rollout_flip.seconds must be a "
                             f"non-negative finite number, got {s!r}")
        fp = rec.get("fingerprint")
        if fp is not None and not isinstance(fp, str):
            raise ValueError(f"rollout_flip.fingerprint must be a "
                             f"string, got {fp!r}")
        ok = rec.get("ok")
        if ok is not None and not isinstance(ok, bool):
            raise ValueError(f"rollout_flip.ok must be a bool, "
                             f"got {ok!r}")
    if event == "rollout_fleet":
        if rec["state"] not in ROLLOUT_FLEET_STATES:
            raise ValueError(f"rollout_fleet.state {rec['state']!r} not "
                             f"in {ROLLOUT_FLEET_STATES}")
        n = rec.get("fingerprints")
        if n is not None and (not isinstance(n, int)
                              or isinstance(n, bool) or n < 0):
            raise ValueError(f"rollout_fleet.fingerprints must be a "
                             f"non-negative int, got {n!r}")
    if event == "note" and rec.get("kind") == "rollout_capture":
        # The rollout drill capture (tools/rollout_drill.py): worst
        # shadow parity through the good candidate + the atomic-flip
        # latency are trajectory-sentinel inputs (both lower-is-
        # better), so a writer bug must fail validation, not poison
        # the series.
        for name in ("rollout_shadow_parity_max", "rollout_flip_seconds"):
            v = rec.get(name)
            if v is None:
                raise ValueError(
                    f"note(kind=rollout_capture): missing required "
                    f"field {name!r}")
            if (isinstance(v, bool) or not isinstance(v, (int, float))
                    or not math.isfinite(v) or v < 0):
                raise ValueError(
                    f"note(kind=rollout_capture).{name} must be a "
                    f"non-negative finite number, got {v!r}")
    if event == "note" and rec.get("kind") == "map_capture":
        # The map-throughput capture (tools/map_drill.py --bench-events):
        # its rate field is a trajectory-sentinel input, so a writer bug
        # must fail validation, not poison the series.
        v = rec.get("map_seqs_per_s")
        if v is None:
            raise ValueError(
                "note(kind=map_capture): missing required field "
                "'map_seqs_per_s'")
        if (isinstance(v, bool) or not isinstance(v, (int, float))
                or not math.isfinite(v) or v <= 0):
            raise ValueError(
                f"note(kind=map_capture).map_seqs_per_s must be a "
                f"positive finite number, got {v!r}")
        # Pipelined-mapper overlap evidence: the share of
        # host fetch+commit seconds spent with a later block's device
        # compute enqueued — a ratio, so [0, 1] by construction.
        r = rec.get("map_overlap_ratio")
        if r is not None and (isinstance(r, bool)
                              or not isinstance(r, (int, float))
                              or not math.isfinite(r)
                              or not 0.0 <= r <= 1.0):
            raise ValueError(
                f"note(kind=map_capture).map_overlap_ratio must be a "
                f"number in [0, 1], got {r!r}")
    if event == "note" and rec.get("kind") == "check_capture":
        # The static-analyzer capture (`pbt check --events-jsonl`)
        # : check_findings_total (new + baselined findings) is
        # the trajectory sentinel's suppression-creep series, so a
        # writer bug must fail validation, not poison the series.
        for name in ("check_findings_total", "check_baselined_total"):
            v = rec.get(name)
            if name == "check_findings_total" and v is None:
                raise ValueError(
                    "note(kind=check_capture): missing required field "
                    "'check_findings_total'")
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 0):
                raise ValueError(
                    f"note(kind=check_capture).{name} must be a "
                    f"non-negative int, got {v!r}")
    if event == "note" and rec.get("kind") == "restore_fallback":
        # The checkpointer's torn-final-checkpoint fallback report
        # (train/checkpoint.py): bad_step (the skipped torn step) is
        # required; landed_step (the step actually restored) is typed
        # when present (older streams predate it).
        bs = rec.get("bad_step")
        if not isinstance(bs, int) or isinstance(bs, bool) or bs < 0:
            raise ValueError(
                f"note(kind=restore_fallback).bad_step must be a "
                f"non-negative int, got {bs!r}")
        ls = rec.get("landed_step")
        if ls is not None and (not isinstance(ls, int)
                               or isinstance(ls, bool) or ls < 0):
            raise ValueError(
                f"note(kind=restore_fallback).landed_step must be a "
                f"non-negative int, got {ls!r}")
    if event == "note" and rec.get("kind") == "comm_quant":
        # The quantized-collectives capture (bench.py --comm): its ratio
        # fields are the trajectory-sentinel inputs, so
        # a writer bug must fail validation, not poison the series.
        for name in ("int8_grad_wire_ratio", "bf16_grad_wire_ratio"):
            v = rec.get(name)
            if name == "int8_grad_wire_ratio" and v is None:
                raise ValueError(
                    "note(kind=comm_quant): missing required field "
                    "'int8_grad_wire_ratio'")
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))
                                  or not math.isfinite(v) or v <= 0):
                raise ValueError(
                    f"note(kind=comm_quant).{name} must be a positive "
                    f"finite number, got {v!r}")
    if event == "note" and rec.get("kind") == "pack_attn_capture":
        # The ragged-attention A/B capture (bench.py --pack):
        # its speedup/MFU fields feed trajectory-sentinel series, so a
        # writer bug must fail validation, not poison the series.
        v = rec.get("attn_speedup_x")
        if v is None:
            raise ValueError(
                "note(kind=pack_attn_capture): missing required field "
                "'attn_speedup_x'")
        if (isinstance(v, bool) or not isinstance(v, (int, float))
                or not math.isfinite(v) or v <= 0):
            raise ValueError(
                f"note(kind=pack_attn_capture).attn_speedup_x must be "
                f"a positive finite number, got {v!r}")
        for name in ("mfu_effective", "mfu_raw", "parity_max_abs_diff"):
            v = rec.get(name)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))
                                  or not math.isfinite(v) or v < 0):
                raise ValueError(
                    f"note(kind=pack_attn_capture).{name} must be a "
                    f"non-negative finite number, got {v!r}")
    if event == "note" and rec.get("kind") == "onepass_capture":
        # The one-pass trunk A/B capture (bench.py --pack):
        # single fused block-pass kernel vs the two-kernel composition.
        # Its speedup/MFU fields feed trajectory-sentinel series, so a
        # writer bug must fail validation, not poison the series.
        v = rec.get("onepass_speedup_x")
        if v is None:
            raise ValueError(
                "note(kind=onepass_capture): missing required field "
                "'onepass_speedup_x'")
        if (isinstance(v, bool) or not isinstance(v, (int, float))
                or not math.isfinite(v) or v <= 0):
            raise ValueError(
                f"note(kind=onepass_capture).onepass_speedup_x must be "
                f"a positive finite number, got {v!r}")
        for name in ("mfu_effective", "mfu_raw", "parity_max_abs_diff"):
            v = rec.get(name)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))
                                  or not math.isfinite(v) or v < 0):
                raise ValueError(
                    f"note(kind=onepass_capture).{name} must be a "
                    f"non-negative finite number, got {v!r}")
    if event == "note" and rec.get("kind") == "fleet_trace_capture":
        # The fleet-propagation overhead A/B (bench.py --serve fleet
        # arm): routed-throughput delta with trace
        # propagation on vs off. The pct is a trajectory-sentinel
        # input (lower-is-better), so a writer bug must fail
        # validation, not poison the series. It is a DIFFERENCE, so
        # negative values (measurement noise) are legal — finiteness
        # is the bound.
        v = rec.get("fleet_trace_overhead_pct")
        if v is None:
            raise ValueError(
                "note(kind=fleet_trace_capture): missing required "
                "field 'fleet_trace_overhead_pct'")
        if (isinstance(v, bool) or not isinstance(v, (int, float))
                or not math.isfinite(v)):
            raise ValueError(
                f"note(kind=fleet_trace_capture).fleet_trace_overhead_"
                f"pct must be a finite number, got {v!r}")
        for name in ("fleet_rps_on", "fleet_rps_off"):
            v = rec.get(name)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))
                                  or not math.isfinite(v) or v <= 0):
                raise ValueError(
                    f"note(kind=fleet_trace_capture).{name} must be a "
                    f"positive finite number, got {v!r}")
        # the pct is the MEDIAN over this many A/B
        # rounds (a single-round number sign-flipped under
        # load); typed when present so the sentinel can trust it.
        n = rec.get("rounds")
        if n is not None and (not isinstance(n, int)
                              or isinstance(n, bool) or n < 1):
            raise ValueError(
                f"note(kind=fleet_trace_capture).rounds must be a "
                f"positive int, got {n!r}")
    if event == "note" and rec.get("kind") == "neighbors_capture":
        # The ANN serving capture (bench.py --neighbors):
        # its QPS and recall fields feed trajectory-sentinel series
        # (recall is HIGHER-is-better), so a writer bug must fail
        # validation, not poison the series.
        for name in ("neighbors_qps", "neighbors_recall_at_10"):
            v = rec.get(name)
            if v is None:
                raise ValueError(
                    f"note(kind=neighbors_capture): missing required "
                    f"field {name!r}")
        v = rec.get("neighbors_qps")
        if (isinstance(v, bool) or not isinstance(v, (int, float))
                or not math.isfinite(v) or v <= 0):
            raise ValueError(
                f"note(kind=neighbors_capture).neighbors_qps must be "
                f"a positive finite number, got {v!r}")
        r = rec.get("neighbors_recall_at_10")
        if (isinstance(r, bool) or not isinstance(r, (int, float))
                or not math.isfinite(r) or not 0.0 <= r <= 1.0):
            raise ValueError(
                f"note(kind=neighbors_capture).neighbors_recall_at_10 "
                f"must be a number in [0, 1], got {r!r}")
        for name in ("embed_qps", "neighbors_qps_ratio",
                     "index_bytes_ratio"):
            v = rec.get(name)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))
                                  or not math.isfinite(v) or v <= 0):
                raise ValueError(
                    f"note(kind=neighbors_capture).{name} must be a "
                    f"positive finite number, got {v!r}")
    if event == "note" and rec.get("kind") == "serve_pipeline_capture":
        # The pipelined-dispatch A/B capture (bench.py --serve pipeline
        # phase): depth-2 vs depth-1 served throughput, gated
        # on async-vs-sync output bit-parity and exactly-once sealing
        # under drain with work in flight. The speedup is a trajectory-
        # sentinel input, so a writer bug must fail validation, not
        # poison the series.
        v = rec.get("serve_pipeline_speedup_x")
        if v is None:
            raise ValueError(
                "note(kind=serve_pipeline_capture): missing required "
                "field 'serve_pipeline_speedup_x'")
        if (isinstance(v, bool) or not isinstance(v, (int, float))
                or not math.isfinite(v) or v <= 0):
            raise ValueError(
                f"note(kind=serve_pipeline_capture)."
                f"serve_pipeline_speedup_x must be a positive finite "
                f"number, got {v!r}")
        for name in ("pipeline_rps", "serial_rps"):
            v = rec.get(name)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))
                                  or not math.isfinite(v) or v <= 0):
                raise ValueError(
                    f"note(kind=serve_pipeline_capture).{name} must be "
                    f"a positive finite number, got {v!r}")
        r = rec.get("serve_overlap_ratio")
        if r is not None and (isinstance(r, bool)
                              or not isinstance(r, (int, float))
                              or not math.isfinite(r)
                              or not 0.0 <= r <= 1.0):
            raise ValueError(
                f"note(kind=serve_pipeline_capture).serve_overlap_"
                f"ratio must be a number in [0, 1], got {r!r}")
        im = rec.get("inflight_max")
        if im is not None and (not isinstance(im, int)
                               or isinstance(im, bool) or im < 0):
            raise ValueError(
                f"note(kind=serve_pipeline_capture).inflight_max must "
                f"be a non-negative int, got {im!r}")


def make_example(event: str) -> Dict[str, Any]:
    """A minimal valid record of `event` — the self-test/round-trip
    fixture, kept next to the schema so adding an event type without a
    fixture fails the validator self-test immediately."""
    payloads = {
        "run_start": {"config": {"train": {"max_steps": 1}},
                      "jax_version": "0.0.0", "pid": 1},
        "step": {"step": 1, "metrics": {"loss": 1.0}},
        "ckpt_stage": {"step": 1, "phase": "dispatch"},
        "eval": {"step": 1, "metrics": {"eval_loss": 1.0}},
        "requeue": {"step": 1, "reason": "signal_15"},
        "nan_halt": {"step": 1, "metrics": {"loss": None}},
        "run_end": {"outcome": "completed", "perf": {}},
        "note": {"source": "self_test"},
        "serve_start": {"config": {"max_batch": 8}, "pid": 1},
        "serve_batch": {"kind": "embed", "bucket_len": 128, "rows": 4},
        "serve_reject": {"reason": "queue_full", "queue_depth": 4},
        "serve_end": {"outcome": "drained", "stats": {"requests": 0}},
        "serve_request": {"kind": "embed", "outcome": "ok",
                          "request_id": "r000001",
                          "stages": {"queue": 0.001, "execute": 0.004}},
        "slo_breach": {"objective": "latency_e2e", "burn_rate": 2.5},
        "head_registered": {"head_id": "a1b2c3d4e5f60708",
                            "kind": "token_classification"},
        "head_eval": {"head_id": "a1b2c3d4e5f60708",
                      "metrics": {"per_residue_accuracy": 0.9,
                                  "score": 0.9}},
        "reshard": {"step": 1, "target_mesh": {"data": 4, "fsdp": 2},
                    "wire_bytes": {"all-gather": 1024, "total": 1024}},
        "fleet_start": {"config": {"replicas": 3}, "pid": 1},
        "fleet_replica": {"replica": "r0", "state": "up"},
        "fleet_request": {"outcome": "ok", "path": "/v1/embed",
                          "replica": "r0", "retries": 0, "status": 200,
                          "trace_id": "f1-1"},
        "fleet_attempt": {"trace_id": "f1-1", "attempt": 0,
                          "replica": "r0", "outcome": "ok",
                          "status": 200, "path": "/v1/embed"},
        "fleet_end": {"outcome": "drained", "stats": {"accepted": 0}},
        "map_start": {"config": {"num_shards": 2}, "pid": 1},
        "map_shard": {"shard": 0, "state": "start", "next": 0,
                      "size": 16},
        "map_block": {"shard": 0, "block": 0, "digest": "0" * 64,
                      "n": 8, "seqs_per_s": 12.5},
        "map_end": {"outcome": "completed", "stats": {"blocks": 1}},
        "index_build": {"state": "start", "stats": {}, "pid": 1},
        "index_shard": {"shard": 0, "state": "start", "next": 0,
                        "size": 16},
        "neighbor_query": {"k": 10, "nprobe": 8, "candidates": 64,
                           "lookup_s": 0.001, "outcome": "ok"},
        "rollout_state": {"state": "shadowing", "source": "good",
                          "fingerprint": "f" * 64, "windows_green": 0},
        "rollout_window": {"window": 0, "verdict": "pass",
                           "parity_max": 0.0001, "slo_burn_delta": 0.0,
                           "heads_eval_delta": 0.0, "shadow_ok": 8,
                           "shadow_failed": 0},
        "rollout_shadow": {"trace_id": "f1-1", "replica": "r0",
                           "outcome": "ok", "shadow": True,
                           "status": 200, "parity_max": 0.0,
                           "path": "/v1/embed"},
        "rollout_flip": {"replica": "r0", "phase": "flip",
                         "seconds": 0.01, "fingerprint": "f" * 64,
                         "ok": True},
        "rollout_fleet": {"state": "coherent", "fingerprints": 1},
    }
    return make_record(event, seq=0, t=0.0, **payloads[event])


class EventLog:
    """Append-only JSONL event writer.

    - line-buffered file (crash loses at most the in-flight line);
    - thread-safe (the checkpoint stager thread emits from off-main);
    - `seq` monotonic per process, `t` clamped non-decreasing;
    - NEVER raises from emit(): telemetry must not be able to kill a
      training run — a failing disk logs one warning and disables the
      writer, the run continues.
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()
        self._seq = 0          # guarded-by: _lock
        self._last_t = 0.0     # guarded-by: _lock
        self._dead = False     # guarded-by: _lock

    def emit(self, event: str, **fields) -> Optional[Dict[str, Any]]:
        """Validate + append one record; returns it (also handed to the
        flight recorder by the Telemetry facade), or None on failure."""
        with self._lock:
            t = max(time.time(), self._last_t)
            self._last_t = t
            rec = build_record(event, self._seq, t, fields)
            if rec is None:
                return None
            self._seq += 1
            if not self._dead:
                try:
                    self._fh.write(json.dumps(rec) + "\n")
                except (OSError, ValueError):
                    # ValueError: write on a closed file (interpreter
                    # teardown / double-close races).
                    self._dead = True
                    logger.warning("event log %s failed; telemetry "
                                   "writes disabled", self.path,
                                   exc_info=True)
            return rec

    def close(self) -> None:
        with self._lock:
            self._dead = True
            try:
                self._fh.close()
            except OSError:
                pass


def read_events(path: str, strict: bool = False) -> List[Dict[str, Any]]:
    """Load an events JSONL. A torn final line (crash mid-write) is
    skipped silently; any OTHER malformed line raises only under
    `strict` (the validator tool) and is skipped with a warning
    otherwise (diagnose must work on imperfect artifacts)."""
    with open(path) as f:
        lines = [(i, ln) for i, ln in enumerate(f, start=1) if ln.strip()]
    records: List[Dict[str, Any]] = []
    for lineno, line in lines:
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            # Only UNPARSEABLE JSON on the FINAL line is mid-write
            # tearing; a parseable-but-schema-invalid last record is a
            # writer bug and must not be silently absorbed by strict.
            if lineno == lines[-1][0]:
                break  # torn tail from a crash mid-write
            if strict:
                raise ValueError(f"{path}:{lineno}: {e}") from None
            logger.warning("%s:%d: skipping unparseable line (%s)",
                           path, lineno, e)
            continue
        try:
            validate_record(rec)
        except ValueError as e:
            if strict:
                raise ValueError(f"{path}:{lineno}: {e}") from None
            logger.warning("%s:%d: skipping bad record (%s)",
                           path, lineno, e)
            continue
        records.append(rec)
    return records
