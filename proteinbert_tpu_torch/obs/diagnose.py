"""Run diagnosis from a telemetry events stream (+ optional flight dump)
— a copy of `proteinbert_tpu/obs/diagnose.py` (the port never imports
the JAX package). Both packages write one event schema, so this module
and the JAX one summarize either package's streams alike.

The analysis behind `pbt diagnose`: given the JSONL a run emitted (and,
for a dead run, its flight-recorder dump), answer the operator
questions one artifact at a time used to need four — how fast was it
going, where did it stall, how much boundary work ran hidden, and what
happened right before it died.

Pure functions over plain dicts (no jax), so this also serves as the
library API for notebooks and the test suite.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional


# One rank convention for the whole obs package: a p99 here must equal
# the registry window's p99 for the same data.
from proteinbert_tpu_torch.obs.metrics import nearest_rank as _percentile


def summarize(records: List[Dict[str, Any]],
              flight: Optional[Dict[str, Any]] = None,
              slow_top: int = 5, last: int = 10) -> Dict[str, Any]:
    """One JSON-able summary dict; every section is optional-input-safe
    (a partial stream from a dead run still summarizes).

    A requeued run appends a fresh run_start to the SAME file (that is
    the exit-75 flow); rates/wall/manifest are computed over the LAST
    incarnation only — mixing incarnations would divide step counts by
    wall time that includes the queue/restart gap and report the dead
    pid's manifest. Earlier incarnations stay visible via `counts`
    (whole file) and `incarnations`."""
    starts = [i for i, r in enumerate(records) if r["event"] == "run_start"]
    incarnations = len(starts)
    whole_file_counts = dict(
        collections.Counter(r["event"] for r in records))
    if len(starts) > 1:
        records = records[starts[-1]:]
    steps = [r for r in records if r["event"] == "step"]
    evals = [r for r in records if r["event"] == "eval"]
    ckpt = [r for r in records if r["event"] == "ckpt_stage"]
    run_start = next((r for r in records if r["event"] == "run_start"), None)
    run_end = next((r for r in reversed(records)
                    if r["event"] == "run_end"), None)

    out: Dict[str, Any] = {
        "counts": whole_file_counts,
        "incarnations": incarnations,
        "outcome": (run_end["outcome"] if run_end
                    else "unknown (no run_end record — died hard?)"),
    }
    if run_start is not None:
        out["manifest"] = {
            "jax_version": run_start.get("jax_version"),
            "pid": run_start.get("pid"),
            "mesh": run_start.get("mesh"),
            "n_chips": run_start.get("n_chips"),
            "resumed": run_start.get("resumed"),
        }

    # ------------------------------------------------------ step rate
    # Cumulative rate straight from StepTimer (run_end.perf, else the
    # last step record), PLUS an independent wall-clock estimate from
    # the stream's own stamps — a disagreement between the two is
    # itself a finding (timer discounting hiding real stall time).
    perf = dict((run_end or {}).get("perf") or {})
    if not perf and steps:
        perf = {k: v for k, v in steps[-1]["metrics"].items()
                if isinstance(v, (int, float))}
    rate: Dict[str, Any] = {"steps_per_sec": perf.get("steps_per_sec")}
    if len(steps) >= 2:
        d_steps = steps[-1]["step"] - steps[0]["step"]
        d_t = steps[-1]["t"] - steps[0]["t"]
        if d_steps > 0 and d_t > 0:
            rate["stream_steps_per_sec"] = d_steps / d_t
    windows = [(s["step"], s["metrics"]["window_steps_per_sec"])
               for s in steps
               if isinstance(s["metrics"].get("window_steps_per_sec"),
                             (int, float))]
    if windows:
        rate["window_trend"] = [(st, round(w, 4)) for st, w in windows]
        half = len(windows) // 2
        if half:
            first = sum(w for _, w in windows[:half]) / half
            second = sum(w for _, w in windows[half:]) / (len(windows) - half)
            ratio = second / first if first > 0 else 1.0
            rate["trend"] = ("degrading" if ratio < 0.9
                            else "improving" if ratio > 1.1 else "stable")
    out["step_rate"] = rate

    # ------------------------------------------------- stall top-list
    slow = sorted(
        (s for s in steps
         if isinstance(s["metrics"].get("window_step_ms"), (int, float))),
        key=lambda s: -s["metrics"]["window_step_ms"])[:slow_top]
    out["stalls"] = [{
        "step": s["step"],
        "window_step_ms": round(s["metrics"]["window_step_ms"], 2),
        "ckpt_in_flight": bool(s["metrics"].get("ckpt_in_flight")),
        "t": s["t"],
    } for s in slow]

    # -------------------------------------------- boundary overlap
    landed = [c for c in ckpt if c.get("phase") == "landed"]
    landed_overlap = sum(c.get("overlap_s") or 0.0 for c in landed)
    overlap_s = perf.get("overlap_s", landed_overlap)
    wall = None
    if run_start is not None and run_end is not None:
        wall = run_end["t"] - run_start["t"]
    elif len(records) >= 2:
        wall = records[-1]["t"] - records[0]["t"]
    out["boundary"] = {
        "ckpt_stages_landed": len(landed),
        "overlap_s": round(overlap_s, 4),
        "landed_overlap_s": round(landed_overlap, 4),
        "evals": len(evals),
        "wall_s": round(wall, 3) if wall is not None else None,
        "overlap_ratio": (round(overlap_s / wall, 6)
                          if wall and wall > 0 else None),
    }

    # ------------------------------------------- death forensics
    tail_src: List[Dict[str, Any]] = records
    if flight is not None:
        out["flight"] = {"reason": flight.get("reason"),
                         "pid": flight.get("pid"),
                         "dumped_at": flight.get("dumped_at"),
                         "events": len(flight.get("events") or [])}
        tail_src = flight.get("events") or records
    out["last_events"] = [{
        "event": r["event"], "step": r.get("step"), "t": r["t"],
        **({"phase": r["phase"]} if r["event"] == "ckpt_stage" else {}),
        **({"reason": r["reason"]} if r["event"] == "requeue" else {}),
        **({"outcome": r["outcome"]} if r["event"] == "run_end" else {}),
    } for r in tail_src[-last:]]
    return out


def summarize_serve(records: List[Dict[str, Any]],
                    slow_top: int = 5) -> Dict[str, Any]:
    """The `pbt diagnose --serve` section: request outcomes, latency
    percentiles, per-stage time attribution, and SLO breaches from the
    serve_* records of a stream. Optional-input-safe like
    summarize(): a stream with only a manifest still summarizes."""
    start = next((r for r in records if r["event"] == "serve_start"), None)
    end = next((r for r in reversed(records)
                if r["event"] == "serve_end"), None)
    reqs = [r for r in records if r["event"] == "serve_request"]
    rejects = [r for r in records if r["event"] == "serve_reject"]
    batches = [r for r in records if r["event"] == "serve_batch"]
    breaches = [r for r in records if r["event"] == "slo_breach"]

    out: Dict[str, Any] = {
        "manifest": (start.get("config") if start else None),
        "outcome": (end["outcome"] if end
                    else "unknown (no serve_end record)"),
        "requests_traced": len(reqs),
        "outcomes": dict(collections.Counter(r["outcome"] for r in reqs)),
    }

    # ---- end-to-end latency + per-stage attribution (traced reqs) ----
    e2e = sorted(r["e2e_s"] for r in reqs
                 if isinstance(r.get("e2e_s"), (int, float)))
    out["e2e"] = {
        "n": len(e2e),
        "p50_s": _percentile(e2e, 0.50),
        "p99_s": _percentile(e2e, 0.99),
        "max_s": e2e[-1] if e2e else None,
    }
    stage_sums: Dict[str, float] = collections.defaultdict(float)
    for r in reqs:
        for stage, dur in (r.get("stages") or {}).items():
            if isinstance(dur, (int, float)):
                stage_sums[stage] += dur
        # Padding waste is attribution, not a wall-clock stage: it
        # overlaps `execute`, so it is reported beside the stages.
        pf, ex = r.get("pad_fraction"), (r.get("stages") or {}).get(
            "execute")
        if isinstance(pf, (int, float)) and isinstance(ex, (int, float)):
            stage_sums["pad_wasted(of execute)"] += pf * ex
    total = sum(v for k, v in stage_sums.items() if "(" not in k)
    out["stage_attribution"] = {
        k: {"total_s": round(v, 6),
            "share": round(v / total, 4) if total else None}
        for k, v in sorted(stage_sums.items(), key=lambda kv: -kv[1])
    }

    # ---- slowest traced requests, with the stage to blame ----
    slow = sorted((r for r in reqs
                   if isinstance(r.get("e2e_s"), (int, float))),
                  key=lambda r: -r["e2e_s"])[:slow_top]
    out["slowest"] = [{
        "request_id": r.get("request_id"),
        "kind": r["kind"],
        "outcome": r["outcome"],
        "e2e_s": round(r["e2e_s"], 6),
        "dominant_stage": (max(r["stages"], key=r["stages"].get)
                           if r.get("stages") else None),
        "bucket_len": r.get("bucket_len"),
        "batch_class": r.get("batch_class"),
    } for r in slow]

    # ---- per-head attribution (multi-tenant serving) ----
    # One tenant's slow or erroring head must be attributable: group
    # the traced requests by head_id (predict_task requests carry one;
    # errors/rejections ALWAYS emit regardless of sampling, so error
    # attribution is complete even at low sample rates).
    by_head: Dict[str, List[Dict[str, Any]]] = {}
    for r in reqs:
        hid = r.get("head_id")
        if isinstance(hid, str):
            by_head.setdefault(hid, []).append(r)
    per_head: Dict[str, Any] = {}
    for hid, rs in sorted(by_head.items()):
        lat = sorted(r["e2e_s"] for r in rs
                     if isinstance(r.get("e2e_s"), (int, float)))
        outcomes = dict(collections.Counter(r["outcome"] for r in rs))
        per_head[hid] = {
            "n": len(rs),
            "outcomes": outcomes,
            "errors": sum(v for k, v in outcomes.items()
                          if k not in ("ok", "cache_hit")),
            "p50_s": _percentile(lat, 0.50),
            "p99_s": _percentile(lat, 0.99),
        }
    out["per_head"] = per_head
    head_rejects = collections.Counter(
        r["head_id"] for r in rejects
        if r.get("reason") == "unknown_head"
        and isinstance(r.get("head_id"), str))
    out["unknown_head_rejects"] = dict(head_rejects)

    # ---- rejections (with queue depth where the emitter knew it) ----
    depths = [r["queue_depth"] for r in rejects
              if isinstance(r.get("queue_depth"), int)]
    out["rejects"] = {
        "total": len(rejects),
        "by_reason": dict(collections.Counter(r["reason"]
                                              for r in rejects)),
        "queue_depth_max": max(depths) if depths else None,
        "queue_depth_mean": (round(sum(depths) / len(depths), 2)
                             if depths else None),
    }

    # ---- batches ----
    rows = [b["rows"] for b in batches]
    occ = [b["rows"] / b["batch_class"] for b in batches
           if isinstance(b.get("batch_class"), int) and b["batch_class"]]
    pads = [b["pad_fraction"] for b in batches
            if isinstance(b.get("pad_fraction"), (int, float))]
    segs = [b["segments"] for b in batches
            if isinstance(b.get("segments"), int)]
    spr = [b["segments_per_row"] for b in batches
           if isinstance(b.get("segments_per_row"), (int, float))]
    out["batches"] = {
        "n": len(batches),
        "rows": sum(rows),
        "mean_rows": round(sum(rows) / len(rows), 2) if rows else None,
        "mean_occupancy": (round(sum(occ) / len(occ), 4)
                           if occ else None),
        "mean_pad_fraction": (round(sum(pads) / len(pads), 4)
                              if pads else None),
        # Ragged packed batches: requests per batch and per
        # row — absent on a purely bucketed stream.
        "modes": dict(collections.Counter(
            b["mode"] for b in batches if isinstance(b.get("mode"), str))),
        "segments": sum(segs) if segs else None,
        "mean_segments_per_row": (round(sum(spr) / len(spr), 4)
                                  if spr else None),
    }

    # ---- executable zoo + fused-kernel path coverage ----
    # From the terminal stats snapshot: warm executable count (the
    # bucketed |buckets|x|classes|xkinds ladder vs ragged O(kinds)),
    # cumulative warmup seconds, and the two-sided fused-kernel path
    # counts — how many executables ran the Pallas fast path vs the XLA
    # reference (coverage, not just misses). `fused_fallback` only
    # appears in HISTORICAL stats snapshots (the deprecated one-sided
    # counter was removed since); it is read here so old event
    # streams still diagnose, never emitted anymore.
    end_stats = (end.get("stats") if end is not None
                 and isinstance(end.get("stats"), dict) else None)
    if end_stats is not None:
        out["executables"] = {
            "serve_mode": end_stats.get("serve_mode"),
            "count": end_stats.get("executables"),
            "warmup_seconds": end_stats.get("warmup_seconds"),
            "fused_path": end_stats.get("fused_path"),
            "attention_path": end_stats.get("attention_path"),
            "onepass_path": end_stats.get("onepass_path"),
            "fused_fallback": end_stats.get("fused_fallback"),
        }

    # ---- /v1/neighbors attribution ----
    # Neighbors requests carry a `lookup` stage between execute and
    # finalize; the stage set still tiles e2e by construction, so the
    # embed leg (submit..execute) and the lookup leg split each traced
    # request's latency exactly — no extra instrumentation needed.
    nreqs = [r for r in reqs if r.get("kind") == "neighbors"]
    nqueries = [r for r in records if r["event"] == "neighbor_query"]
    if nreqs or nqueries:
        embed_names = ("submit", "queue", "batch_form", "dispatch",
                       "execute")

        def _leg(r: Dict[str, Any]) -> float:
            return sum(v for k, v in (r.get("stages") or {}).items()
                       if k in embed_names
                       and isinstance(v, (int, float)))

        served = [r for r in nreqs
                  if isinstance((r.get("stages") or {}).get("lookup"),
                                (int, float))]
        embed_leg = sorted(_leg(r) for r in served)
        lookup_leg = sorted(r["stages"]["lookup"] for r in served)
        outcomes = collections.Counter(r["outcome"] for r in nreqs)
        n_out = sum(outcomes.values())
        lookups = [q["lookup_s"] for q in nqueries
                   if isinstance(q.get("lookup_s"), (int, float))]
        cands = [q["candidates"] for q in nqueries
                 if isinstance(q.get("candidates"), int)]
        nb: Dict[str, Any] = {
            "requests_traced": len(nreqs),
            "outcomes": dict(outcomes),
            "cache_hit_rate": (round(outcomes.get("cache_hit", 0)
                                     / n_out, 4) if n_out else None),
            "embed_leg": {"n": len(embed_leg),
                          "p50_s": _percentile(embed_leg, 0.50),
                          "p99_s": _percentile(embed_leg, 0.99)},
            "lookup_leg": {"n": len(lookup_leg),
                           "p50_s": _percentile(lookup_leg, 0.50),
                           "p99_s": _percentile(lookup_leg, 0.99)},
            "queries": len(nqueries),
            "mean_lookup_s": (round(sum(lookups) / len(lookups), 6)
                              if lookups else None),
            "mean_candidates": (round(sum(cands) / len(cands), 1)
                                if cands else None),
        }
        if end_stats is not None \
                and isinstance(end_stats.get("neighbors"), dict):
            nb["final"] = end_stats["neighbors"]
        out["neighbors"] = nb
    else:
        out["neighbors"] = None

    # ---- SLO breaches ----
    out["slo_breaches"] = [{
        "objective": b["objective"], "burn_rate": b["burn_rate"],
        "bad": b.get("bad"), "total": b.get("total"), "t": b["t"],
    } for b in breaches]
    if end is not None and isinstance(end.get("stats"), dict):
        out["final_slo"] = end["stats"].get("slo")
    return out


def _fleet_chains(records: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Group a (merged) stream's fleet_request / fleet_attempt /
    serve_request records into per-trace causal chains.

    The join key is `trace_id` — the router-minted id every record in
    one request's life carries. Replica-side serve_request records are
    matched onto attempts by `replica_id` in attempt order (the router
    never has two concurrent attempts of one trace on one replica).
    `complete` encodes the drill's reconstruction contract: sealed
    exactly once, attempts on record == retries spent + 1, and an
    ok/retried_ok chain ends in an attempt that succeeded."""
    chains: Dict[str, Dict[str, Any]] = {}

    def chain(tid: str) -> Dict[str, Any]:
        c = chains.get(tid)
        if c is None:
            c = chains[tid] = {
                "trace_id": tid, "seals": 0, "outcome": None,
                "status": None, "path": None, "retries": None,
                "replica": None, "sealed_t": None, "attempts": [],
                "_serve": []}
        return c

    for r in records:
        ev = r.get("event")
        if ev == "fleet_request":
            tid = r.get("trace_id") or r.get("request_id")
            if not isinstance(tid, str):
                continue
            c = chain(tid)
            c["seals"] += 1
            c["outcome"] = r.get("outcome")
            c["status"] = r.get("status")
            c["path"] = r.get("path")
            c["retries"] = r.get("retries")
            c["replica"] = r.get("replica")
            c["sealed_t"] = r.get("t")
        elif ev == "fleet_attempt":
            tid = r.get("trace_id")
            if not isinstance(tid, str):
                continue
            chain(tid)["attempts"].append({
                "attempt": r.get("attempt"), "replica": r.get("replica"),
                "outcome": r.get("outcome"), "status": r.get("status"),
                "backoff_s": r.get("backoff_s"), "t": r.get("t"),
                "serve": None})
        elif ev == "serve_request":
            tid = r.get("trace_id")
            if isinstance(tid, str):
                chain(tid)["_serve"].append(r)

    for c in chains.values():
        c["attempts"].sort(
            key=lambda a: (a["attempt"] is None, a["attempt"]))
        unmatched = list(c.pop("_serve"))
        for a in c["attempts"]:
            for i, s in enumerate(unmatched):
                if s.get("replica_id") == a["replica"]:
                    a["serve"] = {
                        "request_id": s.get("request_id"),
                        "outcome": s.get("outcome"),
                        "e2e_s": s.get("e2e_s"),
                        "stages": s.get("stages"),
                        "t": s.get("t"),
                    }
                    unmatched.pop(i)
                    break
        c["unmatched_serve"] = len(unmatched)
        n_att = len(c["attempts"])
        ok_chain = (c["seals"] == 1
                    and (not n_att or c["retries"] is None
                         or n_att == c["retries"] + 1))
        if ok_chain and n_att and c["outcome"] in ("ok", "retried_ok"):
            ok_chain = c["attempts"][-1]["outcome"] == "ok"
        c["complete"] = ok_chain
    return chains


def summarize_fleet(records: List[Dict[str, Any]],
                    trace_id: Optional[str] = None,
                    slow_top: int = 5) -> Dict[str, Any]:
    """The `pbt diagnose --fleet` section: per-trace causal chains
    (admission → attempts → sealed) over a MERGED fleet stream, the
    exactly-once-sealing and attempt-accounting audits, and replica
    lifecycle context. `trace_id` selects one chain for
    full rendering. Optional-input-safe like the other summarizers —
    an un-merged single-process stream still summarizes (it simply has
    no attempts to join)."""
    start = next((r for r in records if r["event"] == "fleet_start"),
                 None)
    end = next((r for r in reversed(records)
                if r["event"] == "fleet_end"), None)
    transitions = [r for r in records if r["event"] == "fleet_replica"]
    chains = _fleet_chains(records)

    seal_violations = {tid: c["seals"] for tid, c in chains.items()
                       if c["seals"] != 1}
    mismatched = [tid for tid, c in chains.items()
                  if c["attempts"] and c["retries"] is not None
                  and len(c["attempts"]) != c["retries"] + 1]
    out: Dict[str, Any] = {
        "manifest": (start.get("config") if start else None),
        "outcome": (end["outcome"] if end
                    else "unknown (no fleet_end record)"),
        "traces": len(chains),
        "outcomes": dict(collections.Counter(
            c["outcome"] for c in chains.values() if c["outcome"])),
        "attempts_recorded": sum(len(c["attempts"])
                                 for c in chains.values()),
        "retried": sum(1 for c in chains.values()
                       if (c["retries"] or 0) > 0),
        "seal_violations": seal_violations,
        "attempt_mismatches": sorted(mismatched),
        "incomplete": sorted(tid for tid, c in chains.items()
                             if not c["complete"]),
        "replica_deaths": [{
            "replica": r.get("replica"), "reason": r.get("reason"),
            "flight": r.get("flight"), "t": r.get("t"),
        } for r in transitions if r.get("state") == "dead"],
    }
    # The most-travelled chains (retries, then attempt count): the
    # requests whose causal story is worth reading first.
    ranked = sorted(chains.values(),
                    key=lambda c: (-(c["retries"] or 0),
                                   -len(c["attempts"])))
    out["most_retried"] = [{
        "trace_id": c["trace_id"], "outcome": c["outcome"],
        "retries": c["retries"], "attempts": len(c["attempts"]),
        "replica": c["replica"],
    } for c in ranked[:slow_top] if (c["retries"] or 0) > 0
        or len(c["attempts"]) > 1]
    if end is not None and isinstance(end.get("stats"), dict):
        out["final_stats"] = {
            k: end["stats"].get(k)
            for k in ("accepted", "sealed", "outcomes", "retries_spent")}
    if trace_id is not None:
        out["chain"] = chains.get(trace_id)
        if out["chain"] is None:
            out["chain_missing"] = trace_id
    return out


def export_fleet_spans(records: List[Dict[str, Any]], collector,
                       trace_id: Optional[str] = None) -> int:
    """Cross-process Perfetto lanes from a merged fleet stream: per
    trace, one ROUTER lane (admission → sealed) plus one lane per
    replica attempt, replica-side stages tiled inside the attempt span
   . Reconstructed post-hoc from event timestamps — the
    attempt's wall span is its serve-side e2e when a joined
    serve_request exists, else the instant of its attempt record.
    Returns the number of chains exported."""
    import zlib

    _MIN = 1e-7  # perfetto drops 0-duration complete events
    chains = _fleet_chains(records)
    n = 0
    for tid, c in sorted(chains.items()):
        if trace_id is not None and tid != trace_id:
            continue
        ts = [a["t"] for a in c["attempts"]
              if isinstance(a.get("t"), (int, float))]
        if isinstance(c.get("sealed_t"), (int, float)):
            ts.append(c["sealed_t"])
        # Admission approximated by the earliest observable moment:
        # the first attempt's serve-side start when joined, else the
        # first event stamp.
        first = c["attempts"][0] if c["attempts"] else None
        if first is not None and first["serve"] \
                and isinstance(first["serve"].get("t"), (int, float)) \
                and isinstance(first["serve"].get("e2e_s"),
                               (int, float)):
            ts.append(first["serve"]["t"] - first["serve"]["e2e_s"])
        if not ts:
            continue
        t0, t1 = min(ts), max(ts)
        base = zlib.crc32(tid.encode()) & 0x7FFFFFFF
        collector.add(
            f"fleet:{c['path'] or '?'}:{c['outcome'] or '?'}",
            t0, max(t1 - t0, _MIN), 0, tid=base, trace_id=tid,
            retries=c["retries"], status=c["status"])
        for i, a in enumerate(c["attempts"]):
            lane = (base + 1 + (a["attempt"] if isinstance(
                a["attempt"], int) else i)) & 0x7FFFFFFF
            s = a["serve"]
            if s and isinstance(s.get("t"), (int, float)) \
                    and isinstance(s.get("e2e_s"), (int, float)):
                a0, dur = s["t"] - s["e2e_s"], s["e2e_s"]
            elif isinstance(a.get("t"), (int, float)):
                a0, dur = a["t"], _MIN
            else:
                continue
            collector.add(
                f"attempt{a['attempt']}:{a['replica']}:{a['outcome']}",
                a0, max(dur, _MIN), 0, tid=lane, trace_id=tid,
                status=a.get("status"))
            cursor = a0
            for stage, sdur in ((s or {}).get("stages") or {}).items():
                if not isinstance(sdur, (int, float)):
                    continue
                collector.add(stage, cursor, max(sdur, _MIN), 1,
                              tid=lane, trace_id=tid)
                cursor += sdur
            if isinstance(a.get("backoff_s"), (int, float)) \
                    and a["backoff_s"] > 0 \
                    and isinstance(a.get("t"), (int, float)):
                # The wait a retry paid AFTER this failed attempt —
                # rendered on the router lane where the sleep ran.
                collector.add("backoff", a["t"],
                              max(a["backoff_s"], _MIN), 1,
                              tid=base, trace_id=tid)
        n += 1
    return n


def summarize_map(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The `pbt diagnose --map` section: per-shard progress, block
    throughput, re-work across incarnations, quarantine/retry totals
    from a stream's map_* records. Optional-input-safe like
    the other summarizers — a stream from a SIGKILLed run (no map_end)
    still summarizes, which is the whole point for this workload."""
    starts = [r for r in records if r["event"] == "map_start"]
    end = next((r for r in reversed(records)
                if r["event"] == "map_end"), None)
    blocks = [r for r in records if r["event"] == "map_block"]
    shard_evs = [r for r in records if r["event"] == "map_shard"]

    # Re-work = committed blocks emitted more than once for the same
    # (shard, block) across ALL incarnations in the file — exactly the
    # chaos drill's bounded-re-work metric (map_block only fires after
    # the cursor advance, so a crashed in-flight block never counts).
    seen = collections.Counter((b["shard"], b["block"]) for b in blocks)
    rework = sum(n - 1 for n in seen.values() if n > 1)

    per_shard: Dict[int, Dict[str, Any]] = {}
    for b in blocks:
        s = per_shard.setdefault(b["shard"], {
            "blocks": 0, "seqs": 0, "quarantined": 0, "retries": 0,
            "last_state": None, "consumed": None, "size": None})
        s["blocks"] += 1
        s["seqs"] += b["n"]
        s["quarantined"] += b.get("quarantined") or 0
        s["retries"] += b.get("retries") or 0
    for ev in shard_evs:  # stream order: the LAST transition wins
        s = per_shard.setdefault(ev["shard"], {
            "blocks": 0, "seqs": 0, "quarantined": 0, "retries": 0,
            "last_state": None, "consumed": None, "size": None})
        s["last_state"] = ev["state"]
        if isinstance(ev.get("size"), int):
            s["size"] = ev["size"]
        if isinstance(ev.get("next"), int):
            s["consumed"] = ev["next"]
    for b in blocks:  # committed coverage trumps transition snapshots
        s = per_shard[b["shard"]]
        if isinstance(b.get("end"), int):
            s["consumed"] = max(s["consumed"] or 0, b["end"])

    rates = sorted(b["seqs_per_s"] for b in blocks
                   if isinstance(b.get("seqs_per_s"), (int, float)))
    out: Dict[str, Any] = {
        "manifest": (starts[-1].get("config") if starts else None),
        "incarnations": len(starts),
        "outcome": (end["outcome"] if end
                    else "unknown (no map_end record — killed?)"),
        "blocks": len(blocks),
        "seqs": sum(b["n"] for b in blocks),
        "quarantined": sum(b.get("quarantined") or 0 for b in blocks),
        "retries": sum(b.get("retries") or 0 for b in blocks),
        "rework_blocks": rework,
        "per_shard": {str(k): v for k, v in sorted(per_shard.items())},
        "throughput": {
            "seqs_per_s_p50": _percentile(rates, 0.50),
            "seqs_per_s_last": rates and blocks[-1].get("seqs_per_s")
            or None,
        },
        "halted_shards": sorted({ev["shard"] for ev in shard_evs
                                 if ev["state"] == "halted"}),
        "failed_shards": sorted({ev["shard"] for ev in shard_evs
                                 if ev["state"] == "failed"}),
    }
    if end is not None and isinstance(end.get("stats"), dict):
        out["final_stats"] = end["stats"]
    return out


def render_map(summary: Dict[str, Any]) -> str:
    """Human-readable mapping section (`pbt diagnose --map`)."""
    lines = ["-- map --"]
    lines.append(f"outcome: {summary['outcome']} "
                 f"({summary['incarnations']} incarnation(s))")
    man = summary.get("manifest")
    if man:
        lines.append(
            f"manifest: corpus {man.get('corpus_n')} over "
            f"{man.get('num_shards')} shard(s), block "
            f"{man.get('block_size')}, rows {man.get('rows_per_batch')}"
            f"x{man.get('seq_len')}, trunk "
            f"{man.get('model_fingerprint')}")
    lines.append(
        f"committed: {summary['blocks']} block(s), {summary['seqs']} "
        f"sequence(s), {summary['quarantined']} quarantined, "
        f"{summary['retries']} retry(ies), "
        f"{summary['rework_blocks']} re-worked block(s) across "
        "incarnations")
    tp = summary["throughput"]
    if tp["seqs_per_s_p50"] is not None:
        lines.append(f"throughput: p50 {tp['seqs_per_s_p50']:.2f} "
                     f"seqs/s (last block "
                     f"{tp['seqs_per_s_last'] or 0:.2f})")
    for shard, s in summary["per_shard"].items():
        prog = ""
        if s["size"]:
            done = s["consumed"] if s["consumed"] is not None else 0
            prog = f" {done}/{s['size']}"
        lines.append(
            f"  shard {shard}: {s['blocks']} block(s), {s['seqs']} "
            f"seq(s){prog}, state {s['last_state'] or '?'}"
            + (f", {s['quarantined']} quarantined"
               if s["quarantined"] else "")
            + (f", {s['retries']} retries" if s["retries"] else ""))
    for which in ("halted_shards", "failed_shards"):
        if summary[which]:
            lines.append(f"{which.replace('_', ' ')}: "
                         f"{summary[which]} — see the flight dump / "
                         "shard events")
    return "\n".join(lines)


def render_serve(summary: Dict[str, Any]) -> str:
    """Human-readable serve section (`pbt diagnose --serve`)."""
    lines = ["-- serve --"]
    lines.append(f"outcome: {summary['outcome']}")
    man = summary.get("manifest")
    if man:
        lines.append(
            f"manifest: buckets {man.get('buckets')} classes "
            f"{man.get('batch_classes')} queue {man.get('queue_depth')} "
            f"cache {man.get('cache_size')} trace_rate "
            f"{man.get('trace_sample_rate')}")
    if summary["outcomes"]:
        lines.append("traced requests: " + ", ".join(
            f"{k}={v}" for k, v in sorted(summary["outcomes"].items())))
    e2e = summary["e2e"]
    if e2e["n"]:
        lines.append(f"e2e latency (n={e2e['n']}): "
                     f"p50 {e2e['p50_s'] * 1e3:.2f}ms "
                     f"p99 {e2e['p99_s'] * 1e3:.2f}ms "
                     f"max {e2e['max_s'] * 1e3:.2f}ms")
    attr = summary["stage_attribution"]
    if attr:
        lines.append("where the time went (all traced requests):")
        for stage, a in attr.items():
            share = (f"{100 * a['share']:5.1f}%" if a["share"] is not None
                     else "     ")
            lines.append(f"  {stage:<24} {a['total_s']:10.4f}s {share}")
    for s in summary["slowest"]:
        lines.append(
            f"  slow: {s['request_id']} {s['kind']} {s['outcome']} "
            f"{s['e2e_s'] * 1e3:.2f}ms (mostly {s['dominant_stage']}, "
            f"L={s['bucket_len']} cls={s['batch_class']})")
    per_head = summary.get("per_head") or {}
    if per_head:
        lines.append("per-head (multi-tenant predict_task traffic):")
        for hid, h in per_head.items():
            p50 = f"{h['p50_s'] * 1e3:.2f}ms" if h["p50_s"] is not None \
                else "n/a"
            p99 = f"{h['p99_s'] * 1e3:.2f}ms" if h["p99_s"] is not None \
                else "n/a"
            outc = ", ".join(f"{k}={v}"
                             for k, v in sorted(h["outcomes"].items()))
            lines.append(f"  head {hid}: n={h['n']} p50 {p50} p99 {p99} "
                         f"errors={h['errors']} ({outc})")
    for hid, n in sorted((summary.get("unknown_head_rejects")
                          or {}).items()):
        lines.append(f"  unknown-head rejects: {hid} x{n}")
    rej = summary["rejects"]
    if rej["total"]:
        lines.append(
            f"rejects: {rej['total']} " + ", ".join(
                f"{k}={v}" for k, v in sorted(rej["by_reason"].items()))
            + (f" (queue depth mean {rej['queue_depth_mean']}"
               f" max {rej['queue_depth_max']})"
               if rej["queue_depth_max"] is not None else ""))
    b = summary["batches"]
    if b["n"]:
        lines.append(f"batches: {b['n']} ({b['rows']} rows, mean "
                     f"{b['mean_rows']}/batch, occupancy "
                     f"{b['mean_occupancy']}, pad fraction "
                     f"{b['mean_pad_fraction']})")
        if b.get("segments"):
            lines.append(
                f"  packed: {b['segments']} segments, "
                f"{b['mean_segments_per_row']} per row "
                f"(modes: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(b["modes"].items()))
                + ")")
    ex = summary.get("executables")
    if ex and ex.get("count") is not None:
        lines.append(
            f"executables: {ex['count']} warm "
            f"(mode {ex.get('serve_mode')}, warmup "
            f"{ex.get('warmup_seconds')}s)")
        for stats_key, label in (("fused_path", "fused-kernel"),
                                 ("attention_path", "attention-kernel"),
                                 ("onepass_path", "one-pass-trunk")):
            cov = ex.get(stats_key) or {}
            if not cov:
                continue
            pallas = sum(n for k, n in cov.items()
                         if k.startswith("pallas/"))
            ref = sum(n for k, n in cov.items()
                      if k.startswith("reference/"))
            lines.append(
                f"  {label} coverage: {pallas} executable(s) on "
                f"the Pallas fast path, {ref} on the XLA reference")
            for key, n in sorted(cov.items()):
                lines.append(f"    {key}: {n}")
        fp = ex.get("fused_path") or {}
        if not fp:
            # Older stats snapshots: one-sided fallback view.
            fb = ex.get("fused_fallback") or {}
            for reason, n in sorted(fb.items()):
                lines.append(f"  fused-kernel fallback ({reason}): "
                             f"{n} executable(s) on the XLA reference "
                             "path")
    nb = summary.get("neighbors")
    if nb:
        outc = ", ".join(f"{k}={v}"
                         for k, v in sorted(nb["outcomes"].items()))
        hit = (f", cache hit rate {nb['cache_hit_rate']}"
               if nb["cache_hit_rate"] is not None else "")
        lines.append(f"neighbors: {nb['requests_traced']} traced "
                     f"({outc}{hit})")
        el, ll = nb["embed_leg"], nb["lookup_leg"]
        if ll["n"]:
            lines.append(
                f"  embed leg: p50 {el['p50_s'] * 1e3:.2f}ms "
                f"p99 {el['p99_s'] * 1e3:.2f}ms; lookup leg: "
                f"p50 {ll['p50_s'] * 1e3:.2f}ms "
                f"p99 {ll['p99_s'] * 1e3:.2f}ms (n={ll['n']})")
        if nb.get("mean_lookup_s") is not None:
            lines.append(
                f"  probes: {nb['queries']} sampled, mean lookup "
                f"{nb['mean_lookup_s'] * 1e3:.2f}ms over "
                f"{nb['mean_candidates']} candidate(s)")
        fin = nb.get("final")
        if fin:
            lines.append(
                f"  index: {fin.get('num_vectors')} vector(s), "
                f"nprobe {fin.get('nprobe')}, "
                f"{fin.get('lookup_executables')} warm lookup "
                f"executable(s), identity "
                f"{str(fin.get('index_digest'))[:16]}…")
    for br in summary["slo_breaches"]:
        lines.append(f"SLO BREACH: {br['objective']} burn "
                     f"{br['burn_rate']:.2f} ({br['bad']}/{br['total']} "
                     f"bad) at t={br['t']:.2f}")
    if not summary["slo_breaches"] and summary.get("final_slo"):
        lines.append("slo: no breach events; final burn rates: " + ", ".join(
            f"{k}={v.get('burn_rate')}"
            for k, v in summary["final_slo"].items()))
    return "\n".join(lines)


def _render_chain(c: Dict[str, Any]) -> List[str]:
    """One trace's causal chain, admission → attempts → sealed."""
    lines = [f"trace {c['trace_id']}: {c['path'] or '?'} "
             f"{c['outcome'] or 'UNSEALED'}"
             + ("" if c["complete"] else "  [INCOMPLETE CHAIN]")]
    lines.append(f"  admission → router (trace {c['trace_id']})")
    for a in c["attempts"]:
        status = f" status {a['status']}" if a.get("status") is not None \
            else ""
        lines.append(f"  attempt {a['attempt']}: replica "
                     f"{a['replica']} {a['outcome']}{status}")
        s = a.get("serve")
        if s:
            stages = s.get("stages") or {}
            tile = " | ".join(f"{k} {v * 1e3:.2f}ms"
                              for k, v in stages.items()
                              if isinstance(v, (int, float)))
            e2e = (f"{s['e2e_s'] * 1e3:.2f}ms"
                   if isinstance(s.get("e2e_s"), (int, float)) else "?")
            lines.append(f"    replica trace {s.get('request_id')} "
                         f"{s.get('outcome')} e2e {e2e}"
                         + (f": {tile}" if tile else ""))
        if isinstance(a.get("backoff_s"), (int, float)) \
                and a["backoff_s"] > 0:
            lines.append(f"  backoff {a['backoff_s'] * 1e3:.1f}ms")
    seal = f"  sealed: {c['outcome'] or '?'}"
    if c.get("status") is not None:
        seal += f" status {c['status']}"
    if c.get("retries") is not None:
        seal += f" after {c['retries']} retry(ies)"
    if c["seals"] != 1:
        seal += f"  [sealed {c['seals']}x — exactly-once VIOLATED]"
    lines.append(seal)
    return lines


def render_fleet(summary: Dict[str, Any]) -> str:
    """Human-readable fleet section (`pbt diagnose --fleet`)."""
    lines = ["-- fleet --"]
    lines.append(f"outcome: {summary['outcome']}")
    man = summary.get("manifest")
    if man:
        reps = man.get("replicas") or {}
        lines.append(
            f"manifest: {len(reps)} replica(s) "
            f"{sorted(reps)} max_retries {man.get('max_retries')} "
            f"budget floor {man.get('retry_budget_floor')} "
            f"ratio {man.get('retry_budget_ratio')}")
    if summary["outcomes"]:
        lines.append(
            f"traces: {summary['traces']} sealed — " + ", ".join(
                f"{k}={v}" for k, v in sorted(summary["outcomes"].items()))
            + f"; {summary['attempts_recorded']} attempt(s) recorded, "
            f"{summary['retried']} trace(s) retried")
    for tid, n in sorted(summary["seal_violations"].items()):
        lines.append(f"  SEAL VIOLATION: trace {tid} sealed {n}x "
                     "(exactly-once broken)")
    for tid in summary["attempt_mismatches"]:
        lines.append(f"  ATTEMPT MISMATCH: trace {tid} — attempts on "
                     "record != retries spent + 1")
    inc = [t for t in summary["incomplete"]
           if t not in summary["seal_violations"]
           and t not in summary["attempt_mismatches"]]
    if inc:
        lines.append(f"incomplete chains: {len(inc)} "
                     f"(e.g. {inc[:3]})")
    for d in summary["replica_deaths"]:
        flight = f", flight dump {d['flight']}" if d.get("flight") \
            else ""
        lines.append(f"replica DEATH: {d['replica']} "
                     f"({d['reason']}){flight}")
    for m in summary.get("most_retried") or []:
        lines.append(
            f"  retried: {m['trace_id']} {m['outcome']} — "
            f"{m['attempts']} attempt(s), {m['retries']} retry(ies), "
            f"final replica {m['replica']}")
    fin = summary.get("final_stats")
    if fin:
        lines.append(
            f"router: accepted {fin.get('accepted')} sealed "
            f"{fin.get('sealed')} retries_spent "
            f"{fin.get('retries_spent')}")
    chain = summary.get("chain")
    if chain:
        lines.append("")
        lines.extend(_render_chain(chain))
    elif summary.get("chain_missing"):
        lines.append(f"trace {summary['chain_missing']}: NOT FOUND in "
                     "this stream")
    return "\n".join(lines)


def render(summary: Dict[str, Any]) -> str:
    """Human-readable report (the `pbt diagnose` default output)."""
    lines = []
    lines.append(f"outcome: {summary['outcome']}")
    if summary.get("incarnations", 1) > 1:
        lines.append(f"requeued stream: {summary['incarnations']} "
                     "incarnations in this file (rates cover the last)")
    man = summary.get("manifest")
    if man:
        lines.append(
            f"manifest: jax {man.get('jax_version')} pid {man.get('pid')}"
            f" mesh {man.get('mesh')} chips {man.get('n_chips')}"
            + (" (resumed)" if man.get("resumed") else ""))
    lines.append("events: " + ", ".join(
        f"{k}={v}" for k, v in sorted(summary["counts"].items())))
    rate = summary["step_rate"]
    sps = rate.get("steps_per_sec")
    lines.append(
        "step rate: "
        + (f"{sps:.4f} steps/s (StepTimer cumulative)" if sps is not None
           else "n/a")
        + (f", {rate['stream_steps_per_sec']:.4f} steps/s (stream wall"
           f"-clock)" if "stream_steps_per_sec" in rate else "")
        + (f" — trend {rate['trend']}" if "trend" in rate else ""))
    if summary["stalls"]:
        lines.append("slowest windows (window_step_ms, ckpt_in_flight):")
        for s in summary["stalls"]:
            lines.append(f"  step {s['step']:>8}: {s['window_step_ms']:10.2f}"
                         f" ms {'[ckpt]' if s['ckpt_in_flight'] else ''}")
    b = summary["boundary"]
    ratio = b.get("overlap_ratio")
    lines.append(
        f"boundary: {b['ckpt_stages_landed']} staged saves landed, "
        f"{b['overlap_s']:.3f}s overlapped"
        + (f" ({100 * ratio:.2f}% of {b['wall_s']:.1f}s wall)"
           if ratio is not None else "")
        + f", {b['evals']} evals")
    fl = summary.get("flight")
    if fl:
        lines.append(f"flight dump: reason={fl['reason']} pid={fl['pid']} "
                     f"({fl['events']} events)")
    lines.append(f"last {len(summary['last_events'])} events before end:")
    for r in summary["last_events"]:
        extra = " ".join(f"{k}={v}" for k, v in r.items()
                         if k not in ("event", "step", "t") and v is not None)
        lines.append(f"  t={r['t']:.2f} {r['event']:<11}"
                     f" step={r.get('step')} {extra}".rstrip())
    return "\n".join(lines)
