"""Resumable sharded batch inference — port of
`proteinbert_tpu/mapper/engine.py` (`poison_reason`, `run_map`).

Streams a corpus of sequences through the ragged packed trunk (the
serving representation: heterogeneous sequences first-fit-packed into
fixed-shape (rows_per_batch, seq_len) rows, #3 + K2 per block on the
card at base width) and writes a content-addressed embedding store
(mapper/store.py, the JAX on-disk format). The run is a set of
DETERMINISTIC input shards (contiguous corpus ranges); each shard
advances block by block, and a block only enters the shard's cursor after
its payload is durably on disk — so SIGKILL at any point resumes with at
most one in-flight block of re-work per shard and never drops or
duplicates a sequence.

Failure containment, as in the JAX engine:

- **Transient dispatch errors** (TransientDispatchError) retry with
  capped exponential backoff under a retry budget (floor + ratio ×
  blocks); exhaustion fails the SHARD (typed), not the run.
- **Poisoned inputs** (non-string / empty / control characters) are
  quarantined to a per-shard sidecar with a typed reason and recorded
  in the block's cursor entry; the block proceeds without them.
- **Non-finite embeddings** halt the shard with a flight-recorder
  dump — numerical corruption must never be silently served.
- **SIGTERM/SIGINT** finish the in-flight block, flush the cursor, and
  return outcome "preempted" (or `stop_flag` for in-process callers).

The manifest pins the trunk by `heads/registry.trunk_fingerprint` in the
JAX tree's layout, so a store written by the port and one written by the
JAX package from the same weights carry the same fingerprint, and each
package's `verify_store` and `build_index` read the other's stores.

One stream, one block in flight (`pipeline=True`). A block is submitted
as its packed batches' eager trunk calls on the current stream; right
after each batch's last kernel its outputs start their copy into pinned
host buffers (`non_blocking`), and after the block's last batch an event
is recorded. `fetch()` waits on that event, not on the stream, so block
N's fetch and commit run while block N+1's kernels (enqueued before the
fetch) compute. On the CPU the outputs are host tensors already.

Observability: the JAX schema's map_start / map_shard / map_block /
map_end events and the same gauges and counters, so the JAX
`pbt diagnose --map` reads the stream.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.mapper.faults import MapFaults, TransientDispatchError
from proteinbert_tpu_torch.mapper.store import (
    EmbeddingStore, ShardCursor, block_digest, commit_block,
    corpus_digest, next_offset, resume_shard, serialize_block,
    shard_ranges,
)
from proteinbert_tpu_torch.obs import as_telemetry

logger = logging.getLogger(__name__)

POISON_REASONS = ("non_string", "empty", "invalid_char")


def poison_reason(seq: Any) -> Optional[str]:
    """Typed quarantine classification for one corpus record. Sequences
    merely longer than the model window are NOT poison — they truncate
    and count, same as every other inference surface."""
    if not isinstance(seq, str):
        return "non_string"
    if not seq:
        return "empty"
    if any(not (33 <= ord(c) <= 126) for c in seq):
        return "invalid_char"
    return None


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """`a` on `device`; onto the card through pinned staging, so the copy
    does not wait for the stream's earlier kernels (a pageable copy
    does)."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start `t`'s copy into a pinned host buffer on the current stream
    (CUDA), or return it as it is (CPU)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _embed_block_submit(params, cfg, ids: Sequence[str],
                        seqs: Sequence[str], rows_per_batch: int,
                        max_segments: int, buckets: Sequence[int],
                        device: torch.device):
    """Submit one block through the ragged packed trunk and return (a
    `fetch()` closure for its host-side materialization, the number of
    packed batches it ran).

    First-fit-packs the block's sequences into (rows_per_batch, seq_len)
    rows and runs `inference._packed_encode_batch` per fixed-shape batch,
    each batch's outputs copied into pinned host buffers right behind its
    kernels; one event marks the block's last copy. `fetch()` waits for
    that event and scatters the per-segment outputs back to corpus order.

    Spans follow the ragged SERVING rule (serve/dispatch.
    RaggedDispatcher): each sequence occupies its bucket-quantized span
    with segment_ids covering the WHOLE span, so the store's numbers
    match the served and offline surfaces. Deterministic in its inputs —
    the property the byte-identical-store contract rides on."""
    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.data.packing import OnlinePacker
    from proteinbert_tpu_torch.data.vocab import PAD_ID

    seq_len = cfg.data.seq_len
    buckets = np.asarray(buckets)
    tokens = inference._tokenize_masked(list(seqs), seq_len,
                                        on_overflow="count")
    lengths = (tokens != PAD_ID).sum(axis=1).astype(np.int32)
    spans = buckets[np.searchsorted(buckets, lengths)]
    packer = OnlinePacker(seq_len, max_segments)
    for i, span in enumerate(spans):
        packer.place(i, int(span))
    rows = packer.pop_rows(len(packer))

    n = len(seqs)
    A = cfg.model.num_annotations
    pending = []
    for chunk_start in range(0, len(rows), rows_per_batch):
        chunk = rows[chunk_start:chunk_start + rows_per_batch]
        tok = np.zeros((rows_per_batch, seq_len), np.int32)
        seg = np.zeros((rows_per_batch, seq_len), np.int32)
        for r, row in enumerate(chunk):
            for s, (pos, start, span) in enumerate(row):
                tok[r, start:start + span] = tokens[pos, :span]
                seg[r, start:start + span] = s + 1
        tok_d, seg_d = (_to_device(a, device) for a in (tok, seg))
        ann = torch.zeros((rows_per_batch, max_segments, A),
                          dtype=torch.float32, device=device)
        res = inference._packed_encode_batch(params, tok_d, seg_d, ann,
                                             cfg.model)
        pending.append((chunk, {k: _to_host(v) for k, v in res.items()}))
    done = None
    if device.type == "cuda" and pending:
        done = torch.cuda.Event()
        done.record()

    def fetch() -> Dict[str, Any]:
        if done is not None:
            done.synchronize()
        out_global = out_local = None
        for chunk, res in pending:
            g = res["global"].numpy()
            lm = res["local_mean"].numpy()
            if out_global is None:
                out_global = np.zeros((n, g.shape[-1]), np.float32)
                out_local = np.zeros((n, lm.shape[-1]), np.float32)
            for r, row in enumerate(chunk):
                for s, (pos, _start, _span) in enumerate(row):
                    out_global[pos] = g[r, s]
                    out_local[pos] = lm[r, s]
        if out_global is None:  # every record was quarantined
            out_global = np.zeros((0, 1), np.float32)
            out_local = np.zeros((0, 1), np.float32)
        # Explicit UTF-8: np.array(dtype="S") on str raises for non-ASCII
        # ids, and an id must never be able to kill a run — bytes
        # round-trip losslessly through iter_embeddings' .decode().
        return {"ids": np.array([str(i).encode("utf-8") for i in ids]),
                "lengths": lengths, "global": out_global,
                "local_mean": out_local}

    return fetch, len(pending)


def run_map(
    params, cfg, ids: Sequence[str], seqs: Sequence[str], store_dir: str,
    *,
    num_shards: int = 1,
    block_size: int = 64,
    rows_per_batch: int = 8,
    max_segments: int = 8,
    buckets: Optional[Sequence[int]] = None,
    telemetry=None,
    faults: Optional[MapFaults] = None,
    retry_limit: int = 3,
    retry_budget_floor: int = 4,
    retry_budget_ratio: float = 0.25,
    backoff_base_s: float = 0.05,
    backoff_cap_s: float = 2.0,
    max_blocks: Optional[int] = None,
    stop_flag=None,
    pipeline: bool = True,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Map the corpus into `store_dir` on `device` (None → "cuda"; the
    params must live there); resumes automatically from the shard cursors
    it finds there. Returns a stats dict whose "outcome" is one of
    obs.events.MAP_OUTCOMES ("completed" | "preempted" | "halted" |
    "error"), the JAX engine's keys plus "batches" (packed batches run
    this invocation, retries excluded). `max_blocks` bounds the blocks
    processed THIS invocation (outcome "preempted" when work remains).
    `stop_flag` (callable → bool) replaces the default SIGTERM/SIGINT
    GracefulShutdown for in-process callers.

    `pipeline` keeps ONE block in flight: block N+1's compute is
    submitted before block N's host fetch + `commit_block` (object write,
    fsync, cursor advance), so the card stays fed through the durability
    I/O. Commit ORDER is strictly preserved — the cursor never advances
    past an unfetched block, so the crash-window taxonomy and the
    byte-identical-resume contract hold; `block_fetched` is the
    device-complete-but-uncommitted crash point. False runs compute →
    fetch → commit per block."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if rows_per_batch < 1:
        raise ValueError(f"rows_per_batch must be >= 1, got "
                         f"{rows_per_batch}")
    if len(ids) != len(seqs):
        raise ValueError(f"{len(ids)} ids != {len(seqs)} sequences")
    if not seqs:
        raise ValueError("no sequences given")
    device = resolve_device(device)
    from proteinbert_tpu_torch.heads.registry import trunk_fingerprint
    from proteinbert_tpu_torch.serve.dispatch import resolve_buckets

    # The span-quantization ladder (serving semantics: cfg.data.buckets
    # unless overridden, else the single full-length bucket). It shapes
    # the packed rows and therefore the store BYTES, so it is pinned in
    # the manifest — a resume with a different ladder is a typed error,
    # not a silently mixed store.
    buckets = resolve_buckets(cfg, buckets)
    tele = as_telemetry(telemetry)
    if faults is None:
        faults = MapFaults.from_env()
    if faults.armed():
        logger.warning("FAULT INJECTION ACTIVE: map faults armed "
                       "(PBT_MAP_FAULTS)")
    store = EmbeddingStore(store_dir)
    fingerprint = trunk_fingerprint(params, cfg.model.scan_blocks)
    manifest = store.ensure_manifest({
        "kind": "embedding_store",
        "corpus_n": len(seqs),
        "corpus_digest": corpus_digest(ids, seqs),
        "model_fingerprint": fingerprint,
        "num_shards": int(num_shards),
        "block_size": int(block_size),
        "rows_per_batch": int(rows_per_batch),
        "max_segments": int(max_segments),
        "seq_len": int(cfg.data.seq_len),
        "buckets": [int(b) for b in buckets],
    })
    ranges = shard_ranges(len(seqs), num_shards)

    config_rec = {k: manifest[k] for k in
                  ("corpus_n", "num_shards", "block_size",
                   "rows_per_batch", "max_segments", "seq_len",
                   "buckets")}
    config_rec["store"] = store.directory
    config_rec["model_fingerprint"] = fingerprint[:16]
    tele.emit("map_start", config=config_rec, pid=os.getpid())

    # Per-shard runtime state.
    shards: List[Dict[str, Any]] = []
    for shard, (lo, hi) in enumerate(ranges):
        state, info = resume_shard(store, shard)
        cursor = ShardCursor(store_dir, shard)
        nxt = next_offset(state)
        # Re-work this resume will incur: a dropped tail object is one
        # block; a torn-main-cursor fallback to `.prev` is one more IF the
        # lost generation recorded an advance (nxt < size — when it only
        # recorded the done-marker, nothing recomputes).
        rework = int(info["tail_dropped"] is not None)
        if info["source"] == "prev" and not state["done"] \
                and nxt < hi - lo:
            rework += 1
        st = {"shard": shard, "lo": lo, "hi": hi, "state": state,
              "cursor": cursor, "next": nxt, "halted": False,
              "failed": False, "tail_dropped": info["tail_dropped"],
              "rework": rework,
              # Optimistic submit-side counters: where the NEXT submit
              # starts, ahead of the committed `next` / `state["blocks"]`
              # by at most the one in-flight block. Only the thread
              # running run_map touches them.
              "pending_next": nxt,
              "pending_blocks": len(state["blocks"])}
        shards.append(st)
        is_resume = info["source"] != "fresh" or nxt > 0
        if state["done"]:
            continue
        if not is_resume:
            # Persist the empty generation so the very first advance
            # already has a `.prev` to fall back to.
            st["state"] = cursor.write_state(state)
        tele.emit("map_shard", shard=shard,
                  state="resume" if is_resume else "start",
                  next=nxt, size=hi - lo,
                  blocks=len(state["blocks"]),
                  cursor_source=info["source"],
                  tail_reworked=bool(info["tail_dropped"]))
        if st["rework"]:
            tele.metrics.counter("map_rework_blocks_total").inc(
                st["rework"])
        if nxt >= hi - lo:
            # Fully consumed but the done marker was lost: re-mark, never
            # append a degenerate empty block.
            st["state"] = cursor.write_state(dict(st["state"], done=True))
            tele.emit("map_shard", shard=shard, state="done",
                      blocks=len(st["state"]["blocks"]))

    total_blocks = sum(
        (hi - lo + block_size - 1) // block_size for lo, hi in ranges)
    budget = [max(retry_budget_floor,
                  int(retry_budget_ratio * total_blocks))]
    stats = {"blocks": 0, "seqs": 0, "quarantined": 0, "retries": 0,
             "rework": sum(s["rework"] for s in shards),
             "commit_s": 0.0, "overlap_s": 0.0, "batches": 0}
    t_run0 = time.perf_counter()

    def submit_block(st: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Submit one block's compute and return its in-flight record, or
        None when the shard failed at submit (retries exhausted).
        Advances the shard's OPTIMISTIC counters only — `next`/`state`
        move at commit, never here, so the cursor can never get ahead of
        durable bytes."""
        shard = st["shard"]
        block_idx = st["pending_blocks"]
        start = st["pending_next"]
        end = min(start + block_size, st["hi"] - st["lo"])
        block_ids = [str(i) for i in ids[st["lo"] + start:st["lo"] + end]]
        block_seqs = list(seqs[st["lo"] + start:st["lo"] + end])

        quarantined: List[Tuple[str, str]] = []
        kept_ids: List[str] = []
        kept_seqs: List[str] = []
        for qid, seq in zip(block_ids, block_seqs):
            reason = poison_reason(seq)
            if reason is None:
                kept_ids.append(qid)
                kept_seqs.append(seq)
            else:
                quarantined.append((qid, reason))
                tele.metrics.counter("map_quarantined_total",
                                     reason=reason).inc()

        faults.block_latency()
        attempts = 0
        t0 = time.perf_counter()
        while True:
            try:
                if faults.take_failure(shard, block_idx):
                    raise TransientDispatchError(
                        f"injected dispatch failure (shard {shard} "
                        f"block {block_idx})")
                if kept_seqs:
                    fetch, batches = _embed_block_submit(
                        params, cfg, kept_ids, kept_seqs,
                        rows_per_batch, max_segments, buckets, device)
                    stats["batches"] += batches
                else:
                    def fetch() -> Dict[str, Any]:
                        return {
                            "ids": np.array([], dtype="S1"),
                            "lengths": np.zeros(0, np.int32),
                            "global": np.zeros((0, 1), np.float32),
                            "local_mean": np.zeros((0, 1), np.float32)}
                break
            except TransientDispatchError as e:
                stats["retries"] += 1
                tele.metrics.counter("map_retries_total").inc()
                attempts += 1
                budget[0] -= 1
                if attempts > retry_limit or budget[0] < 0:
                    st["failed"] = True
                    tele.emit("map_shard", shard=shard, state="failed",
                              reason=f"retries exhausted: {e}",
                              blocks=len(st["state"]["blocks"]))
                    logger.error("shard %d block %d: retries exhausted "
                                 "(%d attempts, budget %d): %s", shard,
                                 block_idx, attempts, budget[0], e)
                    return None
                delay = min(backoff_cap_s,
                            backoff_base_s * (2 ** (attempts - 1)))
                logger.warning("shard %d block %d: transient dispatch "
                               "failure (attempt %d/%d, retry in "
                               "%.3fs): %s", shard, block_idx, attempts,
                               retry_limit, delay, e)
                time.sleep(delay)

        st["pending_blocks"] = block_idx + 1
        st["pending_next"] = end
        return {"st": st, "shard": shard, "block": block_idx,
                "start": start, "end": end, "kept_ids": kept_ids,
                "quarantined": quarantined, "attempts": attempts,
                "t0": t0, "fetch": fetch}

    def commit_inflight(rec: Dict[str, Any], overlapped: bool) -> None:
        """Resolve one in-flight block: wait for its host copies, NaN
        gate, then the durable commit (object write → fsync → cursor
        advance) — the SAME ordered sequence as the serial path, so every
        crash window keeps its taxonomy. `overlapped` marks whether a
        later block's compute was already enqueued when this ran (the
        pipelining evidence `map_overlap_ratio` reports)."""
        st = rec["st"]
        shard = rec["shard"]
        block_idx = rec["block"]
        if st["halted"]:
            # The predecessor block NaN-halted this shard at ITS commit —
            # committing this one would advance the cursor over a hole.
            logger.warning("shard %d block %d: discarding in-flight "
                           "block after shard halt", shard, block_idx)
            return
        tf0 = time.perf_counter()
        arrays = rec["fetch"]()
        start, end = rec["start"], rec["end"]
        kept_ids, quarantined = rec["kept_ids"], rec["quarantined"]
        attempts = rec["attempts"]
        t0 = rec["t0"]

        if faults.poison_output(shard, block_idx) \
                and arrays["global"].size:
            arrays = dict(arrays)
            arrays["global"] = arrays["global"].copy()
            arrays["global"][0, 0] = np.nan
        if not (np.isfinite(arrays["global"]).all()
                and np.isfinite(arrays["local_mean"]).all()):
            st["halted"] = True
            dump = tele.dump_flight("map_nan_halt") \
                if tele.enabled else None
            tele.emit("map_shard", shard=shard, state="halted",
                      reason="non_finite_embeddings",
                      block=block_idx, flight=dump)
            logger.error(
                "shard %d HALTED: block %d produced non-finite "
                "embeddings%s — the block was NOT committed", shard,
                block_idx,
                f" (flight dump: {dump})" if dump else "")
            return

        meta = {"shard": shard, "block": block_idx,
                "start": start, "end": end,
                "model_fingerprint": fingerprint}
        payload = serialize_block(meta, arrays)
        digest = block_digest(payload)
        entry = {"block": block_idx, "digest": digest, "start": start,
                 "end": end, "n": len(kept_ids),
                 "quarantined": [[q, r] for q, r in quarantined]}
        hook = faults.crash_hook(shard, block_idx)
        if hook is not None:
            # Device results are on the host but NOTHING is durable yet —
            # a kill here costs exactly one block of re-work.
            hook("block_fetched")
        st["state"] = commit_block(store, st["cursor"], st["state"],
                                   payload, entry, crash=hook)
        st["next"] = end
        dur = time.perf_counter() - t0
        commit_s = time.perf_counter() - tf0
        stats["commit_s"] += commit_s
        if overlapped:
            stats["overlap_s"] += commit_s
        if stats["commit_s"] > 0:
            tele.metrics.gauge("map_overlap_ratio").set(
                round(stats["overlap_s"] / stats["commit_s"], 4))
        rate = len(kept_ids) / dur if dur > 0 else 0.0
        stats["blocks"] += 1
        stats["seqs"] += len(kept_ids)
        stats["quarantined"] += len(quarantined)
        tele.metrics.counter("map_blocks_total", shard=shard).inc()
        tele.metrics.counter("map_seqs_total").inc(len(kept_ids))
        tele.metrics.gauge("map_seqs_per_s").set(round(rate, 3))
        size = max(1, st["hi"] - st["lo"])
        tele.metrics.gauge("map_shard_progress", shard=shard).set(
            round(end / size, 4))
        tele.emit("map_block", shard=shard, block=block_idx,
                  digest=digest, n=len(kept_ids), start=start, end=end,
                  quarantined=len(quarantined), retries=attempts,
                  seqs_per_s=round(rate, 3), dur_s=round(dur, 6))
        if st["next"] >= st["hi"] - st["lo"]:
            st["state"] = st["cursor"].write_state(
                dict(st["state"], done=True))
            tele.emit("map_shard", shard=shard, state="done",
                      blocks=len(st["state"]["blocks"]))

    # ---------------------------------------------------- the run loop
    # Round-robin over shards so progress (and therefore the worst-case
    # re-work after a kill) stays balanced.
    #
    # Pipelined: ONE global in-flight slot. Each iteration submits block
    # N+1's compute FIRST, then resolves + commits block N. Commits happen
    # in exact submit order, so the per-shard cursor invariant — never
    # past an unfetched block — holds by construction. A stop/preempt
    # COMMITS the in-flight block before returning.
    def runnable(st):
        return not (st["state"]["done"] or st["halted"] or st["failed"])

    def submittable(st):
        return runnable(st) and st["pending_next"] < st["hi"] - st["lo"]

    preempted = False
    inflight: List[Optional[Dict[str, Any]]] = [None]

    def drain_inflight() -> None:
        rec, inflight[0] = inflight[0], None
        if rec is not None:
            commit_inflight(rec, overlapped=False)

    def drive(stop_requested) -> None:
        nonlocal preempted
        processed = 0
        while any(submittable(s) for s in shards):
            advanced = False
            for st in shards:
                if not submittable(st):
                    continue
                if stop_requested():
                    preempted = True
                    drain_inflight()
                    return
                if max_blocks is not None and processed >= max_blocks:
                    preempted = True
                    drain_inflight()
                    return
                rec = submit_block(st)
                processed += 1
                advanced = True
                if rec is None:
                    continue  # shard failed at submit; nothing enqueued
                if not pipeline:
                    commit_inflight(rec, overlapped=False)
                    continue
                prev, inflight[0] = inflight[0], rec
                if prev is not None:
                    commit_inflight(prev, overlapped=True)
            if not advanced:
                break
        drain_inflight()

    if stop_flag is not None:
        drive(stop_flag)
    else:
        from proteinbert_tpu_torch.train.resilience import GracefulShutdown

        with GracefulShutdown() as stop:
            drive(lambda: stop.requested)

    halted = [s["shard"] for s in shards if s["halted"]]
    failed = [s["shard"] for s in shards if s["failed"]]
    if halted:
        outcome = "halted"
    elif failed:
        outcome = "error"
    elif preempted or any(runnable(s) for s in shards):
        outcome = "preempted"
    else:
        outcome = "completed"
    wall = time.perf_counter() - t_run0
    result = {
        "outcome": outcome,
        "store": store.directory,
        "blocks": stats["blocks"],
        "seqs": stats["seqs"],
        "quarantined": stats["quarantined"],
        "retries": stats["retries"],
        "rework": stats["rework"],
        "halted_shards": halted,
        "failed_shards": failed,
        "wall_s": round(wall, 3),
        "seqs_per_s": round(stats["seqs"] / wall, 3) if wall > 0 else 0.0,
        # The share of host fetch+commit seconds spent while a later
        # block's compute was already enqueued; wall_s is the speed
        # number.
        "pipeline": bool(pipeline),
        "overlap_ratio": (round(stats["overlap_s"] / stats["commit_s"],
                                4)
                          if stats["commit_s"] > 0 else 0.0),
        "commit_s": round(stats["commit_s"], 6),
        "overlap_s": round(stats["overlap_s"], 6),
        "batches": stats["batches"],
        "shards": [{
            "shard": s["shard"],
            "blocks": len(s["state"]["blocks"]),
            "consumed": s["next"],
            "size": s["hi"] - s["lo"],
            "done": s["state"]["done"],
        } for s in shards],
    }
    tele.emit("map_end", outcome=outcome,
              stats={k: v for k, v in result.items() if k != "shards"})
    return result
