"""IVF-flat neighbor index over the embedding store — a copy of
`proteinbert_tpu/index/store.py` (the `pbt index` builder) on the port's
`mapper`, `obs` and `parallel.quant.quantize_rows_int8`; only the imports,
docstrings and comments differ, and `_read_shard_rows`, which locates a
shard's vectors by the running count of embedded vectors where the JAX
function uses the blocks' corpus spans: a store block that quarantined
records holds fewer vectors than its span, and the JAX builder then
writes index blocks of the wrong length that its own `verify_index`
calls `shape_mismatch`, with every later row shifted. Host numpy
throughout, so on the same store without quarantined records it writes
the JAX builder's bytes exactly.

Once `mapper.run_map` has embedded a corpus into the verified
content-addressed store, answering "what is this sequence similar to?"
should cost an index probe, not a trunk
forward per corpus row. This module builds that index — and it reuses
the mapper's durability machinery WHOLESALE rather than reinventing it:

- **Same block format.** Index blocks are `mapper.store.serialize_block`
  payloads (magic + sorted-key JSON header + raw C-order arrays),
  content-addressed under `objects/` in the index directory.
- **Same cursor protocol.** Per-shard `ShardCursor` documents advanced
  only after the block they record is durably on disk
  (`commit_block`: quarantine → object tmp+fsync+rename → cursor
  prev-generation copy + atomic replace). A SIGKILL anywhere loses at
  most one block per shard; `resume_shard` re-verifies the tail.
- **Same manifest drift check.** `EmbeddingStore.ensure_manifest` on
  the index directory pins the index to the SOURCE STORE's
  `corpus_digest` and `model_fingerprint` (plus the index geometry):
  resuming — or rebuilding — against a store whose corpus or trunk
  changed is a typed `StoreConfigError` raised before any write.
- **Same fault seams.** The builder consumes `mapper.faults.MapFaults`
  specs from `PBT_INDEX_FAULTS`, so tools/index_drill.py kills it at
  the exact filesystem boundaries the map drill already exercises.

Index layout (everything deterministic — two builds of the same store
with the same knobs produce byte-identical objects, the drill's gate):

    index_dir/
      manifest.json          pinned config (see build_index)
      centroids.json         {"digest": <sha256 of the centroids block>}
      objects/<aa>/<digest>  centroids block + per-shard vector blocks
      shards/<s>/cursor.json mapper-format cursors (+ .prev, quarantine)

Vectors are the store's `global` embeddings, L2-normalized (cosine
metric). Coarse centroids come from a seeded spherical k-means over a
strided sample; each vector stores its centroid assignment plus an
int8-quantized RESIDUAL (v̂ − centroid) with per-channel symmetric
scales per block (`parallel.quant.quantize_rows_int8` — the same
amax/127 round-to-nearest convention as the int8 serving trunk). At
~1 byte/channel + one fp32 scale row per block the index holds ≤0.30×
the fp32 vector bytes while recall@10 stays ≥0.95 (gated in
the JAX bench.py --neighbors and the port's chip_smoke.py).

Stdlib + numpy at module level (the numpy-only verify contract of
mapper/store.py); the quantizer import is deferred into the build path.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from proteinbert_tpu_torch.mapper.faults import MapFaults
from proteinbert_tpu_torch.mapper.store import (
    BlockIntegrityError, EmbeddingStore, ShardCursor, StoreConfigError,
    StoreError, block_digest, commit_block, deserialize_block,
    next_offset, resume_shard, serialize_block, _atomic_write,
)
from proteinbert_tpu_torch.obs import as_telemetry

logger = logging.getLogger(__name__)

INDEX_KIND = "neighbor_index"
INDEX_FAULT_ENV = "PBT_INDEX_FAULTS"
CENTROIDS_POINTER = "centroids.json"

# Builder defaults — small enough that the chaos drill builds in
# seconds, documented in docs/neighbors.md with the sizing rule.
DEFAULT_BLOCK_SIZE = 256
DEFAULT_CENTROIDS = 64
DEFAULT_KMEANS_ITERS = 8
DEFAULT_SAMPLE_CAP = 4096

INDEX_BUILD_STATES = ("start", "completed", "preempted", "error")


class IndexBuildError(StoreError):
    """The source store cannot be indexed as-is: missing/foreign
    manifest, unfinished shards, or an empty corpus. Raised before any
    index write."""


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    return (x / np.where(norm > 0, norm, 1.0)).astype(np.float32)


def _spherical_kmeans(sample_hat: np.ndarray, k: int, iters: int,
                      seed: int) -> np.ndarray:
    """Seeded spherical k-means on L2-normalized rows. Fully
    deterministic for a given (sample, k, iters, seed): the centroids
    block's bytes are part of the drill's byte-identity gate."""
    rng = np.random.default_rng(seed)
    init = rng.permutation(len(sample_hat))[:k]
    cent = sample_hat[init].copy()
    for _ in range(max(0, iters)):
        sims = sample_hat @ cent.T                       # (n, k)
        assign = np.argmax(sims, axis=1)
        for j in range(k):
            members = sample_hat[assign == j]
            if len(members):
                v = members.mean(axis=0, dtype=np.float32)
                norm = float(np.linalg.norm(v))
                if norm > 0:
                    cent[j] = (v / norm).astype(np.float32)
            else:
                # Re-seed an empty cluster at the worst-served point —
                # deterministic (argmin breaks ties by first index).
                cent[j] = sample_hat[int(np.argmin(np.max(sims, axis=1)))]
    return np.ascontiguousarray(cent, np.float32)


def _load_store_for_index(store_dir: str):
    """Validate the source store and collect what the builder needs:
    (store, store_manifest, per-shard block entries, per-shard vector
    counts, dim). Typed refusals, no writes."""
    store = EmbeddingStore(store_dir)
    manifest = store.load_manifest()
    if manifest is None:
        raise IndexBuildError(f"{store_dir} has no manifest.json — "
                              "not an embedding store")
    if manifest.get("kind") != "embedding_store":
        raise IndexBuildError(
            f"{store_dir} manifest kind {manifest.get('kind')!r} is not "
            "'embedding_store' — refusing to index it")
    num_shards = int(manifest["num_shards"])
    shard_entries: List[List[Dict[str, Any]]] = []
    shard_vectors: List[int] = []
    for shard in range(num_shards):
        state, _source = ShardCursor(store_dir, shard).load()
        if not state["done"]:
            raise IndexBuildError(
                f"store shard {shard} is not done ({next_offset(state)} "
                f"sequences consumed) — finish `pbt map` before "
                "indexing; a partial index would silently answer from "
                "a partial corpus")
        shard_entries.append(list(state["blocks"]))
        shard_vectors.append(sum(int(e["n"]) for e in state["blocks"]))
    total = sum(shard_vectors)
    if total == 0:
        raise IndexBuildError(
            f"store {store_dir} holds zero embedded sequences — "
            "nothing to index")
    first_shard = next(s for s, n in enumerate(shard_vectors) if n)
    _meta, arrays = store.read_block(shard_entries[first_shard][0]["digest"])
    dim = int(arrays["global"].shape[1])
    return store, manifest, shard_entries, shard_vectors, dim


def _sample_vectors(store: EmbeddingStore,
                    shard_entries: List[List[Dict[str, Any]]],
                    total: int, cap: int) -> np.ndarray:
    """Strided global sample of L2-normalized vectors for the k-means
    pass — deterministic (stride from the pinned corpus size)."""
    stride = max(1, total // max(1, cap))
    rows: List[np.ndarray] = []
    pos = 0
    for entries in shard_entries:
        for entry in entries:
            n = int(entry["n"])
            take = [i for i in range(n) if (pos + i) % stride == 0]
            if take:
                _meta, arrays = store.read_block(entry["digest"])
                rows.append(np.asarray(arrays["global"],
                                       np.float32)[take])
            pos += n
    return _l2_normalize(np.concatenate(rows, axis=0))


def _ensure_centroids(index_store: EmbeddingStore, sample_hat: np.ndarray,
                      num_centroids: int, iters: int,
                      seed: int) -> Tuple[np.ndarray, str]:
    """Compute (deterministically) and persist the centroids block;
    idempotent across resumes. The pointer file is tiny JSON written
    atomically AFTER the content-addressed object, so a crash between
    the two re-converges on the next run (same bytes, same digest,
    `write_object` is idempotent). A pointer that disagrees with the
    recomputation is a typed refusal — it means the index directory
    belongs to a different build."""
    cent = _spherical_kmeans(sample_hat, num_centroids, iters, seed)
    payload = serialize_block(
        {"kind": "centroids", "num_centroids": int(cent.shape[0]),
         "dim": int(cent.shape[1]), "seed": int(seed),
         "kmeans_iters": int(iters)},
        {"centroids": cent})
    digest = block_digest(payload)
    ptr_path = os.path.join(index_store.directory, CENTROIDS_POINTER)
    if os.path.exists(ptr_path):
        with open(ptr_path) as f:
            ptr = json.load(f)
        if ptr.get("digest") != digest:
            raise StoreConfigError(
                f"index {index_store.directory} centroids pointer "
                f"{ptr.get('digest')!r} does not match the "
                f"deterministic recomputation {digest} — the index was "
                "built with different inputs; refusing to mix builds")
    index_store.write_object(payload, digest)  # idempotent / repairing
    if not os.path.exists(ptr_path):
        _atomic_write(ptr_path, json.dumps(
            {"digest": digest}, sort_keys=True, indent=1).encode())
    return cent, digest


def load_centroids(index_dir: str) -> Tuple[np.ndarray, str]:
    """(centroids fp32 (K, d), digest) from a built index —
    digest-verified via the object store read path."""
    ptr_path = os.path.join(os.path.abspath(index_dir), CENTROIDS_POINTER)
    try:
        with open(ptr_path) as f:
            ptr = json.load(f)
    except FileNotFoundError:
        raise BlockIntegrityError(
            f"{index_dir} has no {CENTROIDS_POINTER} — index was never "
            "built (or its build never reached the centroids phase)",
            reason="missing") from None
    except ValueError as e:
        raise BlockIntegrityError(
            f"{ptr_path} is unreadable ({e})", reason="malformed") \
            from None
    digest = str(ptr.get("digest", ""))
    _meta, arrays = EmbeddingStore(index_dir).read_block(digest)
    return np.asarray(arrays["centroids"], np.float32), digest


def _quantize_block(vectors: np.ndarray, centroids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(assign int32, codes int8, scales fp32) for one block of raw
    store vectors: normalize → nearest centroid by dot product →
    int8-quantize the residuals with per-channel scales."""
    # Deferred: parallel.quant imports torch and the model, and this
    # module keeps the mapper store's numpy-only verify contract.
    from proteinbert_tpu_torch.parallel.quant import quantize_rows_int8
    vhat = _l2_normalize(vectors)
    assign = np.argmax(vhat @ centroids.T, axis=1).astype(np.int32)
    resid = vhat - centroids[assign]
    codes, scales = quantize_rows_int8(resid)
    return assign, codes, scales


def build_index(store_dir: str, index_dir: str, *,
                num_centroids: int = DEFAULT_CENTROIDS,
                block_size: int = DEFAULT_BLOCK_SIZE,
                seed: int = 0,
                kmeans_iters: int = DEFAULT_KMEANS_ITERS,
                sample_cap: int = DEFAULT_SAMPLE_CAP,
                max_blocks: Optional[int] = None,
                stop_flag: Optional[Callable[[], bool]] = None,
                telemetry=None,
                faults: Optional[MapFaults] = None) -> Dict[str, Any]:
    """Build (or resume) the neighbor index for a COMPLETE embedding
    store. Kill-anywhere: every committed block survives, a crash loses
    at most one block per shard, and re-runs converge on byte-identical
    objects. Returns the stats dict of the terminal `index_build`
    event; outcome ∈ {"completed", "preempted"} (errors raise typed)."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if num_centroids < 1:
        raise ValueError(f"num_centroids must be >= 1, "
                         f"got {num_centroids}")
    ev = as_telemetry(telemetry)
    if faults is None:
        faults = MapFaults.from_env(INDEX_FAULT_ENV)
    if faults.armed():
        logger.warning("index fault injection armed via %s",
                       INDEX_FAULT_ENV)

    (store, smanifest, shard_entries, shard_vectors,
     dim) = _load_store_for_index(store_dir)
    total = sum(shard_vectors)
    num_centroids = min(int(num_centroids), total)
    num_shards = len(shard_vectors)

    index_store = EmbeddingStore(index_dir)
    # THE stale-pin refusal: corpus digest + trunk fingerprint ride the
    # manifest, so an index directory can never silently mix builds
    # against a changed corpus or a retrained trunk.
    manifest = index_store.ensure_manifest({
        "kind": INDEX_KIND,
        "corpus_digest": smanifest["corpus_digest"],
        "model_fingerprint": smanifest["model_fingerprint"],
        "corpus_n": int(smanifest["corpus_n"]),
        "num_shards": num_shards,
        "shard_vectors": [int(n) for n in shard_vectors],
        "block_size": int(block_size),
        "num_centroids": int(num_centroids),
        "dim": int(dim),
        "vector": "global",
        "metric": "cosine",
        "seed": int(seed),
        "kmeans_iters": int(kmeans_iters),
        "sample_cap": int(sample_cap),
    })

    config = {k: manifest[k] for k in sorted(manifest)}
    ev.emit("index_build", state="start", stats={}, config=config,
            pid=os.getpid())

    sample_hat = _sample_vectors(store, shard_entries, total, sample_cap)
    centroids, centroids_digest = _ensure_centroids(
        index_store, sample_hat, num_centroids, kmeans_iters, seed)

    stats = {"shards": num_shards, "vectors": 0, "blocks": 0,
             "reworked_blocks": 0, "centroids_digest": centroids_digest,
             "index_vector_bytes": 0,
             "fp32_vector_bytes": int(total) * int(dim) * 4}
    outcome = "completed"
    budget = [max_blocks]  # None = unbounded; mutated by _spend

    def _stopped() -> bool:
        return stop_flag is not None and stop_flag()

    def _spend() -> bool:
        if budget[0] is None:
            return True
        if budget[0] <= 0:
            return False
        budget[0] -= 1
        return True

    for shard in range(num_shards):
        if _stopped() or (budget[0] is not None and budget[0] <= 0):
            outcome = "preempted"
            break
        cursor = ShardCursor(index_dir, shard)
        state, info = resume_shard(index_store, shard)
        size = shard_vectors[shard]
        nxt = next_offset(state)
        reworked = (1 if info["tail_dropped"] is not None else 0) \
            + (1 if info["source"] == "prev" and nxt < size else 0)
        stats["reworked_blocks"] += reworked
        if info["source"] == "fresh":
            # Persist generation 0 before the first block so the first
            # advance has a .prev to fall back to (mirrors run_map).
            state = cursor.write_state(state)
        ev.emit("index_shard", shard=shard,
                state="start" if info["source"] == "fresh" else "resume",
                next=nxt, size=size, blocks=len(state["blocks"]),
                cursor_source=info["source"], tail_reworked=reworked)
        vec_c = ev.metrics.counter("index_vectors_total", shard=str(shard))
        while nxt < size:
            if _stopped():
                outcome = "preempted"
                break
            if not _spend():
                outcome = "preempted"
                break
            block_idx = nxt // block_size
            end = min(nxt + block_size, size)
            ids, vectors = _read_shard_rows(
                store, shard_entries[shard], nxt, end)
            assign, codes, scales = _quantize_block(vectors, centroids)
            payload = serialize_block(
                {"shard": shard, "block": block_idx, "start": nxt,
                 "end": end, "n": end - nxt,
                 "centroids": centroids_digest},
                {"ids": ids, "assign": assign, "codes": codes,
                 "scales": scales})
            entry = {"block": block_idx, "digest": block_digest(payload),
                     "start": nxt, "end": end, "n": end - nxt}
            state = commit_block(index_store, cursor, state, payload,
                                 entry,
                                 crash=faults.crash_hook(shard, block_idx))
            stats["blocks"] += 1
            stats["vectors"] += end - nxt
            stats["index_vector_bytes"] += (
                codes.nbytes + scales.nbytes + assign.nbytes)
            vec_c.inc(end - nxt)
            nxt = end
        if outcome != "completed":
            ev.emit("index_shard", shard=shard, state="preempted",
                    next=nxt, size=size, blocks=len(state["blocks"]))
            break
        if not state["done"]:
            state = cursor.write_state(dict(state, done=True))
        ev.emit("index_shard", shard=shard, state="done", next=nxt,
                size=size, blocks=len(state["blocks"]))

    fp32 = stats["fp32_vector_bytes"]
    stats["bytes_ratio"] = (stats["index_vector_bytes"] / fp32
                            if fp32 else 0.0)
    stats["outcome"] = outcome
    ev.emit("index_build", state=outcome, stats=stats, pid=os.getpid())
    return stats


def _read_shard_rows(store: EmbeddingStore,
                     entries: List[Dict[str, Any]], start: int,
                     end: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids 'S' array, global vectors fp32) for shard-local VECTOR rows
    [start, end) — spans store blocks (index block size need not match
    the store's). A store block holds `n` vectors, fewer than its corpus
    span `end - start` when it quarantined records, so the rows are
    located by the running sum of `n` (the JAX function locates them by
    the corpus span, which misaligns every block after a quarantine)."""
    ids: List[np.ndarray] = []
    vecs: List[np.ndarray] = []
    lo = 0
    for entry in entries:
        hi = lo + int(entry["n"])
        if hi > start and lo < end:
            _meta, arrays = store.read_block(entry["digest"])
            s = max(start, lo) - lo
            e = min(end, hi) - lo
            ids.append(arrays["ids"][s:e])
            vecs.append(np.asarray(arrays["global"], np.float32)[s:e])
        lo = hi
    return (np.concatenate(ids, axis=0),
            np.concatenate(vecs, axis=0))


# ----------------------------------------------------------- verification

def verify_index(index_dir: str) -> Dict[str, Any]:
    """Recompute every referenced digest and audit geometry/coverage —
    the `pbt index --verify` pass, mirroring mapper.store.verify_store:
    content problems land in the report (ok=False), only an
    uninterpretable manifest raises."""
    index_store = EmbeddingStore(index_dir)
    manifest = index_store.load_manifest()
    if manifest is None:
        raise StoreConfigError(f"{index_dir} has no manifest.json — "
                               "not a neighbor index")
    if manifest.get("kind") != INDEX_KIND:
        raise StoreConfigError(
            f"{index_dir} manifest kind {manifest.get('kind')!r} is "
            f"not {INDEX_KIND!r}")
    num_shards = int(manifest["num_shards"])
    shard_vectors = [int(n) for n in manifest["shard_vectors"]]
    dim = int(manifest["dim"])
    num_centroids = int(manifest["num_centroids"])
    holes: List[Dict[str, Any]] = []
    corrupt: List[Dict[str, Any]] = []
    coverage_errors: List[str] = []
    shards_out: List[Dict[str, Any]] = []
    blocks_checked = 0
    vectors = 0
    all_done = True

    centroids_digest = ""
    try:
        centroids, centroids_digest = load_centroids(index_dir)
        if centroids.shape != (num_centroids, dim):
            corrupt.append({"kind": "centroids",
                            "digest": centroids_digest,
                            "reason": "shape_mismatch"})
    except BlockIntegrityError as e:
        (holes if e.reason == "missing" else corrupt).append(
            {"kind": "centroids", "digest": e.digest,
             "reason": e.reason})

    for shard in range(num_shards):
        cursor = ShardCursor(index_dir, shard)
        try:
            state, source = cursor.load()
        except StoreError as e:
            coverage_errors.append(str(e))
            all_done = False
            shards_out.append({"shard": shard, "error": str(e)})
            continue
        expected_start = 0
        for entry in state["blocks"]:
            blocks_checked += 1
            if entry["start"] != expected_start:
                coverage_errors.append(
                    f"shard {shard} block {entry['block']}: starts at "
                    f"{entry['start']}, expected {expected_start} "
                    "(gap or overlap)")
            expected_start = entry["end"]
            vectors += int(entry["n"])
            try:
                meta, arrays = index_store.read_block(entry["digest"])
            except BlockIntegrityError as e:
                rec = {"shard": shard, "block": entry["block"],
                       "digest": entry["digest"], "reason": e.reason}
                (holes if e.reason == "missing" else corrupt).append(rec)
                continue
            n = int(entry["n"])
            reason = None
            if arrays["ids"].shape[0] != n \
                    or arrays["assign"].shape != (n,) \
                    or arrays["codes"].shape != (n, dim) \
                    or arrays["scales"].shape != (dim,):
                reason = "shape_mismatch"
            elif arrays["codes"].dtype != np.int8:
                reason = "dtype_mismatch"
            elif n and not (0 <= int(arrays["assign"].min())
                            and int(arrays["assign"].max())
                            < num_centroids):
                reason = "assign_out_of_range"
            elif centroids_digest \
                    and meta.get("centroids") != centroids_digest:
                reason = "centroids_mismatch"
            if reason:
                corrupt.append({"shard": shard, "block": entry["block"],
                                "digest": entry["digest"],
                                "reason": reason})
        consumed = next_offset(state)
        if state["done"] and consumed != shard_vectors[shard]:
            coverage_errors.append(
                f"shard {shard} marked done at "
                f"{consumed}/{shard_vectors[shard]} vectors")
        if not state["done"]:
            all_done = False
        shards_out.append({
            "shard": shard, "size": shard_vectors[shard],
            "consumed": consumed, "blocks": len(state["blocks"]),
            "done": state["done"], "cursor_source": source,
        })

    report = {
        "index": index_store.directory,
        "manifest": manifest,
        "centroids_digest": centroids_digest,
        "shards": shards_out,
        "blocks_checked": blocks_checked,
        "vectors": vectors,
        "holes": holes,
        "corrupt": corrupt,
        "coverage_errors": coverage_errors,
        "complete": all_done,
    }
    report["ok"] = not (holes or corrupt or coverage_errors)
    return report


def index_digests(index_dir: str) -> Dict[str, str]:
    """{"centroids": digest, "<shard>/<block>": digest} over the whole
    index — the drill's byte-identity comparison key (objects are
    content-addressed, so equal digests mean byte-identical files)."""
    index_store = EmbeddingStore(index_dir)
    manifest = index_store.load_manifest()
    if manifest is None:
        raise StoreConfigError(f"{index_dir} has no manifest.json")
    out: Dict[str, str] = {}
    ptr_path = os.path.join(index_store.directory, CENTROIDS_POINTER)
    if os.path.exists(ptr_path):
        with open(ptr_path) as f:
            out["centroids"] = str(json.load(f).get("digest", ""))
    for shard in range(int(manifest["num_shards"])):
        state, _ = ShardCursor(index_dir, shard).load()
        for entry in state["blocks"]:
            out[f"{shard}/{int(entry['block'])}"] = entry["digest"]
    return out


def index_identity(index_dir: str) -> str:
    """One digest naming the whole index CONTENT (manifest pins +
    centroids + every block digest) — the cache-scoping key: two
    servers answer `/v1/neighbors` from the same cache entry iff they
    serve the same index bytes."""
    index_store = EmbeddingStore(index_dir)
    manifest = index_store.load_manifest() or {}
    h = hashlib.sha256()
    h.update(str(manifest.get("corpus_digest", "")).encode())
    h.update(b"\x00")
    h.update(str(manifest.get("model_fingerprint", "")).encode())
    for key, digest in sorted(index_digests(index_dir).items()):
        h.update(b"\x00")
        h.update(key.encode())
        h.update(b"\x01")
        h.update(digest.encode())
    return h.hexdigest()
