"""Integrity-verified, content-addressed embedding store — a copy of
`proteinbert_tpu/mapper/store.py` (stdlib + numpy; only the docstrings
and comments differ), so each package verifies, resumes and indexes the
other's stores: the on-disk format is one.

The durable half of `pbt map`: block payloads are serialized into a
CANONICAL byte format (fixed magic + length-prefixed sorted-key JSON
header + raw C-order array bytes — no zip timestamps, so the same
inputs produce the same bytes on every run, which is what makes the
chaos drill's byte-identical-store gate possible), addressed by the
sha256 of those bytes under `objects/`, and owned by per-shard CURSORS
advanced only after the block they record is durably on disk.

Crash-safety contract (the whole point of this module):

- **Objects** are written tmp → flush → fsync → atomic rename. A crash
  mid-write leaves only a tmp file; `objects/<digest>` is either absent
  or complete.
- **Cursors** are small JSON documents carrying their own sha256
  (`sum`), written tmp → fsync → rename, with the PREVIOUS generation
  kept at `cursor.json.prev` (updated the same way) before every
  advance. A torn/corrupt main cursor therefore falls back exactly ONE
  generation — one block of re-work — and a torn prev on top of a torn
  main is the double-fault that restarts the shard (loudly).
- **Resume** re-verifies the TAIL block of each cursor (the only entry
  a crash window can leave half-true) and drops it when its object is
  missing or fails its digest — again at most one block of re-work.
- **Quarantine** sidecars are append-only JSONL with the events
  reader's torn-tail tolerance; the cursor's per-block quarantine lists
  stay authoritative (sidecar lines may duplicate across re-work and
  are deduplicated by id at read time).

`verify_store` recomputes every referenced digest and reports holes
(missing objects), corruption (digest mismatch / malformed payload),
and coverage gaps — the `pbt map --verify` pass.

Stdlib + numpy only (no jax): a store verifies on any machine that can
hold the artifacts, same contract as the obs package.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

MAGIC = b"PBTEMB1\n"
MANIFEST_VERSION = 1
CURSOR_VERSION = 1

CrashHook = Optional[Callable[[str], None]]


class StoreError(Exception):
    """Base class for typed store failures."""


class StoreConfigError(StoreError):
    """Manifest mismatch: the store on disk was written by a run with a
    different corpus/model/geometry than the resuming invocation."""


class BlockFormatError(StoreError):
    """A payload is not a well-formed canonical block."""


class BlockIntegrityError(StoreError):
    """A referenced object is missing, torn, or fails its digest.
    `reason` pinpoints which: "missing" | "digest_mismatch" |
    "malformed"."""

    def __init__(self, message: str, reason: str, digest: str = ""):
        super().__init__(message)
        self.reason = reason
        self.digest = digest


class CursorError(StoreError):
    """Both cursor generations are unreadable (double fault)."""


# ------------------------------------------------------- canonical blocks

def serialize_block(meta: Dict[str, Any],
                    arrays: Dict[str, np.ndarray]) -> bytes:
    """Canonical block bytes: MAGIC | u64 header length | header JSON
    (sorted keys, compact) | raw array bytes in header order. Arrays are
    laid down C-contiguous in sorted-name order; `meta` must be plain
    JSON-able scalars/lists."""
    entries = []
    chunks = []
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        entries.append({"name": name, "dtype": a.dtype.str,
                        "shape": list(a.shape)})
        chunks.append(a.tobytes())
    header = json.dumps({"meta": meta, "arrays": entries},
                        sort_keys=True, separators=(",", ":")).encode()
    return b"".join([MAGIC, struct.pack("<Q", len(header)), header,
                     *chunks])


def deserialize_block(data: bytes) -> Tuple[Dict[str, Any],
                                            Dict[str, np.ndarray]]:
    """Inverse of serialize_block; raises BlockFormatError on a bad
    magic, a torn tail, or trailing garbage."""
    if not data.startswith(MAGIC):
        raise BlockFormatError("bad magic: not a canonical block payload")
    off = len(MAGIC)
    if len(data) < off + 8:
        raise BlockFormatError("torn payload: truncated header length")
    (hlen,) = struct.unpack_from("<Q", data, off)
    off += 8
    if len(data) < off + hlen:
        raise BlockFormatError("torn payload: truncated header")
    try:
        header = json.loads(data[off:off + hlen])
    except ValueError as e:
        raise BlockFormatError(f"unparseable header: {e}") from None
    off += hlen
    arrays: Dict[str, np.ndarray] = {}
    for ent in header["arrays"]:
        dt = np.dtype(ent["dtype"])
        n = int(np.prod(ent["shape"], dtype=np.int64)) * dt.itemsize
        if len(data) < off + n:
            raise BlockFormatError(
                f"torn payload: array {ent['name']!r} truncated")
        arrays[ent["name"]] = np.frombuffer(
            data, dtype=dt, count=n // dt.itemsize if dt.itemsize else 0,
            offset=off).reshape(ent["shape"])
        off += n
    if off != len(data):
        raise BlockFormatError(f"{len(data) - off} trailing bytes after "
                               "the last declared array")
    return header["meta"], arrays


def block_digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


# ------------------------------------------------------- atomic file I/O

def _atomic_write(path: str, data: bytes, crash: CrashHook = None,
                  tmp_point: str = "", done_point: str = "") -> None:
    """tmp → flush → fsync → rename; `crash(point)` fires between the
    named filesystem boundaries (the drill/test kill seam)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if crash is not None and tmp_point:
        crash(tmp_point)
    os.replace(tmp, path)
    if crash is not None and done_point:
        crash(done_point)


def shard_ranges(n: int, num_shards: int) -> List[Tuple[int, int]]:
    """Deterministic contiguous split of corpus indices [0, n) into
    `num_shards` [start, end) ranges (first shards take the remainder).
    Shared by the engine and verify so they can never disagree."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    base, rem = divmod(n, num_shards)
    ranges = []
    start = 0
    for s in range(num_shards):
        size = base + (1 if s < rem else 0)
        ranges.append((start, start + size))
        start += size
    return ranges


def corpus_digest(ids, seqs) -> str:
    """Content identity of a corpus: sha256 over (id, sequence) pairs in
    order. Non-string poison entries hash by repr so a poisoned corpus
    still has a stable identity."""
    h = hashlib.sha256()
    for i, s in zip(ids, seqs):
        h.update(str(i).encode())
        h.update(b"\x00")
        h.update(s.encode() if isinstance(s, str) else repr(s).encode())
        h.update(b"\x01")
    return h.hexdigest()


# --------------------------------------------------------------- cursors

class ShardCursor:
    """One shard's crash-safe progress record (see module docstring for
    the write protocol). The cursor STATE is a plain dict the engine
    holds; this class owns the disk representation."""

    def __init__(self, store_dir: str, shard: int):
        self.shard = int(shard)
        self.directory = os.path.join(os.path.abspath(store_dir),
                                      "shards", str(self.shard))
        self.path = os.path.join(self.directory, "cursor.json")
        self.prev_path = self.path + ".prev"
        self.quarantine_path = os.path.join(self.directory,
                                            "quarantine.jsonl")

    def fresh_state(self) -> Dict[str, Any]:
        return {"v": CURSOR_VERSION, "shard": self.shard, "gen": 0,
                "blocks": [], "done": False}

    @staticmethod
    def _checksum(state: Dict[str, Any]) -> str:
        body = {k: v for k, v in state.items() if k != "sum"}
        canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()

    def _parse(self, raw: bytes) -> Dict[str, Any]:
        state = json.loads(raw)
        if not isinstance(state, dict):
            raise ValueError("cursor is not an object")
        if state.get("v") != CURSOR_VERSION:
            raise ValueError(f"cursor version {state.get('v')!r} != "
                             f"{CURSOR_VERSION}")
        if state.get("shard") != self.shard:
            raise ValueError(f"cursor shard {state.get('shard')!r} != "
                             f"{self.shard}")
        if state.get("sum") != self._checksum(state):
            raise ValueError("cursor checksum mismatch (torn or "
                             "corrupted write)")
        state.pop("sum", None)
        return state

    def load(self) -> Tuple[Dict[str, Any], str]:
        """(state, source) where source ∈ {"main", "prev", "fresh"}.
        A torn main cursor falls back one generation to `prev` (≤ one
        block of re-work); both torn raises CursorError — silently
        restarting a multi-day shard from zero is never the right
        default."""
        errors = []
        for path, source in ((self.path, "main"),
                             (self.prev_path, "prev")):
            try:
                with open(path, "rb") as f:
                    raw = f.read()
            except FileNotFoundError:
                if source == "main" and not os.path.exists(self.prev_path):
                    return self.fresh_state(), "fresh"
                errors.append(f"{path}: missing")
                continue
            try:
                state = self._parse(raw)
            except ValueError as e:
                errors.append(f"{path}: {e}")
                logger.warning("shard %d cursor %s unreadable (%s)",
                               self.shard, source, e)
                continue
            if source == "prev":
                logger.warning(
                    "shard %d: main cursor torn — resuming from the "
                    "previous generation (gen %d, %d block(s); at most "
                    "one block of re-work)", self.shard, state["gen"],
                    len(state["blocks"]))
            return state, source
        raise CursorError(
            f"shard {self.shard}: both cursor generations unreadable "
            f"({'; '.join(errors)}) — refusing to silently restart the "
            "shard; delete its shards/ directory to start it over")

    def write_state(self, state: Dict[str, Any],
                    crash: CrashHook = None) -> Dict[str, Any]:
        """Persist `state` as the next generation: serialize + checksum,
        copy the current main to `.prev`, then atomically replace main.
        Returns the state as written (gen bumped). Crash points:
        cursor_serialized / cursor_prev_updated / cursor_tmp_written /
        cursor_renamed."""
        os.makedirs(self.directory, exist_ok=True)
        state = dict(state, gen=int(state.get("gen", 0)) + 1)
        state["sum"] = self._checksum(state)
        data = json.dumps(state, sort_keys=True).encode()
        if crash is not None:
            crash("cursor_serialized")
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                _atomic_write(self.prev_path, f.read())
        if crash is not None:
            crash("cursor_prev_updated")
        _atomic_write(self.path, data, crash=crash,
                      tmp_point="cursor_tmp_written",
                      done_point="cursor_renamed")
        state.pop("sum", None)
        return state

    # ------------------------------------------------ quarantine sidecar

    def append_quarantine(self, shard_block: int,
                          records: List[Tuple[str, str]]) -> None:
        """Append (id, reason) rows; line-buffered like the event log (a
        crash tears at most the last line)."""
        if not records:
            return
        os.makedirs(self.directory, exist_ok=True)
        with open(self.quarantine_path, "a", buffering=1) as f:
            for qid, reason in records:
                f.write(json.dumps({"shard": self.shard,
                                    "block": int(shard_block),
                                    "id": str(qid),
                                    "reason": reason}) + "\n")

    def read_quarantine(self) -> List[Dict[str, Any]]:
        """Sidecar rows, deduplicated by id (re-worked blocks append
        their quarantines again), torn-tail tolerant like read_events."""
        if not os.path.exists(self.quarantine_path):
            return []
        with open(self.quarantine_path) as f:
            lines = [ln for ln in f if ln.strip()]
        out: Dict[str, Dict[str, Any]] = {}
        for i, line in enumerate(lines):
            try:
                rec = json.loads(line)
            except ValueError:
                if i == len(lines) - 1:
                    break  # torn tail from a crash mid-append
                logger.warning("%s: skipping unparseable quarantine "
                               "line %d", self.quarantine_path, i + 1)
                continue
            out[str(rec.get("id"))] = rec
        return list(out.values())


# ----------------------------------------------------------------- store

class EmbeddingStore:
    """Directory handle: manifest + content-addressed objects +
    per-shard cursors."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        self.manifest_path = os.path.join(self.directory, "manifest.json")
        self.objects_dir = os.path.join(self.directory, "objects")

    # ------------------------------------------------------- manifest

    def ensure_manifest(self, manifest: Dict[str, Any]) -> Dict[str, Any]:
        """Create the manifest atomically, or validate that an existing
        one matches — resuming against a different corpus, model, or
        geometry is a typed StoreConfigError, not silent garbage."""
        manifest = dict(manifest, v=MANIFEST_VERSION)
        existing = self.load_manifest()
        if existing is None:
            os.makedirs(self.directory, exist_ok=True)
            _atomic_write(self.manifest_path,
                          json.dumps(manifest, sort_keys=True,
                                     indent=1).encode())
            return manifest
        diffs = [k for k in sorted(set(manifest) | set(existing))
                 if manifest.get(k) != existing.get(k)]
        if diffs:
            raise StoreConfigError(
                f"store {self.directory} was written with a different "
                f"configuration — mismatched manifest field(s) "
                f"{diffs}: "
                + "; ".join(f"{k}: store={existing.get(k)!r} "
                            f"run={manifest.get(k)!r}" for k in diffs))
        return existing

    def load_manifest(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.manifest_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except ValueError as e:
            raise StoreConfigError(
                f"{self.manifest_path} is unreadable ({e})") from None

    # -------------------------------------------------------- objects

    def object_path(self, digest: str) -> str:
        return os.path.join(self.objects_dir, digest[:2], digest)

    def write_object(self, payload: bytes, digest: str) -> bool:
        """Idempotent content-addressed write; returns True when bytes
        hit disk. An existing object with MATCHING bytes is skipped; an
        existing object with WRONG bytes (a torn/corrupted survivor a
        resume is re-working) is overwritten."""
        path = self.object_path(digest)
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    if block_digest(f.read()) == digest:
                        return False
            except OSError:
                pass
            logger.warning("object %s exists but fails its digest — "
                           "rewriting", digest[:16])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write(path, payload)
        return True

    def read_object(self, digest: str) -> bytes:
        """Digest-verified read; BlockIntegrityError("missing" |
        "digest_mismatch") otherwise."""
        path = self.object_path(digest)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise BlockIntegrityError(
                f"object {digest[:16]}… is missing (hole)",
                reason="missing", digest=digest) from None
        if block_digest(data) != digest:
            raise BlockIntegrityError(
                f"object {digest[:16]}… fails its sha256 (flipped or "
                "torn bytes)", reason="digest_mismatch", digest=digest)
        return data

    def read_block(self, digest: str) -> Tuple[Dict[str, Any],
                                               Dict[str, np.ndarray]]:
        data = self.read_object(digest)
        try:
            return deserialize_block(data)
        except BlockFormatError as e:
            raise BlockIntegrityError(
                f"object {digest[:16]}…: {e}", reason="malformed",
                digest=digest) from None


# ------------------------------------------------- the commit protocol

def commit_block(store: EmbeddingStore, cursor: ShardCursor,
                 state: Dict[str, Any], payload: bytes,
                 entry: Dict[str, Any],
                 crash: CrashHook = None) -> Dict[str, Any]:
    """THE durability protocol of `pbt map`, in one place so the engine
    and the atomicity tests exercise identical code: quarantine sidecar
    append → object write (tmp+fsync+rename) → cursor advance
    (prev-generation copy, then atomic replace). The cursor is the
    commit point: a kill ANYWHERE in here loses at most this block.
    Returns the advanced cursor state."""
    digest = entry["digest"]
    cursor.append_quarantine(entry["block"],
                             entry.get("quarantined") or [])
    if crash is not None:
        crash("before_object")
    store.write_object(payload, digest)
    if crash is not None:
        crash("after_object")
    new_state = dict(state)
    new_state["blocks"] = list(state["blocks"]) + [entry]
    return cursor.write_state(new_state, crash=crash)


def resume_shard(store: EmbeddingStore,
                 shard: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a shard's cursor for resumption and re-verify its TAIL
    block (the only entry a crash window can leave half-true: a torn
    object can only be the in-flight write, and a cursor fallback only
    drops the newest entry). A bad tail is dropped — that block is
    re-worked. Returns (state, info) with info = {"source",
    "tail_dropped": entry|None}."""
    cursor = ShardCursor(store.directory, shard)
    state, source = cursor.load()
    info: Dict[str, Any] = {"source": source, "tail_dropped": None}
    if state["blocks"]:
        tail = state["blocks"][-1]
        try:
            store.read_object(tail["digest"])
        except BlockIntegrityError as e:
            logger.warning(
                "shard %d: tail block %d (%s…) failed verification on "
                "resume (%s) — re-working it", shard, tail["block"],
                tail["digest"][:16], e.reason)
            state = dict(state, blocks=state["blocks"][:-1], done=False)
            state = cursor.write_state(state)
            info["tail_dropped"] = tail
    return state, info


def next_offset(state: Dict[str, Any]) -> int:
    """Shard-local index the next block starts at (blocks are
    contiguous by construction)."""
    return int(state["blocks"][-1]["end"]) if state["blocks"] else 0


# ----------------------------------------------------------- verification

def verify_store(store_dir: str) -> Dict[str, Any]:
    """Recompute every referenced digest and audit coverage — the
    `pbt map --verify` pass. Never raises for content problems (they
    land in the report, ok=False); a missing/corrupt manifest raises
    StoreConfigError because nothing else is interpretable without it."""
    store = EmbeddingStore(store_dir)
    manifest = store.load_manifest()
    if manifest is None:
        raise StoreConfigError(f"{store_dir} has no manifest.json — "
                               "not an embedding store")
    n = int(manifest["corpus_n"])
    num_shards = int(manifest["num_shards"])
    ranges = shard_ranges(n, num_shards)
    holes: List[Dict[str, Any]] = []
    corrupt: List[Dict[str, Any]] = []
    coverage_errors: List[str] = []
    shards_out: List[Dict[str, Any]] = []
    blocks_checked = 0
    seqs = 0
    quarantined_ids: set = set()
    all_done = True
    for shard, (lo, hi) in enumerate(ranges):
        cursor = ShardCursor(store_dir, shard)
        try:
            state, source = cursor.load()
        except CursorError as e:
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
            for qid, _reason in entry.get("quarantined") or []:
                quarantined_ids.add(str(qid))
            seqs += int(entry["n"])
            try:
                meta, arrays = store.read_block(entry["digest"])
            except BlockIntegrityError as e:
                rec = {"shard": shard, "block": entry["block"],
                       "digest": entry["digest"], "reason": e.reason}
                (holes if e.reason == "missing" else corrupt).append(rec)
                continue
            if int(arrays["ids"].shape[0]) != int(entry["n"]):
                corrupt.append({"shard": shard, "block": entry["block"],
                                "digest": entry["digest"],
                                "reason": "row_count_mismatch"})
        consumed = next_offset(state)
        if state["done"] and consumed != hi - lo:
            coverage_errors.append(
                f"shard {shard} marked done at {consumed}/{hi - lo} "
                "sequences")
        if not state["done"]:
            all_done = False
        shards_out.append({
            "shard": shard, "size": hi - lo, "consumed": consumed,
            "blocks": len(state["blocks"]), "done": state["done"],
            "cursor_source": source,
        })
    embedded = seqs  # rows in blocks exclude quarantined by contract
    report = {
        "store": store.directory,
        "manifest": manifest,
        "shards": shards_out,
        "blocks_checked": blocks_checked,
        "embedded": embedded,
        "quarantined": len(quarantined_ids),
        "holes": holes,
        "corrupt": corrupt,
        "coverage_errors": coverage_errors,
        "complete": all_done,
    }
    report["ok"] = not (holes or corrupt or coverage_errors)
    return report


def store_digests(store_dir: str) -> Dict[Tuple[int, int], str]:
    """{(shard, block): digest} over every cursor — the drill's
    byte-identity comparison key."""
    store = EmbeddingStore(store_dir)
    manifest = store.load_manifest()
    if manifest is None:
        raise StoreConfigError(f"{store_dir} has no manifest.json")
    out: Dict[Tuple[int, int], str] = {}
    for shard in range(int(manifest["num_shards"])):
        state, _ = ShardCursor(store_dir, shard).load()
        for entry in state["blocks"]:
            out[(shard, int(entry["block"]))] = entry["digest"]
    return out


def iter_embeddings(store_dir: str):
    """Yield (id, lengths-aware record dict) per embedded sequence, in
    corpus order per shard — the minimal read API for downstream
    consumers (the ROADMAP-4 neighbor index builds on it)."""
    store = EmbeddingStore(store_dir)
    manifest = store.load_manifest()
    if manifest is None:
        raise StoreConfigError(f"{store_dir} has no manifest.json")
    for shard in range(int(manifest["num_shards"])):
        state, _ = ShardCursor(store_dir, shard).load()
        for entry in state["blocks"]:
            _meta, arrays = store.read_block(entry["digest"])
            for i in range(arrays["ids"].shape[0]):
                yield (arrays["ids"][i].decode(), {
                    "length": int(arrays["lengths"][i]),
                    "global": arrays["global"][i],
                    "local_mean": arrays["local_mean"][i],
                })
