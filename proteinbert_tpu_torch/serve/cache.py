"""Content-addressed LRU result cache for the serving layer — a copy of
`proteinbert_tpu/serve/cache.py`.

Keys are sha256 digests over (kind, sequence, annotations bytes) —
content addressing, so two textually identical queries hit the same
entry no matter which client sent them, and an annotation vector that
differs by one bit misses. A task head's requests key under the scope
"predict_task:<head_id>" (the Server builds it); a head id addresses the
head's weights, task and trunk, so a cached answer is that head's.
Values are whatever the finalizer produced for that request kind (an
embed dict, a GO probability row, a filled sequence + residue probs, a
head's outputs) — small host numpy arrays, held strongly.

Hit/miss/eviction counts feed both local stats() and, when a metrics
registry is supplied, the `serve_cache_{hits,misses,evictions}_total`
counters plus the `serve_cache_hit_rate` gauge.

Thread-safe: submit paths race against scheduler-thread inserts.
capacity == 0 disables the cache (every get misses, puts are dropped) —
the contract bench.py --serve uses for its no-cache comparison.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Any, Dict, Optional

import numpy as np


def content_key(kind: str, seq: str, annotations=None) -> str:
    """sha256 content address of one query.

    The kind participates (an `embed` and a `predict_go` of the same
    sequence are different results); annotations participate by shape +
    raw float32 bytes so "no annotations" (None / all-zero is NOT
    collapsed: None means the model's trained hide-all input, an
    explicit vector is data)."""
    h = hashlib.sha256()
    h.update(kind.encode())
    h.update(b"\x00")
    h.update(seq.encode())
    if annotations is not None:
        a = np.ascontiguousarray(annotations, dtype=np.float32)
        h.update(b"\x00")
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class EmbeddingCache:
    """Bounded LRU over content keys with counted evictions."""

    def __init__(self, capacity: int = 1024, metrics=None):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._entries: "collections.OrderedDict[str, Any]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        if metrics is not None:
            self._hit_c = metrics.counter("serve_cache_hits_total")
            self._miss_c = metrics.counter("serve_cache_misses_total")
            self._evict_c = metrics.counter("serve_cache_evictions_total")
            self._rate_g = metrics.gauge("serve_cache_hit_rate")
        else:
            self._hit_c = self._miss_c = self._evict_c = self._rate_g = None

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[Any]:
        """The cached value (moved to most-recent), or None on miss."""
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self.misses += 1
                if self._miss_c is not None:
                    self._miss_c.inc()
            else:
                self._entries.move_to_end(key)
                self.hits += 1
                if self._hit_c is not None:
                    self._hit_c.inc()
            if self._rate_g is not None:
                self._rate_g.set(self.hit_rate)
            return value

    def put(self, key: str, value: Any) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
                if self._evict_c is not None:
                    self._evict_c.inc()

    def clear(self) -> int:
        """Drop every entry (hit/miss/eviction counters keep their
        history); returns how many entries were dropped. The blue-green
        flip calls this: results computed by the outgoing trunk must
        not outlive it."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            return n

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> Dict[str, Any]:
        return {"size": len(self._entries), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hit_rate, 4)}
