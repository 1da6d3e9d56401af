"""Metrics registry: labeled counters / gauges / histograms, one sink — a
copy of `proteinbert_tpu/obs/metrics.py` that differs only in this
docstring's first line and a comment without the JAX tree's issue
number.

Absorbs the host-timer aggregation previously scattered across
`utils/profiling.Profiler`, StepTimer's summary dicts, ZeRO's comm/HBM
accounting, and the data-pipeline wait counters: producers register
instruments here; consumers read ONE snapshot (JSON) or a
Prometheus-style textfile instead of N private formats.

Overhead contract: a DISABLED registry hands out shared null
instruments whose methods are constant no-ops — no dict lookups, no
perf_counter calls — so the hot step path pays ~zero when telemetry is
off, and the enabled path only does O(1) float arithmetic per
observation (the trainer additionally confines its observations to the
log cadence, keeping measured overhead under 1% of step time).

Stdlib-only; no jax import (tools must run anywhere).
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming summary (count/sum/min/max/last): enough for rates and
    stall detection without per-observation allocation; exported in
    Prometheus summary style (_count/_sum plus min/max gauges)."""

    __slots__ = ("count", "total", "min", "max", "last")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.last = v


def nearest_rank(sorted_values, fraction: float) -> Optional[float]:
    """Nearest-rank pick from an ASCENDING list; `fraction` in [0, 1].
    The one percentile convention for the obs package (QuantileWindow,
    diagnose): a rank-rule change happens here or nowhere."""
    if not sorted_values:
        return None
    idx = min(len(sorted_values) - 1,
              max(0, int(round(fraction * (len(sorted_values) - 1)))))
    return sorted_values[idx]


class QuantileWindow:
    """Bounded ring of recent observations with percentile reads — the
    p50/p99 a streaming Histogram cannot provide (count/sum/min/max
    only). Previously `serve/server._LatencyWindow`; it lives in the
    registry now so `/metrics`, `Server.stats()`, and `serve_request`
    events all read the SAME ring and cannot drift (percentiles are
    computed at read time, never cached).

    Thread-safe: serving observes from the scheduler thread while
    stats()/scrapes read from client/HTTP threads."""

    __slots__ = ("_ring", "_lock")

    def __init__(self, capacity: int = 2048):
        self._ring: "collections.deque[float]" = collections.deque(
            maxlen=capacity)               # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._ring.append(float(seconds))

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def values(self):
        """A consistent copy of the raw ring, oldest first. The fleet
        aggregation plane merges percentile windows across
        replicas by CONCATENATING raw values — a fleet p99 is not any
        function of per-replica p99s — so the scrape endpoint ships
        these, not summary()."""
        with self._lock:
            return list(self._ring)

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile; `q` is in PERCENT (0–100), e.g.
        `percentile(99)` — not the 0–1 fraction `summary()` uses
        internally. None while the ring is empty."""
        with self._lock:
            data = sorted(self._ring)
        return nearest_rank(data, q / 100.0)

    def summary(self) -> Dict[str, Optional[float]]:
        with self._lock:
            if not self._ring:
                return {"n": 0, "p50_s": None, "p99_s": None, "mean_s": None}
            data = sorted(self._ring)
        return {"n": len(data),
                "p50_s": round(nearest_rank(data, 0.50), 6),
                "p99_s": round(nearest_rank(data, 0.99), 6),
                "mean_s": round(sum(data) / len(data), 6)}


class _NullInstrument:
    """Shared do-nothing counter/gauge/histogram for a disabled registry."""

    __slots__ = ()
    value = 0.0
    count = 0
    total = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL = _NullInstrument()
_NULL_CTX = contextlib.nullcontext()


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._windows: Dict[str, QuantileWindow] = {}

    # ----------------------------------------------------- instruments

    def counter(self, name: str, **labels) -> Counter:
        if not self.enabled:
            return _NULL
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        if not self.enabled:
            return _NULL
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        if not self.enabled:
            return _NULL
        return self._get(self._histograms, Histogram, name, labels)

    def quantile_window(self, name: str, capacity: int = 2048,
                        **labels) -> QuantileWindow:
        """A registered percentile ring (exported as `<name>_p50_s` /
        `_p99_s` / `_mean_s` gauge families plus `<name>_window_n`).

        Unlike the other instruments, a DISABLED registry returns a
        live but UNREGISTERED window rather than a shared no-op: the
        callers that need percentiles (Server.stats) must report real
        numbers even under the NULL telemetry facade, and a deque
        append is cheap enough to keep the ~zero-overhead contract."""
        if not self.enabled:
            return QuantileWindow(capacity)
        k = _key(name, labels)
        win = self._windows.get(k)
        if win is None:
            win = self._windows[k] = QuantileWindow(capacity)
        return win

    def _get(self, table, cls, name, labels):
        k = _key(name, labels)
        inst = table.get(k)
        if inst is None:
            inst = table[k] = cls()
        return inst

    @contextlib.contextmanager
    def _timed(self, hist: Histogram):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            hist.observe(time.perf_counter() - t0)

    def timer(self, name: str, **labels):
        """`with registry.timer("phase"):` — observes elapsed seconds
        into histogram `name`. Free (no clock reads) when disabled."""
        if not self.enabled:
            return _NULL_CTX
        return self._timed(self._get(self._histograms, Histogram,
                                     name, labels))

    def set_many(self, values: Dict[str, float], prefix: str = "") -> None:
        """Bulk gauge update from a metrics dict (e.g. a StepTimer
        summary); non-numeric values are skipped."""
        if not self.enabled:
            return
        for k, v in values.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.gauge(prefix + k).set(v)

    # ----------------------------------------------------- export

    def snapshot(self) -> Dict[str, Any]:
        out = {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {
                k: {"count": h.count, "sum": h.total,
                    "min": (h.min if h.count else None),
                    "max": (h.max if h.count else None),
                    "mean": (h.total / h.count if h.count else None),
                    "last": (h.last if h.count else None)}
                for k, h in self._histograms.items()
            },
        }
        if self._windows:
            out["windows"] = {k: w.summary()
                              for k, w in self._windows.items()}
        return out

    def window_values(self) -> Dict[str, Any]:
        """{window key: raw ring values} — the machine-readable form
        `/metrics.json` ships so a fleet router can merge percentiles
        across replicas from the concatenated observations."""
        return {k: w.values() for k, w in self._windows.items()}

    def write_snapshot(self, path: str) -> None:
        """Append one timestamped JSONL snapshot line."""
        import json

        with open(path, "a", buffering=1) as f:
            f.write(json.dumps({"t": round(time.time(), 3),
                                **self.snapshot()}) + "\n")

    def prometheus_text(self, prefix: str = "pbt_") -> str:
        """Prometheus textfile-collector exposition (counters as
        counter, gauges as gauge, histograms as summary-style
        _count/_sum plus _min/_max gauges)."""
        lines = []
        typed = set()

        def metric(key, suffix, kind, value):
            # TYPE lines are per SAMPLE FAMILY (bare name + suffix,
            # labels stripped): a labeled histogram 'h{l="x"}' exports
            # families pbt_h_count/_sum/_min/_max, each typed once —
            # never a TYPE line for a family with no samples.
            name, _, labels = key.partition("{")
            family = f"{prefix}{name}{suffix}"
            if family not in typed:
                typed.add(family)
                lines.append(f"# TYPE {family} {kind}")
            labels = ("{" + labels) if labels else ""
            lines.append(f"{family}{labels} {value:.9g}")

        for k, c in sorted(self._counters.items()):
            metric(k, "", "counter", c.value)
        for k, g in sorted(self._gauges.items()):
            metric(k, "", "gauge", g.value)
        for k, h in sorted(self._histograms.items()):
            metric(k, "_count", "counter", h.count)
            metric(k, "_sum", "counter", h.total)
            if h.count:
                metric(k, "_min", "gauge", h.min)
                metric(k, "_max", "gauge", h.max)
        for k, w in sorted(self._windows.items()):
            # Percentiles computed at scrape time from the live ring —
            # the exposition can never lag what stats() reports.
            s = w.summary()
            metric(k, "_window_n", "gauge", s["n"])
            if s["n"]:
                metric(k, "_p50_s", "gauge", s["p50_s"])
                metric(k, "_p99_s", "gauge", s["p99_s"])
                metric(k, "_mean_s", "gauge", s["mean_s"])
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str, prefix: str = "pbt_") -> None:
        """Atomic write (tmp + rename): a scraper must never read a
        half-written textfile."""
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".prom.", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                f.write(self.prometheus_text(prefix))
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # ------------------------------------------- Profiler-compat view

    def timer_summary(self) -> Dict[str, Dict[str, float]]:
        """The aggregation `utils/profiling.Profiler.summary()` used to
        build — {name: {total_s, count, mean_s}} over timer histograms —
        so Profiler can be a thin shim over this registry."""
        return {
            k: {"total_s": h.total, "count": h.count,
                "mean_s": h.total / h.count}
            for k, h in self._histograms.items() if h.count
        }
