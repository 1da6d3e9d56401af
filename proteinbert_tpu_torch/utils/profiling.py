"""Wall-clock and device profiling of the port (the JAX package's
`utils/profiling.py`).

`TimeMeasure` (a with-block wall-clock logger), `Profiler` (named
aggregating timers over the telemetry metrics registry),
`BoundaryStallMeter` (the host stall of a boundary region) and
`monitor_memory` (a heap walker for large host or device buffers) are
copies of the JAX helpers. The device half is torch's:

- `device_trace` records a `torch.profiler` trace of the host's operators
  and, on a card, the CUDA kernels (CUPTI), and writes one Chrome-trace
  JSON into the directory (open with ui.perfetto.dev or chrome://tracing);
- `device_memory_report` reads the CUDA caching allocator's counters per
  card under the JAX report's names (`bytes_in_use`, `peak_bytes_in_use`,
  `bytes_limit`), beside `torch.cuda.memory_stats`' own.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from proteinbert_tpu_torch.utils.logging import log


class TimeMeasure:
    """`with TimeMeasure('phase'):` — logs elapsed wall-clock on exit."""

    def __init__(self, name: str = "", verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            log(f"{self.name or 'block'}: {self.elapsed:.3f}s")
        return False


class Profiler:
    """Named aggregating profiler — now a thin shim over the telemetry
    metrics registry (obs/metrics.py), which absorbed the host-timer
    aggregation this class used to hold privately. The API is unchanged
    (`measure`/`summary`/`report`), and existing call sites keep
    working; pass a shared `registry` to fold a Profiler's sections
    into a run's unified metrics stream instead of a private one."""

    def __init__(self, registry=None):
        from proteinbert_tpu_torch.obs.metrics import MetricsRegistry

        self._reg = registry if registry is not None else MetricsRegistry()

    def measure(self, name: str):
        return self._reg.timer(name)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return self._reg.timer_summary()

    def report(self) -> str:
        rows = sorted(self.summary().items(),
                      key=lambda kv: -kv[1]["total_s"])
        return "\n".join(
            f"{name}: {s['total_s']:.3f}s / {s['count']} calls "
            f"({s['mean_s'] * 1e3:.2f} ms each)"
            for name, s in rows
        )


class BoundaryStallMeter:
    """Per-event host-stall meter: how long a dispatch loop spent inside
    a boundary region (checkpoint save, eval bracket) instead of
    enqueuing device work. This is the number the overlapped-boundary
    work optimizes — wall seconds the train stream stood still — and
    what `bench.py --boundary` reports for the synchronous vs staged
    checkpoint paths. Distinct from StepTimer.overlap: that accounts
    hidden seconds inside a live training run; this measures the stall
    itself, in isolation, for before/after comparison."""

    def __init__(self):
        self.stalls: list = []

    @contextlib.contextmanager
    def boundary(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stalls.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        n = len(self.stalls)
        if not n:
            return {"boundaries": 0}
        return {
            "boundaries": n,
            "mean_s": sum(self.stalls) / n,
            # The comparison statistic for small samples: one GC pause
            # or scheduler hiccup inside a single boundary swings a
            # 4-sample mean by 2-3x; the median holds steady.
            "median_s": sorted(self.stalls)[n // 2],
            "max_s": max(self.stalls),
            "total_s": sum(self.stalls),
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a `torch.profiler` trace of the block to
    `<log_dir>/trace_<pid>.json`. The CUDA activity is recorded when a
    card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        log(f"device trace written to {path}")


def monitor_memory(threshold_bytes: int = 100 * 1024 ** 2,
                   collect: bool = False, verbose: bool = True):
    """Log every live host array buffer >= `threshold_bytes` (reference
    shared_utils/util.py:175-228's heap walker). Walks every gc-tracked
    container (module __dict__s included) plus the `__dict__` of every
    gc-tracked instance, and recurses through UNTRACKED containers found
    inside them — CPython untracks a dict/tuple whose members are all
    untracked (a tuple-of-arrays pytree, an instance __dict__ holding
    only arrays), so such nests are reachable only through a tracked
    ancestor. Returns [(type_name, nbytes), ...] largest first,
    deduplicated by identity; optionally gc.collect()s afterwards like
    the reference.
    """
    import collections
    import gc

    def size_of(obj):
        # Probe `nbytes` (numpy arrays, torch tensors on the host or the
        # card) through the TYPE, never the
        # instance: instance getattr would fire arbitrary __getattr__ on
        # every live object (observed force-registering pytest marks;
        # would force-initialize lazy proxies heap-wide). Everything is
        # guarded — even isinstance raises on a dead weakref.proxy.
        try:
            if isinstance(obj, (bytes, bytearray)):
                return len(obj)
            desc = getattr(type(obj), "nbytes", None)
            if desc is None or not hasattr(desc, "__get__"):
                return None
            n = desc.__get__(obj, type(obj))
        except Exception:  # dead weakproxies, raising descriptors
            return None
        return n if isinstance(n, int) else None

    seen: Dict[int, tuple] = {}
    visited: set = set()
    # Strong references to every object whose id() lands in `visited` or
    # `seen`: the stack pops its only reference to intermediate objects,
    # and if one were collected mid-walk CPython could reuse its id for a
    # genuinely new container/buffer — silently skipping it or
    # overwriting a seen entry. Pinning them for the walk's
    # duration makes id-dedup sound; the list is released on return.
    pinned: list = []
    # The walker's own bookkeeping is gc-tracked and MUTATES during the
    # walk — iterating it would raise "changed size during iteration".
    internals = {id(seen), id(visited), id(pinned)}

    # Iterative walk (an explicit stack): deep pathological nests must
    # not RecursionError a diagnostic tool. Only containers enter
    # `visited` — recording every leaf id would balloon the walker's own
    # footprint on multi-million-element lists (`seen` already dedups
    # leaf buffers by id).
    containers = (dict, list, tuple, set, frozenset, collections.deque)
    stack = []
    internals.add(id(stack))  # gc-listed below; must not walk itself
    for c in gc.get_objects():
        # Everything here is guarded: a dead weakref.proxy raises
        # ReferenceError from isinstance itself (it forwards __class__ to
        # the collected referent).
        try:
            if isinstance(c, containers):
                stack.append(c)
            else:
                # Instances are gc-tracked even when their __dict__ is
                # not (all-untracked values, e.g. only numpy arrays on
                # self) — the commonest big-buffer holder. Find the
                # __dict__ slot through the TYPE's mro: plain getattr
                # would fall through to instance __getattr__ on
                # __slots__ classes and fire lazy-proxy side effects
                # heap-wide (the same hazard size_of avoids).
                d = None
                for klass in type(c).__mro__:
                    desc = klass.__dict__.get("__dict__")
                    if desc is not None:
                        d = desc.__get__(c, type(c))
                        break
                if isinstance(d, dict):
                    stack.append(d)
        except Exception:
            continue
    while stack:
        obj = stack.pop()
        # issubclass(type(obj), ...) not isinstance: a dead weakref.proxy
        # forwards __class__ to its collected referent and raises from
        # isinstance, while type() never forwards.
        if issubclass(type(obj), containers):
            if id(obj) in visited or id(obj) in internals:
                continue
            visited.add(id(obj))
            pinned.append(obj)
            try:
                if isinstance(obj, dict):
                    # keys too: bytes keys are legal and can be large
                    stack.extend(list(obj.keys()))
                    stack.extend(list(obj.values()))
                else:
                    stack.extend(list(obj))
            except Exception:
                # Mutated mid-iteration by another thread (prefetch, a
                # server's dispatch), or a container subclass whose iteration
                # raises; skip it rather than crash a diagnostic.
                continue
        else:
            n = size_of(obj)
            if n is not None and n >= threshold_bytes:
                if id(obj) not in seen:
                    pinned.append(obj)
                seen[id(obj)] = (type(obj).__name__, n)

    found = sorted(seen.values(), key=lambda kv: -kv[1])
    if verbose:
        for name, n in found:
            log(f"monitor_memory: {name} {n / 1024 ** 2:.0f} MB")
        if not found:
            log(f"monitor_memory: no object >= "
                f"{threshold_bytes / 1024 ** 2:.0f} MB")
    if collect:
        gc.collect()
    return found


def device_memory_report() -> Dict[str, Dict[str, int]]:
    """Per-card memory stats ({"cuda:<i>": {bytes_in_use,
    peak_bytes_in_use, bytes_limit, ...}}) — the on-card counterpart of
    monitor_memory, and the numbers the caching allocator actually
    enforces: `bytes_in_use` is `torch.cuda.memory_allocated`,
    `peak_bytes_in_use` `torch.cuda.max_memory_allocated`, `bytes_limit`
    the card's total memory, and every numeric entry of
    `torch.cuda.memory_stats` rides along under its own name. A machine
    without CUDA reports no device ({}), as the JAX report gives no stats
    on a CPU backend."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = {k: int(v) for k, v in torch.cuda.memory_stats(i).items()
                 if isinstance(v, (int, float))}
        stats.update(
            bytes_in_use=int(torch.cuda.memory_allocated(i)),
            peak_bytes_in_use=int(torch.cuda.max_memory_allocated(i)),
            bytes_limit=int(torch.cuda.get_device_properties(i).total_memory))
        out[f"cuda:{i}"] = stats
    return out
