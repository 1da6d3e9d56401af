"""Host-side span tracing with device-trace forwarding — a copy of
`proteinbert_tpu/obs/tracing.py` whose profiler hook is torch's.

`span("name")` times a nested host region. Three sinks, all optional:

- a SpanCollector accumulates finished spans and dumps them as
  Perfetto-compatible `{"traceEvents": [...]}` JSON — the trace-event
  format torch.profiler's `export_chrome_trace` and the JAX profiler
  write, so one parser reads host-span dumps and device traces;
- while a torch profiler is recording, the span body also runs under
  `torch.profiler.record_function`, so spans appear on the host lane of
  the live trace (with `step=`, the step rides in the record's args);
- nesting depth is tracked per-thread, so a collector dump renders as a
  flame graph (perfetto nests by timestamps; depth is kept as an arg
  for flat consumers).

torch is NEVER imported by this module — only used if something else
already did — so the obs package stays importable without it. The JAX
module's hook (`jax.profiler.TraceAnnotation`) is the one difference.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

_tls = threading.local()


def _depth() -> int:
    return getattr(_tls, "depth", 0)


class SpanCollector:
    """Bounded buffer of finished spans (oldest dropped past capacity —
    a long run must not grow host memory without bound)."""

    def __init__(self, capacity: int = 20000):
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # getpid() is a real syscall on every add() — measurably slow
        # under sandboxed kernels (~90us observed) — and the pid cannot
        # change under us: collectors are not expected to survive fork.
        self._pid = os.getpid()

    def add(self, name: str, wall_start: float, dur_s: float,
            depth: int, tid: Optional[int] = None, **args) -> None:
        """Record one finished span. `tid` defaults to the calling
        thread; post-hoc emitters (serve request traces, which replay a
        request's stages after it resolves) pass a synthetic tid so
        each request renders on its own lane — overlapping requests on
        one thread id would nest into nonsense."""
        with self._lock:
            self._spans.append({
                "ph": "X", "name": name, "pid": self._pid,
                "tid": threading.get_ident() if tid is None else tid,
                "ts": round(wall_start * 1e6, 3),   # perfetto: microseconds
                "dur": round(dur_s * 1e6, 3),
                "args": {"depth": depth, **args} if (args or depth)
                        else {"depth": 0},
            })

    def __len__(self) -> int:
        return len(self._spans)

    def to_perfetto(self) -> Dict[str, Any]:
        meta = [{"ph": "M", "name": "process_name", "pid": self._pid,
                 "args": {"name": "proteinbert_tpu host spans"}}]
        with self._lock:
            return {"traceEvents": meta + list(self._spans)}

    def dump(self, path: str) -> str:
        """Write trace-event JSON (gzipped when the path ends in .gz) —
        loadable by ui.perfetto.dev and tools/trace_attribution.py."""
        data = json.dumps(self.to_perfetto())
        if path.endswith(".gz"):
            with gzip.open(path, "wt") as f:
                f.write(data)
        else:
            with open(path, "w") as f:
                f.write(data)
        return path


def _torch_annotation(name: str, step: Optional[int] = None):
    """A `record_function` context while a torch profiler is recording,
    else a null context. Checked through sys.modules: telemetry must not
    be the thing that pays the torch import."""
    torch = sys.modules.get("torch")
    if torch is None or not getattr(torch.autograd.profiler,
                                    "_is_profiler_enabled", False):
        return contextlib.nullcontext()
    try:
        return torch.autograd.profiler.record_function(
            name, None if step is None else f"step={step}")
    except Exception:
        return contextlib.nullcontext()


@contextlib.contextmanager
def span(name: str, collector: Optional[SpanCollector] = None,
         step: Optional[int] = None, **args):
    """Nested host span: times the body, forwards to the torch profiler
    while one records, records into `collector` when given."""
    depth = _depth()
    _tls.depth = depth + 1
    wall0 = time.time()
    t0 = time.perf_counter()
    try:
        with _torch_annotation(name, step):
            yield
    finally:
        _tls.depth = depth
        if collector is not None:
            dur = time.perf_counter() - t0
            if step is not None:
                args["step"] = step
            collector.add(name, wall0, dur, depth, **args)
