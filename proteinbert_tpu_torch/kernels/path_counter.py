"""Two-sided kernel route accounting shared by the fused-block, attention
and one-pass dispatches — a copy of `proteinbert_tpu/kernels/
path_counter.py` (the port imports nothing of the JAX package).

Each kernel family keeps one process-wide `KernelPathCounter`: a count of
route decisions keyed by `(path, reason)`. The labels are the JAX
package's, so a stream, a `/metrics` page or `pbt diagnose --serve` reads
the same in both packages: "pallas" is the kernel route — in the port a
hand-written Hopper kernel on CUDA, its plain PyTorch version on the CPU —
and "reference" the route of the port of the JAX XLA reference, taken
where the JAX gate refuses the shape and no port kernel covers it
(`kernels/budget.py`); for the one-pass family "reference" is the
composition, as in JAX. Reasons: dense, packed, segments,
unsupported_shape.

JAX counts at trace time, once per traced block body: once per executable
under `cfg.scan_blocks` (every preset), once a block without it. The
port's forward counts the same way (`models/proteinbert.encode` silences
the blocks after the first under `scan_blocks`), once per forward; the
served path counts once per warm shape: `quiet()` also silences the eager
warm run before a capture and the later runs of a shape on the CPU, and a
CUDA graph's replay runs no Python, so it adds nothing.

`register` lets a telemetry owner (serve/server.Server) mirror bumps into
a registry counter (`fused_kernel_path_total` / `attention_kernel_path_
total` / `onepass_kernel_path_total{path=,reason=}`). Reference routes
warn ONCE per (reason, call-site shape)."""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Per thread: how many `quiet()` blocks are open.
_quiet = threading.local()


@contextmanager
def quiet() -> Iterator[None]:
    """On this thread, route decisions inside the block are not counted,
    observed or warned about (a served shape's repeated runs)."""
    _quiet.depth = getattr(_quiet, "depth", 0) + 1
    try:
        yield
    finally:
        _quiet.depth -= 1


def dtype_name(dtype) -> str:
    """"bfloat16" for torch.bfloat16: a dtype as the JAX shape keys print
    it."""
    return str(dtype).rsplit(".", 1)[-1]


class KernelPathCounter:
    """Process-wide (path, reason) route counter for one kernel family.
    `total` is a plain dict so callers can snapshot it with
    `dict(counter.total)` and diff across a forward."""

    def __init__(self, kernel_name: str, metric_name: str,
                 log: Optional[logging.Logger] = None) -> None:
        self.kernel_name = kernel_name
        self.metric_name = metric_name
        # Warnings go through the OWNING module's logger (when given)
        # so per-family log handlers/filters keep working.
        self.logger = log or logger
        self.total: Dict[Tuple[str, str], int] = {}
        self._observers: List[Callable[[str, str], None]] = []
        self._warned: set = set()
        self._lock = threading.Lock()

    def register(self, cb: Callable[[str, str], None]) -> None:
        """`cb(path, reason)` is invoked on every counted decision, both
        routes — the coverage feed."""
        with self._lock:
            self._observers.append(cb)

    def unregister(self, cb: Callable[[str, str], None]) -> None:
        with self._lock:
            if cb in self._observers:
                self._observers.remove(cb)

    def note(self, path: str, reason: str,
             shape: Optional[tuple] = None) -> None:
        """Record one route decision. `shape` keys the one-time reference
        warning per (reason, call-site shape)."""
        if path not in ("pallas", "reference"):
            raise ValueError(f"path must be 'pallas' or 'reference', "
                             f"got {path!r}")
        if getattr(_quiet, "depth", 0):
            return
        with self._lock:
            self.total[(path, reason)] = self.total.get((path, reason),
                                                        0) + 1
            observers = list(self._observers)
            warn = path == "reference" and (reason, shape) not in self._warned
            if warn:
                self._warned.add((reason, shape))
        for cb in observers:
            cb(path, reason)
        if warn:
            self.logger.warning(
                "%s does not run at shape %s (reason=%s): the reference "
                "route runs instead, counted in %s{path=reference}",
                self.kernel_name, shape, reason, self.metric_name)
