"""Training-loop failure detection + graceful preemption — a copy of
`proteinbert_tpu/train/resilience.py` (`NonFiniteLossError`,
`check_finite`, `GracefulShutdown`, `flush_inflight_checkpoint`) that
differs only in this docstring: the port imports nothing of the JAX
package.

Two mechanisms, both wired into train/trainer.py:

- `GracefulShutdown`: installs SIGTERM/SIGINT handlers that set a flag;
  the trainer finishes the in-flight step, saves a checkpoint, and
  returns with `preempted=True` instead of dying mid-save (the exit
  code 75 a supervisor requeues on belongs to a CLI, which the port does
  not have yet). The second signal falls through to the previous handler
  (so a double Ctrl-C still kills a hung run).
- `check_finite`: host-side NaN/Inf detection on the (already fetched)
  logged metrics; on trigger the trainer saves a diagnostic checkpoint
  into `<checkpoint dir>-diagnostic` and raises `NonFiniteLossError`
  (cfg.train.on_nan="halt", default) or logs and continues ("warn").

Both paths interact with the overlapped checkpoint boundary: a staged
snapshot may be mid-flight (device→host copy and write on the saver
thread) when the SIGTERM or the NaN lands, and it must be flushed to
disk before the return / halt — `flush_inflight_checkpoint` is the
shared best-effort flush both trainer paths call.
"""

from __future__ import annotations

import math
import signal
from typing import Dict, Optional

import logging

logger = logging.getLogger(__name__)


class NonFiniteLossError(RuntimeError):
    """Loss or grad norm went NaN/Inf; a diagnostic checkpoint was saved."""


class GracefulShutdown:
    """Flag-setting SIGTERM/SIGINT trap, usable as a context manager.

    >>> with GracefulShutdown() as stop:
    ...     for step in range(n):
    ...         if stop.requested: break
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 on_signal=None):
        self._signals = signals
        self._previous: Dict[int, object] = {}
        self.requested = False
        self.signum: Optional[int] = None
        # Optional callable(signum) run at the FIRST signal, inside the
        # handler — the flight-recorder dump hook: even if the clean
        # preemption path later wedges (a hung collective, a stuck
        # stager join), forensics for the moment of the signal are
        # already on disk. Must be cheap and must not raise; errors are
        # swallowed so a broken hook cannot turn a clean preemption
        # into a crash.
        self._on_signal = on_signal

    def _handler(self, signum, frame):
        if self.requested:
            # Second signal: restore + re-raise through the old handler so
            # an operator can still force-kill a wedged run.
            prev = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            raise KeyboardInterrupt(f"second signal {signum}")
        self.requested = True
        self.signum = signum
        logger.warning(
            "signal %s received: finishing current step, then "
            "checkpoint + clean exit", signum)
        if self._on_signal is not None:
            try:
                self._on_signal(signum)
            except Exception:
                logger.exception("on_signal hook failed (continuing "
                                 "with the clean preemption path)")

    def __enter__(self):
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:
                # Not the main thread (e.g. a test runner worker): degrade
                # to a never-triggered flag rather than crash.
                logger.debug("cannot trap signal %s off the main thread", s)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        return False


def flush_inflight_checkpoint(checkpointer, context: str) -> None:
    """Best-effort flush of staged/async checkpoint work on a failure
    path (SIGTERM → exit-75 requeue, NaN halt): an overlapped boundary
    may have a snapshot mid-fetch when the run dies, and abandoning it
    would lose the newest durable state a requeued run could resume
    from. Flush errors are LOGGED, never raised — the original failure
    (the signal, the NaN) must stay the reported cause of death."""
    if checkpointer is None:
        return
    try:
        checkpointer.wait()
    except Exception:
        logger.exception(
            "flushing in-flight checkpoint state during %s failed "
            "(continuing with the original failure path)", context)


def check_finite(metrics: Dict[str, float], step: int, mode: str = "halt",
                 keys=("loss", "grad_norm")) -> bool:
    """True if the watched metrics are finite. On failure: raises
    NonFiniteLossError (mode='halt'), warns (mode='warn'), or just
    returns False (mode='quiet' — the caller decides, e.g. to save a
    diagnostic checkpoint before re-calling with 'halt')."""
    bad = [k for k in keys if k in metrics and not math.isfinite(metrics[k])]
    if not bad:
        return True
    if mode == "quiet":
        return False
    msg = (f"non-finite {'/'.join(bad)} at step {step}: "
           f"{ {k: metrics[k] for k in bad} }")
    if mode == "halt":
        raise NonFiniteLossError(msg)
    logger.warning("%s (on_nan=warn: continuing)", msg)
    return False
