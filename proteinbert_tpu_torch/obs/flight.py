"""Crash-forensics flight recorder: last-N events, dumped on death — a
copy of `proteinbert_tpu/obs/flight.py` that differs only in this
docstring's first line and its imports.

A bounded ring buffer holds the most recent event records (every record
the Telemetry facade emits lands here, whether or not an events file is
configured). On SIGTERM, NaN-halt, or an unhandled exception the buffer
is dumped to `flight_<pid>.json` so every death leaves forensics — the
event sequence right before the end, which a truncated text log rarely
captures (staged-checkpoint in flight? eval pending? what were the last
window rates?).

Dump rules:
- atomic (tmp + rename): the reader never sees a torn dump;
- NEVER raises: the original failure (the signal, the NaN, the
  exception) must stay the reported cause of death — a full disk on the
  way down is logged and swallowed;
- repeated dumps overwrite: the LAST picture before death wins (a
  signal-time dump followed by the cleaner preemption-path dump).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from proteinbert_tpu_torch.obs.events import SCHEMA_VERSION, sanitize

logger = logging.getLogger(__name__)


def flight_path(directory: str, pid: Optional[int] = None) -> str:
    return os.path.join(directory, f"flight_{pid or os.getpid()}.json")


class FlightRecorder:
    def __init__(self, capacity: int = 256, directory: str = "."):
        self.capacity = capacity
        self.directory = os.path.abspath(directory)
        # RLock, not Lock: dump() runs inside the SIGTERM handler, which
        # Python executes on the MAIN thread between bytecodes — if the
        # signal lands while that same thread is inside record()'s lock,
        # a non-reentrant lock would deadlock the clean-preemption path.
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.RLock()
        self._prev_excepthook = None

    def record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._buf.append(rec)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the ring to `flight_<pid>.json`; returns the path, or
        None on failure (logged, never raised)."""
        path = path or flight_path(self.directory)
        payload = {
            "v": SCHEMA_VERSION,
            "kind": "flight_recorder",
            "pid": os.getpid(),
            "reason": str(reason),
            "dumped_at": round(time.time(), 3),
            "capacity": self.capacity,
            "events": sanitize(self.snapshot()),
        }
        try:
            d = os.path.dirname(path) or "."
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(prefix=".flight.", dir=d)
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except OSError:
            logger.warning("flight-recorder dump to %s failed", path,
                           exc_info=True)
            return None
        logger.warning("flight recorder dumped %d events to %s (%s)",
                       len(payload["events"]), path, reason)
        return path

    # ------------------------------------------------- crash hooks

    def install_excepthook(self) -> None:
        """Dump on any unhandled exception, then defer to the previous
        hook — so the traceback still prints and a prior hook (pytest,
        a supervisor) still runs."""
        if self._prev_excepthook is not None:
            return  # already installed
        self._prev_excepthook = sys.excepthook

        def hook(exc_type, exc, tb):
            self.dump(f"unhandled_{exc_type.__name__}")
            self._prev_excepthook(exc_type, exc, tb)

        sys.excepthook = hook

    def uninstall_excepthook(self) -> None:
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None


def validate_flight_dump(payload: Any) -> None:
    """Raise ValueError unless `payload` is a well-formed flight dump
    (shared by tools/validate_events.py and the tests)."""
    from proteinbert_tpu_torch.obs.events import validate_record

    if not isinstance(payload, dict):
        raise ValueError("flight dump is not an object")
    if payload.get("kind") != "flight_recorder":
        raise ValueError(f"kind {payload.get('kind')!r} != 'flight_recorder'")
    if payload.get("v") != SCHEMA_VERSION:
        raise ValueError(
            f"schema version {payload.get('v')!r} != {SCHEMA_VERSION}")
    for field, typ in (("pid", int), ("reason", str),
                      ("dumped_at", (int, float)), ("events", list)):
        if not isinstance(payload.get(field), typ):
            raise ValueError(f"missing/mistyped field {field!r}")
    for i, rec in enumerate(payload["events"]):
        try:
            validate_record(rec)
        except ValueError as e:
            raise ValueError(f"events[{i}]: {e}") from None
