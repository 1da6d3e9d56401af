"""Env-spec fault hooks for the map engine — a copy of
`proteinbert_tpu/mapper/faults.py` (stdlib only; only the docstrings and
comments differ).

The JAX package's chaos drill (tools/map_drill.py) runs `pbt map` as a real
subprocess and needs deterministic injection points INSIDE it: SIGKILL
between the object write and the cursor advance, transient dispatch
failures with a retry count, a NaN poked into a block's output, and an
extra per-block latency to widen kill windows. Those points are
described by one spec string in the PBT_MAP_FAULTS environment
variable; the engine parses it here and consults the resulting
`MapFaults` at each hook point. An empty/absent spec is inert — the
production path pays a None-ish check only.

Spec format (semicolon-separated directives; shard/block are ints):

  crash=<shard>:<block>:<point>   SIGKILL self when the engine reaches
                                  `point` for that (shard, block).
                                  Points: block_fetched (the
                                  device results fetched to host but
                                  nothing written yet: the pipelined
                                  device-complete-but-uncommitted
                                  window, fired by engine.py),
                                  before_object, after_object,
                                  cursor_serialized, cursor_tmp_written,
                                  cursor_prev_updated, cursor_renamed
                                  (store.commit_block / ShardCursor).
  fail=<shard>:<block>:<times>    raise TransientDispatchError on the
                                  first <times> dispatch attempts of
                                  that block (then succeed).
  nan=<shard>:<block>             corrupt that block's output with a
                                  non-finite value (NaN-halt drill).
  latency=<seconds>               sleep this long before every block.

The drill-side builder for this format lives in tools/faults.py (the
shared injection surface of the fleet and map drills); this module is
the consumer and must stay importable from the package alone.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

FAULT_ENV = "PBT_MAP_FAULTS"

CRASH_POINTS = ("block_fetched", "before_object", "after_object",
                "cursor_serialized", "cursor_tmp_written",
                "cursor_prev_updated", "cursor_renamed")


class TransientDispatchError(RuntimeError):
    """A dispatch attempt failed in a way worth retrying (injected by
    the drill; real transient backend errors may be wrapped into this
    by callers that can classify them)."""


class MapFaults:
    """Parsed PBT_MAP_FAULTS spec; every accessor is a no-op default."""

    def __init__(self,
                 crash: Optional[Dict[Tuple[int, int], str]] = None,
                 fail: Optional[Dict[Tuple[int, int], int]] = None,
                 nan: Optional[set] = None,
                 latency_s: float = 0.0):
        self._crash = dict(crash or {})
        self._fail = dict(fail or {})
        self._nan = set(nan or ())
        self.latency_s = float(latency_s)

    @classmethod
    def from_env(cls, env_var: str = FAULT_ENV) -> "MapFaults":
        return cls.parse(os.environ.get(env_var, ""))

    @classmethod
    def parse(cls, spec: str) -> "MapFaults":
        """Parse one spec string; malformed directives raise ValueError
        (a drill typo must fail loudly, not silently not-inject)."""
        crash: Dict[Tuple[int, int], str] = {}
        fail: Dict[Tuple[int, int], int] = {}
        nan: set = set()
        latency = 0.0
        for raw in (spec or "").split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if "=" not in raw:
                raise ValueError(f"fault directive without '=': {raw!r}")
            kind, _, val = raw.partition("=")
            parts = val.split(":")
            if kind == "crash":
                if len(parts) != 3 or parts[2] not in CRASH_POINTS:
                    raise ValueError(
                        f"crash wants shard:block:point with point in "
                        f"{CRASH_POINTS}, got {val!r}")
                crash[(int(parts[0]), int(parts[1]))] = parts[2]
            elif kind == "fail":
                if len(parts) != 3:
                    raise ValueError(f"fail wants shard:block:times, "
                                     f"got {val!r}")
                fail[(int(parts[0]), int(parts[1]))] = int(parts[2])
            elif kind == "nan":
                if len(parts) != 2:
                    raise ValueError(f"nan wants shard:block, got {val!r}")
                nan.add((int(parts[0]), int(parts[1])))
            elif kind == "latency":
                latency = float(val)
            else:
                raise ValueError(f"unknown fault directive {kind!r}")
        return cls(crash=crash, fail=fail, nan=nan, latency_s=latency)

    def crash_hook(self, shard: int, block: int):
        """A callable(point) for store.commit_block: SIGKILL self at the
        armed point — the hardest landing a writer can take, exactly
        between two filesystem operations. Returns None when nothing is
        armed for this (shard, block), so the store pays no closure."""
        point = self._crash.get((int(shard), int(block)))
        if point is None:
            return None

        def hook(reached: str) -> None:
            if reached == point:
                logger.warning("FAULT INJECTION: SIGKILL at %s for shard "
                               "%d block %d", point, shard, block)
                os.kill(os.getpid(), signal.SIGKILL)

        return hook

    def take_failure(self, shard: int, block: int) -> bool:
        """Consume one injected dispatch failure for (shard, block);
        True while any remain."""
        key = (int(shard), int(block))
        left = self._fail.get(key, 0)
        if left <= 0:
            return False
        self._fail[key] = left - 1
        return True

    def poison_output(self, shard: int, block: int) -> bool:
        return (int(shard), int(block)) in self._nan

    def block_latency(self) -> None:
        if self.latency_s > 0:
            time.sleep(self.latency_s)

    def armed(self) -> bool:
        return bool(self._crash or self._fail or self._nan
                    or self.latency_s > 0)
