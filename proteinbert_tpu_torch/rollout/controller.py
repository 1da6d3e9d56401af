"""The rollout controller: shadow → gate → flip → rollback — a copy of
`proteinbert_tpu/rollout/controller.py` with its import re-pointed at
the port's `obs`.

One controller drives one candidate trunk through the fleet. The
router's sealed-200 path calls `mirror()` after every live response is
sealed; the controller samples a deterministic stride of those, replays
each against the serving replica's candidate arm (X-PBT-Shadow), and
scores the response pair. Shadows are observations, not requests: they
never retry, never write a cache, never touch a live counter, and a
full mirror queue drops the copy rather than slowing the live path.

Gates close per window of `window_requests` shadows:

  parity      max |live − shadow| over shared numeric leaves
  slo_burn    fleet max burn-rate now − the baseline at start()
  heads_eval  worst registered-head score drop through the candidate
              (HeadsEvalGate, cached — the eval runs once per rollout)
  failures    zero shadow transport/HTTP failures in the window

`windows_required` consecutive green windows promote (when
auto_promote); the same count of consecutive red windows refuses and
unloads the candidate everywhere. Promotion flips each replica in turn
(`_pre_flip_hook` is the chaos seam), re-pins frozen heads, and flushes
the router cache. A post-promotion `breach()` rolls every flipped
replica back to the host-parked trunk (bit-identical numerics) and
restores the pins.
"""

from __future__ import annotations

import json
import logging
import math
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from proteinbert_tpu_torch.obs import as_telemetry

logger = logging.getLogger("proteinbert_tpu.rollout")

# Event-enum states a controller can report (schema: rollout_state).
TERMINAL_STATES = ("idle", "refused", "aborted", "promoted",
                   "rolled_back")


def _has_numeric(x: Any) -> bool:
    if isinstance(x, bool):
        return False
    if isinstance(x, (int, float)):
        return True
    if isinstance(x, dict):
        return any(_has_numeric(v) for v in x.values())
    if isinstance(x, list):
        return any(_has_numeric(v) for v in x)
    return False


def parity_delta(live: Any, shadow: Any) -> float:
    """Max abs difference over the numeric leaves two JSON bodies
    share; +inf on structural mismatch (a numeric leaf present on one
    side only, shape/length skew, or type disagreement). Non-numeric
    leaves (request ids, names) may differ freely — identity fields
    are EXPECTED to differ between a live response and its shadow."""
    if isinstance(live, bool) or isinstance(shadow, bool):
        return 0.0 if live == shadow else math.inf
    if isinstance(live, (int, float)) and isinstance(shadow, (int, float)):
        return abs(float(live) - float(shadow))
    if isinstance(live, dict) and isinstance(shadow, dict):
        worst = 0.0
        for k in set(live) | set(shadow):
            if k not in live or k not in shadow:
                if _has_numeric(live.get(k)) or _has_numeric(shadow.get(k)):
                    return math.inf
                continue
            worst = max(worst, parity_delta(live[k], shadow[k]))
            if math.isinf(worst):
                return worst
        return worst
    if isinstance(live, list) and isinstance(shadow, list):
        if len(live) != len(shadow):
            return math.inf
        worst = 0.0
        for a, b in zip(live, shadow):
            worst = max(worst, parity_delta(a, b))
            if math.isinf(worst):
                return worst
        return worst
    if type(live) is type(shadow):
        return 0.0
    return math.inf


class RolloutController:
    """See module doc. Thread model: `mirror()` runs on router handler
    threads (sample + enqueue only); one worker thread replays shadows
    and closes windows; control verbs (start/promote/abort/breach) run
    on whichever thread calls them, guarded by short `_lock` holds with
    all network I/O outside the lock."""

    def __init__(
        self,
        router,
        *,
        telemetry=None,
        source: str,
        sample_every: int = 2,
        window_requests: int = 8,
        windows_required: int = 2,
        shadow_parity_max: float = 1e-3,
        slo_burn_delta_max: float = 0.5,
        heads_eval_drop_max: float = 0.05,
        heads_eval=None,
        auto_promote: bool = True,
        hbm_budget_bytes: Optional[int] = None,
        clock=time.monotonic,
    ):
        if not isinstance(source, str) or not source:
            raise ValueError("rollout 'source' must be a non-empty "
                             "string (the candidate_loader key)")
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        if window_requests < 1:
            raise ValueError("window_requests must be >= 1")
        if windows_required < 1:
            raise ValueError("windows_required must be >= 1")
        self.router = router
        self.tele = as_telemetry(telemetry)
        self.clock = clock
        self.source = source
        self.sample_every = int(sample_every)
        self.window_requests = int(window_requests)
        self.windows_required = int(windows_required)
        self.shadow_parity_max = float(shadow_parity_max)
        self.slo_burn_delta_max = float(slo_burn_delta_max)
        self.heads_eval_drop_max = float(heads_eval_drop_max)
        self.heads_eval = heads_eval
        self.auto_promote = bool(auto_promote)
        self.hbm_budget_bytes = hbm_budget_bytes

        self.state = "idle"
        self.candidate_fp: Optional[str] = None
        self.loaded: List[str] = []
        self.flipped: List[str] = []
        self.baseline_burn = 0.0
        self.windows_green = 0

        self._lock = threading.Lock()
        self._mirror_seen = 0       # guarded-by: _lock
        self._sampled = 0           # guarded-by: _lock
        self._dropped = 0           # guarded-by: _lock
        self._ok_total = 0          # guarded-by: _lock
        self._failed_total = 0      # guarded-by: _lock
        self._window = 0            # guarded-by: _lock
        self._w_parity = 0.0        # guarded-by: _lock
        self._w_ok = 0              # guarded-by: _lock
        self._w_failed = 0          # guarded-by: _lock
        self._red_streak = 0
        self._heads_delta_cached: Optional[float] = None
        self._flip_seconds: Optional[float] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=64)
        self._worker: Optional[threading.Thread] = None
        # Test seam: called with the replica name IMMEDIATELY before
        # its flip verb is posted — the drill's mid-flip SIGKILL lands
        # here to prove the fleet converges anyway.
        self._pre_flip_hook = lambda name: None

        metrics = self.tele.metrics
        self._shadow_c = {o: metrics.counter("rollout_shadow_total",
                                             outcome=o)
                          for o in ("ok", "failed")}
        self._parity_g = metrics.gauge("rollout_shadow_parity_max")
        self._green_g = metrics.gauge("rollout_windows_green")
        self._flip_g = metrics.gauge("rollout_flip_seconds")

    # ---------------------------------------------------------- lifecycle

    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def _routable_names(self) -> List[str]:
        with self.router._lock:
            return [r.name for r in self.router.replicas if r.routable()]

    def _fleet_burn(self) -> float:
        with self.router._lock:
            burns = [r.burn_rate for r in self.router.replicas
                     if r.routable()]
        return max(burns, default=0.0)

    def start(self) -> Dict[str, Any]:
        """Load + warm the candidate on every routable replica, verify
        the arms agree on the candidate's identity, enter shadowing.
        Any replica's typed refusal (409 candidate_unfit / anything
        non-200) refuses the WHOLE rollout and unloads the others —
        a fleet that can only half-host a candidate must not shadow."""
        with self._lock:
            if self.state != "idle":
                raise RuntimeError(f"rollout already {self.state}")
            self.state = "loading"
        names = self._routable_names()
        if not names:
            self.state = "refused"
            raise RuntimeError("no routable replica to load a "
                               "candidate on")
        self.baseline_burn = self._fleet_burn()
        body: Dict[str, Any] = {"source": self.source}
        if self.hbm_budget_bytes is not None:
            body["hbm_budget_bytes"] = int(self.hbm_budget_bytes)
        loaded: List[str] = []
        fps: Dict[str, Optional[str]] = {}
        for name in names:
            status, resp = self.router.control_forward(
                name, "/v1/rollout/load", body)
            if status != 200:
                self._unload(loaded)
                self.state = "refused"
                reason = resp.decode("utf-8", "replace")[:300] \
                    if resp else f"transport failure (status {status})"
                self.tele.emit("rollout_state", state="refused",
                               source=self.source, reason=reason)
                raise RuntimeError(
                    f"replica {name} refused the candidate "
                    f"(HTTP {status}): {reason}")
            try:
                fps[name] = json.loads(resp).get("fingerprint")
            except ValueError:
                fps[name] = None
            loaded.append(name)
        distinct = set(fps.values())
        if len(distinct) != 1 or None in distinct:
            self._unload(loaded)
            self.state = "refused"
            self.tele.emit("rollout_state", state="refused",
                           source=self.source,
                           reason=f"candidate fingerprints disagree: "
                                  f"{fps}")
            raise RuntimeError(
                f"candidate fingerprints disagree across replicas: "
                f"{fps} — every arm must load the SAME trunk")
        self.candidate_fp = distinct.pop()
        self.loaded = loaded
        with self._lock:
            self.state = "shadowing"
        self.tele.emit("rollout_state", state="shadowing",
                       source=self.source,
                       fingerprint=self.candidate_fp or "",
                       windows_green=0)
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="rollout-shadow",
                                        daemon=True)
        self._worker.start()
        return self.status()

    def _unload(self, names: List[str]) -> None:
        for name in names:
            status, _ = self.router.control_forward(
                name, "/v1/rollout/unload")
            if status != 200:
                logger.warning("rollout: unload on %s answered %s",
                               name, status)

    # ------------------------------------------------------ shadow plane

    def mirror(self, path: str, raw_body: bytes, trace_id: str,
               live_resp: bytes, replica: str) -> None:
        """Router hook (sealed-200 path): sample by deterministic
        stride, enqueue, never block. Runs on live handler threads —
        everything heavier happens on the worker."""
        if self.state != "shadowing":
            return
        with self._lock:
            n = self._mirror_seen
            self._mirror_seen += 1
        if n % self.sample_every != 0:
            return
        try:
            self._queue.put_nowait(
                (path, raw_body, trace_id, live_resp, replica))
            with self._lock:
                self._sampled += 1
        except queue.Full:
            with self._lock:
                self._dropped += 1

    def _worker_loop(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=0.25)
            except queue.Empty:
                if self.terminal():
                    return
                continue
            if item is None:
                return
            try:
                self._do_shadow(*item)
            except Exception:  # noqa: BLE001 — a shadow-plane crash
                # must never take the worker (and the rollout) down.
                logger.exception("shadow replay failed")

    def _do_shadow(self, path: str, raw_body: bytes, trace_id: str,
                   live_resp: bytes, replica: str) -> None:
        status, body = self.router.shadow_forward(
            replica, path, raw_body, trace_id)
        ok = status == 200
        parity: Optional[float] = None
        if ok:
            try:
                parity = parity_delta(json.loads(live_resp),
                                      json.loads(body))
            except ValueError:
                parity = math.inf
        fields: Dict[str, Any] = {"status": int(status), "path": path}
        if parity is not None and math.isfinite(parity):
            fields["parity_max"] = round(parity, 9)
        self.tele.emit("rollout_shadow", trace_id=trace_id,
                       replica=replica,
                       outcome="ok" if ok else "failed",
                       shadow=True, **fields)
        self._shadow_c["ok" if ok else "failed"].inc()
        close = False
        with self._lock:
            if ok:
                self._ok_total += 1
                self._w_ok += 1
                if parity is not None:
                    self._w_parity = max(self._w_parity, parity)
            else:
                self._failed_total += 1
                self._w_failed += 1
            self._parity_g.set(0.0 if math.isinf(self._w_parity)
                               else self._w_parity)
            close = (self._w_ok + self._w_failed) >= self.window_requests
        if close:
            self._close_window()

    # ------------------------------------------------------------- gates

    def _heads_delta(self) -> float:
        if self.heads_eval is None:
            return 0.0
        if self._heads_delta_cached is None:
            try:
                self._heads_delta_cached = float(self.heads_eval())
            except Exception:  # noqa: BLE001 — an eval harness crash
                # must FAIL the gate (worst possible delta), not strand
                # the rollout in shadowing with windows that never
                # close their verdict.
                logger.exception("heads-eval gate crashed; scoring it "
                                 "as a failed gate")
                self._heads_delta_cached = math.inf
        return self._heads_delta_cached

    def _close_window(self) -> None:
        with self._lock:
            idx = self._window
            parity = self._w_parity
            ok_n, fail_n = self._w_ok, self._w_failed
            self._window += 1
            self._w_parity = 0.0
            self._w_ok = 0
            self._w_failed = 0
        slo_delta = self._fleet_burn() - self.baseline_burn
        heads_delta = self._heads_delta()
        checks = {
            "parity": parity <= self.shadow_parity_max,
            "slo_burn": slo_delta <= self.slo_burn_delta_max,
            "heads_eval": heads_delta <= self.heads_eval_drop_max,
            "shadow_failures": fail_n == 0,
        }
        verdict = "pass" if all(checks.values()) else "fail"
        fields: Dict[str, Any] = {
            "slo_burn_delta": round(slo_delta, 6),
            "shadow_ok": ok_n, "shadow_failed": fail_n,
        }
        if math.isfinite(heads_delta):
            fields["heads_eval_delta"] = round(heads_delta, 6)
        if math.isfinite(parity):
            fields["parity_max"] = round(parity, 9)
        self.tele.emit("rollout_window", window=idx, verdict=verdict,
                       **fields)
        if verdict == "pass":
            self.windows_green += 1
            self._red_streak = 0
            self._green_g.set(self.windows_green)
            if (self.auto_promote
                    and self.windows_green >= self.windows_required
                    and self.state == "shadowing"):
                try:
                    self.promote()
                except RuntimeError as e:
                    logger.warning("auto-promote refused: %s", e)
        else:
            self.windows_green = 0
            self._red_streak += 1
            self._green_g.set(0)
            if self._red_streak >= self.windows_required:
                failed = ",".join(k for k, v in checks.items() if not v)
                self._refuse(f"gates failed {self._red_streak} "
                             f"consecutive windows ({failed})")

    def _refuse(self, reason: str) -> None:
        with self._lock:
            if self.state != "shadowing":
                return
            self.state = "refused"
        self._unload(self.loaded)
        self.tele.emit("rollout_state", state="refused",
                       source=self.source,
                       fingerprint=self.candidate_fp or "",
                       reason=reason)

    # ----------------------------------------------------- control verbs

    def promote(self) -> Dict[str, Any]:
        """Atomic per-replica flip, gated: promotion needs the full
        green streak — promote means 'promote now that the gates
        hold', not 'skip the gates'. ≥1 landed flip promotes (a
        replica that died mid-flip converges via the health plane: it
        is dead, not mixed); zero landed flips aborts."""
        with self._lock:
            if self.state != "shadowing":
                raise RuntimeError(
                    f"cannot promote a rollout in state {self.state!r}")
            if self.windows_green < self.windows_required:
                raise RuntimeError(
                    f"gates not satisfied: {self.windows_green}/"
                    f"{self.windows_required} consecutive green windows")
            self.state = "promoting"
        self.tele.emit("rollout_state", state="promoting",
                       fingerprint=self.candidate_fp or "",
                       windows_green=self.windows_green)
        flipped: List[str] = []
        failed: List[Tuple[str, int]] = []
        worst = 0.0
        for name in list(self.loaded):
            try:
                self._pre_flip_hook(name)
            except Exception:  # noqa: BLE001 — the chaos seam must not
                # decide the flip's fate; the verb below does.
                logger.exception("pre-flip hook raised for %s", name)
            status, resp = self.router.control_forward(
                name, "/v1/rollout/flip")
            if status == 200:
                flipped.append(name)
                try:
                    worst = max(worst, float(
                        json.loads(resp).get("seconds") or 0.0))
                except ValueError:
                    pass
            else:
                failed.append((name, status))
                logger.warning("flip on %s answered %s", name, status)
        if not flipped:
            with self._lock:
                self.state = "aborted"
            self.tele.emit("rollout_state", state="aborted",
                           fingerprint=self.candidate_fp or "",
                           reason=f"flip landed nowhere: {failed}")
            raise RuntimeError(f"flip failed on every replica: {failed}")
        self.flipped = flipped
        if self.heads_eval is not None:
            refused = self.heads_eval.commit()
            for r in refused:
                logger.warning("head %s not migrated: unfrozen",
                               r["head_id"])
        # Old-trunk responses must not outlive the flip: the ROUTER's
        # cache too, not just each replica's (the replica flushes its
        # own inside Server.flip()).
        self.router.cache.clear()
        self._flip_seconds = worst
        self._flip_g.set(worst)
        with self._lock:
            self.state = "promoted"
        self.tele.emit("rollout_state", state="promoted",
                       fingerprint=self.candidate_fp or "",
                       windows_green=self.windows_green,
                       flip_seconds=round(worst, 6))
        return self.status()

    def breach(self, reason: str = "slo_breach") -> Dict[str, Any]:
        """Post-promotion gate breach: instant rollback. Every flipped
        replica re-promotes its host-parked trunk (bit-identical —
        the drill proves it against pre-rollout probes), head pins are
        restored, and both cache tiers flush again."""
        with self._lock:
            if self.state != "promoted":
                raise RuntimeError(
                    f"cannot roll back a rollout in state "
                    f"{self.state!r}")
            self.state = "rolling_back"
        failed: List[Tuple[str, int]] = []
        for name in list(self.flipped):
            status, _ = self.router.control_forward(
                name, "/v1/rollout/rollback")
            if status != 200:
                failed.append((name, status))
                logger.warning("rollback on %s answered %s", name,
                               status)
        if self.heads_eval is not None:
            self.heads_eval.restore()
        self.router.cache.clear()
        with self._lock:
            self.state = "rolled_back"
        self.tele.emit("rollout_state", state="rolled_back",
                       fingerprint=self.candidate_fp or "",
                       reason=reason)
        if failed:
            raise RuntimeError(
                f"rollback did not land everywhere: {failed} — those "
                "replicas still serve the demoted trunk (the health "
                "sweep will flag the fleet degraded)")
        return self.status()

    def abort(self) -> Dict[str, Any]:
        """Operator abort: pre-promotion this unloads the candidate
        everywhere; post-promotion it is a rollback."""
        if self.state == "promoted":
            return self.breach(reason="operator_abort")
        with self._lock:
            if self.state not in ("shadowing", "loading", "promoting"):
                raise RuntimeError(
                    f"no active rollout to abort (state "
                    f"{self.state!r})")
            self.state = "aborted"
        self._unload(self.loaded)
        self.tele.emit("rollout_state", state="aborted",
                       source=self.source,
                       fingerprint=self.candidate_fp or "",
                       reason="operator")
        return self.status()

    # ------------------------------------------------------------- status

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self.state,
                "source": self.source,
                "candidate_fingerprint": self.candidate_fp,
                "windows_green": self.windows_green,
                "windows_required": self.windows_required,
                "window": self._window,
                "mirrored": self._mirror_seen,
                "sampled": self._sampled,
                "dropped": self._dropped,
                "shadow_ok": self._ok_total,
                "shadow_failed": self._failed_total,
                "heads_eval_delta": self._heads_delta_cached,
                "flip_seconds": self._flip_seconds,
                "flipped": list(self.flipped),
                "baseline_burn": round(self.baseline_burn, 6),
                "gates": {
                    "sample_every": self.sample_every,
                    "window_requests": self.window_requests,
                    "shadow_parity_max": self.shadow_parity_max,
                    "slo_burn_delta_max": self.slo_burn_delta_max,
                    "heads_eval_drop_max": self.heads_eval_drop_max,
                    "auto_promote": self.auto_promote,
                },
            }
