"""Self-healing serve fleet: a router in front of N port replicas — a
copy of `proteinbert_tpu/serve/fleet.py` (stdlib only) with its imports
re-pointed at the port's `serve.cache`, `obs` and `rollout`.

Each replica is an ordinary port `Server` behind `serve/http.
make_http_server` (in process or in another process; several can share
one card, each with its own graph pool and streams). `FleetRouter`

- health-checks every replica through its `/healthz` (liveness and the
  SLO burn rates of `stats()["slo"]`): `fail_threshold` failed checks in
  a row make a replica `dead`, a worst burn rate above `degrade_burn`
  makes it `degraded` (a last resort), and `readmit_threshold` good
  checks re-admit a dead one; a torn health answer is a failure;
- retries idempotent inference POSTs on connection failures and 503s,
  on the next replica with capped exponential backoff, bounded by a
  per-request `max_retries` and a fleet-wide retry budget (`floor +
  ratio·accepted`); a replica's 429 / 504 pass through unretried, and
  with no admitting replica the router sheds with its own typed 503
  (`no_capacity`);
- drains and re-admits replicas without dropping accepted work;
- keeps a content-addressed result cache keyed as the replicas' caches
  are (a neighbours answer also by `index_digest`), so a failover does
  not re-pay a warm answer;
- sweeps the replicas' trunk fingerprints (`/healthz` carries the
  resident one and `stats()["rollout"]` the candidate's): a fleet that
  serves two trunks is `degraded` (`rollout_fleet` events);
- mirrors live requests to a replica's candidate arm (`shadow_forward`,
  header `X-PBT-Shadow: 1`) for an attached `rollout.RolloutController`,
  and posts its verbs (`control_forward`, `/v1/rollout/*`).

Every accepted request seals exactly once in one of
`FLEET_REQUEST_OUTCOMES` (`fleet_requests_total{outcome=}`, a
`fleet_request` event); its id rides every attempt as `X-PBT-Trace`, and
each attempt is a `fleet_attempt` record. `FleetCollector` merges router
and replica event files into one stream; `fleet_metrics()` merges the
replicas' `/metrics.json` registries (counters summed, gauges labelled
by replica, quantile windows over the raw values). `FaultInjector`
kills replicas, adds latency and tears health answers without patching
the router.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from proteinbert_tpu_torch.serve.cache import EmbeddingCache, content_key

logger = logging.getLogger(__name__)

# Inference routes the router forwards (and caches). All are idempotent:
# the response is a pure function of the request body.
ROUTE_KINDS = {
    "/v1/embed": "embed",
    "/v1/predict_go": "predict_go",
    "/v1/predict_residues": "predict_residues",
    "/v1/predict_task": "predict_task",
    "/v1/neighbors": "neighbors",
}

# 503 = the replica is closing/draining (ServerClosedError) — the work
# never started, safe and right to retry elsewhere. 429/504 are typed
# backpressure/QoS rejections: retrying would amplify the very load
# that caused them (shed, pass through).
RETRYABLE_STATUSES = frozenset({503})
SHED_STATUSES = frozenset({429, 504})

_MAX_BODY = 32 * 1024 * 1024


class FaultInjector:
    """Drill/test hooks threaded through the router: per-replica
    injected forward latency, simulated connection kills, and torn
    health responses. Thread-safe; every default is 'no fault', so a
    router built without one pays a None check only."""

    def __init__(self):
        self._lock = threading.Lock()
        self._latency: Dict[str, float] = {}  # guarded-by: _lock
        self._dead: set = set()               # guarded-by: _lock
        self._torn_health: set = set()        # guarded-by: _lock
        self._health_latency: Dict[str, float] = {}  # guarded-by: _lock

    def set_latency(self, replica: str, seconds: float) -> None:
        with self._lock:
            if seconds > 0:
                self._latency[replica] = float(seconds)
            else:
                self._latency.pop(replica, None)

    def kill(self, replica: str) -> None:
        """Simulate a dead replica: every forward to it raises a
        connection error at the router (the real-kill path — actually
        closing the replica's socket — is the drill's job)."""
        with self._lock:
            self._dead.add(replica)

    def revive(self, replica: str) -> None:
        with self._lock:
            self._dead.discard(replica)

    def tear_health(self, replica: str, torn: bool = True) -> None:
        with self._lock:
            if torn:
                self._torn_health.add(replica)
            else:
                self._torn_health.discard(replica)

    def set_health_latency(self, replica: str, seconds: float) -> None:
        """Grey failure: the replica answers health checks, just
        SLOWLY. Distinct from tear_health (hard failure) — the drill
        uses this to prove the health loop never starves behind one
        slow replica (fleet_health_scrape_seconds bounds it)."""
        with self._lock:
            if seconds > 0:
                self._health_latency[replica] = float(seconds)
            else:
                self._health_latency.pop(replica, None)

    def forward_latency(self, replica: str) -> float:
        with self._lock:
            return self._latency.get(replica, 0.0)

    def health_latency(self, replica: str) -> float:
        with self._lock:
            return self._health_latency.get(replica, 0.0)

    def is_dead(self, replica: str) -> bool:
        with self._lock:
            return replica in self._dead

    def health_is_torn(self, replica: str) -> bool:
        with self._lock:
            return replica in self._torn_health


class Replica:
    """Router-side view of one serve replica (state guarded by the
    router's lock)."""

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        self.state = "up"  # optimistic until the first health tick
        self.consecutive_failures = 0
        self.consecutive_successes = 0
        self.inflight = 0
        self.burn_rate = 0.0
        self.requests_total = 0
        self.failures_total = 0
        self.last_health: Optional[Dict[str, Any]] = None
        # Trunk arm identity, learned from /healthz: the
        # resident trunk's fingerprint + quant mode, and the candidate
        # fingerprint while a rollout is shadowing. None until the
        # first successful health check.
        self.trunk_fp: Optional[str] = None
        self.quant: Optional[str] = None
        self.candidate_fp: Optional[str] = None

    def routable(self) -> bool:
        return self.state in ("up", "degraded")

    def status(self) -> Dict[str, Any]:
        return {"name": self.name, "url": self.url, "state": self.state,
                "inflight": self.inflight,
                "consecutive_failures": self.consecutive_failures,
                "burn_rate": round(self.burn_rate, 4),
                "requests_total": self.requests_total,
                "failures_total": self.failures_total,
                "trunk_fingerprint": self.trunk_fp,
                "quant": self.quant,
                "candidate_fingerprint": self.candidate_fp}


class FleetRouter:
    """Route, retry, shed, heal — see module docstring."""

    def __init__(
        self,
        replicas: Sequence,
        *,
        telemetry=None,
        clock=time.monotonic,
        sleep=time.sleep,
        health_interval_s: float = 0.5,
        health_timeout_s: float = 2.0,
        fail_threshold: int = 3,
        readmit_threshold: int = 2,
        degrade_burn: float = 1.0,
        max_retries: int = 2,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 1.0,
        retry_budget_ratio: float = 0.2,
        retry_budget_floor: int = 8,
        request_timeout_s: float = 30.0,
        cache_size: int = 2048,
        fault_injector: Optional[FaultInjector] = None,
        index_digest: Optional[str] = None,
        propagate_trace: bool = True,
        flight_paths: Optional[Dict[str, str]] = None,
    ):
        from proteinbert_tpu_torch.obs import as_telemetry

        self.replicas: List[Replica] = []
        for i, r in enumerate(replicas):
            if isinstance(r, Replica):
                self.replicas.append(r)
            elif isinstance(r, str):
                self.replicas.append(Replica(f"r{i}", r))
            else:
                name, url = r
                self.replicas.append(Replica(name, url))
        if not self.replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self.tele = as_telemetry(telemetry)
        self.clock = clock
        self._sleep = sleep
        self.health_interval_s = health_interval_s
        self.health_timeout_s = health_timeout_s
        self.fail_threshold = fail_threshold
        self.readmit_threshold = readmit_threshold
        self.degrade_burn = degrade_burn
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.retry_budget_ratio = retry_budget_ratio
        self.retry_budget_floor = retry_budget_floor
        self.request_timeout_s = request_timeout_s
        self.injector = fault_injector
        # Identity of the neighbor index the replicas serve (the
        # index's `digest`): it scopes cached /v1/neighbors
        # responses to the exact index contents. Without it the router
        # cannot prove two replicas hold the same index, so neighbor
        # responses are simply not cached (forwarding still works).
        self.index_digest = index_digest
        # Fleet-scope causal tracing: when on, the router's
        # request id travels to every replica attempt as X-PBT-Trace
        # (the replica's RequestTrace joins it) and each attempt emits
        # a fleet_attempt sibling record. Off measures the
        # propagation's own cost.
        self.propagate_trace = bool(propagate_trace)
        # Where each replica's flight-recorder ring will dump on crash
        # (replica name -> flight_<pid>.json path): surfaced on the
        # fleet_replica death event so a dead replica's last-N trail is
        # findable before its tmpdir vanishes.
        self.flight_paths = dict(flight_paths or {})
        self.cache = EmbeddingCache(cache_size, metrics=self.tele.metrics)
        self._lock = threading.Lock()
        self._rr = itertools.count()
        # Exactly-once seal accounting: accepted == sealed at drain is
        # the router-level invariant the drill asserts. Every touch of
        # these holds _lock.
        self.accepted_total = 0           # guarded-by: _lock
        self.sealed_total = 0             # guarded-by: _lock
        self.retries_spent = 0            # guarded-by: _lock
        self.outcomes: Dict[str, int] = {}  # guarded-by: _lock
        metrics = self.tele.metrics
        from proteinbert_tpu_torch.obs.events import FLEET_REQUEST_OUTCOMES

        self._outcome_c = {o: metrics.counter("fleet_requests_total",
                                              outcome=o)
                           for o in FLEET_REQUEST_OUTCOMES}
        self._retry_c = metrics.counter("fleet_retries_total")
        self._shed_c = metrics.counter("fleet_shed_total")
        self._up_g = {r.name: metrics.gauge("fleet_replica_up",
                                            replica=r.name)
                      for r in self.replicas}
        self._admitting_g = metrics.gauge("fleet_replicas_admitting")
        # 1.0 while routable replicas disagree on the resident trunk
        # fingerprint (mid-flip, or a flip that half-landed) — the
        # health sweep flags that fleet as degraded.
        self._fp_mixed_g = metrics.gauge("fleet_fingerprint_mixed")
        self._fleet_state = "coherent"    # guarded-by: _lock
        # Health-loop scrape latency per replica (the previously
        # unmeasured half of the health plane): one slow replica shows
        # up HERE, and the drill asserts the loop still visits every
        # other replica each sweep (no starvation).
        self._scrape_h = {r.name: metrics.histogram(
            "fleet_health_scrape_seconds", replica=r.name)
            for r in self.replicas}
        self._health_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._ended = False               # guarded-by: _lock
        self._req_ids = itertools.count(1)
        self._id_prefix = f"f{os.getpid():x}-"
        # Optional FleetCollector (attach_collector): the merged-stream
        # funnel the CLI/drill drain into one fleet JSONL.
        self.collector = None
        # Optional RolloutController (attach_rollout): owns shadow
        # mirroring + gated promotion; the router only calls its
        # mirror() hook from the sealed 200 path.
        self.rollout = None

    def attach_collector(self, collector: "FleetCollector") -> None:
        """Wire the event funnel: the router itself never tails files
        mid-flight (the merge is post-hoc), it just owns the handle so
        drain-time callers find router + replicas in one place."""
        self.collector = collector

    def attach_rollout(self, controller) -> None:
        """Wire a rollout controller's shadow mirror into the routed
        path. The hook fires AFTER the live response is sealed, so a
        slow/broken candidate can never hold a user request hostage."""
        self.rollout = controller

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "FleetRouter":
        self.tele.emit("fleet_start", pid=os.getpid(), config={
            "replicas": {r.name: r.url for r in self.replicas},
            "health_interval_s": self.health_interval_s,
            "fail_threshold": self.fail_threshold,
            "readmit_threshold": self.readmit_threshold,
            "degrade_burn": self.degrade_burn,
            "max_retries": self.max_retries,
            "backoff_base_s": self.backoff_base_s,
            "backoff_cap_s": self.backoff_cap_s,
            "retry_budget_ratio": self.retry_budget_ratio,
            "retry_budget_floor": self.retry_budget_floor,
            "cache_size": self.cache.capacity,
        })
        self._gauge_admitting()
        if self.health_interval_s > 0:
            self._health_thread = threading.Thread(
                target=self._health_loop, name="fleet-health", daemon=True)
            self._health_thread.start()
        return self

    def drain(self) -> None:
        """Stop the health loop and emit the terminal record. The HTTP
        front end is the caller's to shut down (CLI/drill order:
        httpd.shutdown() → router.drain()), so no new request can race
        the terminal stats."""
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
        # The ended latch is lock-guarded (a concurrent double-drain
        # must emit exactly one terminal record); the emit itself runs
        # OUTSIDE the lock because stats() re-acquires it.
        with self._lock:
            if self._ended:
                return
            self._ended = True
        self.tele.emit("fleet_end", outcome="drained",
                       stats=self.stats())

    # -------------------------------------------------------- health loop

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            try:
                self.health_tick()
            except Exception:  # noqa: BLE001 — a dead health loop is a
                # SILENT router regression (states frozen, crashed
                # replicas kept in rotation); log and keep ticking.
                logger.exception("fleet health tick failed; retrying "
                                 "next interval")

    def health_tick(self) -> None:
        """One health sweep over all replicas (public so tests and the
        drill can drive it deterministically without the thread)."""
        for rep in self.replicas:
            t0 = self.clock()
            payload = self._fetch_health(rep)
            self._scrape_h[rep.name].observe(max(0.0, self.clock() - t0))
            self._apply_health(rep, payload)
        self._gauge_admitting()
        self._sweep_fingerprints()

    def _sweep_fingerprints(self) -> None:
        """Flag a mixed-fingerprint fleet: routable replicas
        disagreeing on the resident trunk means a flip half-landed (or
        is mid-flight). Emits `rollout_fleet` on every state change and
        keeps the fleet_fingerprint_mixed gauge current."""
        with self._lock:
            fps = {r.trunk_fp for r in self.replicas
                   if r.routable() and r.trunk_fp}
            state = "degraded" if len(fps) > 1 else "coherent"
            changed = state != self._fleet_state
            self._fleet_state = state
        self._fp_mixed_g.set(1.0 if state == "degraded" else 0.0)
        if changed:
            self.tele.emit("rollout_fleet", state=state,
                           fingerprints=len(fps))

    def fingerprint_status(self) -> Dict[str, Any]:
        """Per-replica trunk identity + the fleet coherence verdict."""
        with self._lock:
            return {
                "fleet_state": self._fleet_state,
                "fingerprints": {r.name: r.trunk_fp for r in self.replicas},
                "candidates": {r.name: r.candidate_fp
                               for r in self.replicas
                               if r.candidate_fp},
            }

    def _fetch_health(self, rep: Replica) -> Optional[Dict[str, Any]]:
        if self.injector is not None:
            # Grey failure first: a slow replica is slow whether or not
            # it eventually answers/tears — the scrape histogram must
            # see the stall either way.
            lat = self.injector.health_latency(rep.name)
            if lat > 0:
                self._sleep(lat)
            if (self.injector.health_is_torn(rep.name)
                    or self.injector.is_dead(rep.name)):
                return None
        try:
            with urllib.request.urlopen(rep.url + "/healthz",
                                        timeout=self.health_timeout_s) as r:
                raw = r.read()
            payload = json.loads(raw)
            if not isinstance(payload, dict) or not payload.get("ok"):
                return None  # torn/garbled body == failed check
            return payload
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def _apply_health(self, rep: Replica,
                      payload: Optional[Dict[str, Any]]) -> None:
        with self._lock:
            if payload is None:
                rep.consecutive_successes = 0
                rep.consecutive_failures += 1
                if (rep.state not in ("dead", "draining")
                        and rep.consecutive_failures >= self.fail_threshold):
                    self._transition(rep, "dead",
                                     reason="health_checks_failed")
                return
            rep.last_health = payload
            rep.consecutive_failures = 0
            rep.consecutive_successes += 1
            # Trunk arm identity: /healthz carries the
            # resident fingerprint + quant at top level and the
            # candidate fingerprint under stats.rollout. Same defensive
            # posture as the burn parse — absent fields leave the
            # previous value (an old-version replica is not "mixed",
            # it is unknown).
            fp = payload.get("trunk_fingerprint")
            if isinstance(fp, str) and fp:
                rep.trunk_fp = fp
            quant = payload.get("quant")
            if isinstance(quant, str) and quant:
                rep.quant = quant
            rollout = (payload.get("stats") or {}).get("rollout")
            if isinstance(rollout, dict):
                cand = rollout.get("candidate_fingerprint")
                rep.candidate_fp = cand if isinstance(cand, str) else None
            # Defensive parse: a replica of a different version (or a
            # garbled body that still parsed) must degrade to "no burn
            # signal", never crash the health pass.
            slo = ((payload.get("stats") or {}).get("slo")) or {}
            burns = [0.0]
            if isinstance(slo, dict):
                for s in slo.values():
                    if isinstance(s, dict):
                        try:
                            burns.append(float(s.get("burn_rate") or 0.0))
                        except (TypeError, ValueError):
                            pass
            rep.burn_rate = max(burns)
            if rep.state == "draining":
                return  # operator intent wins over health
            if rep.state == "dead":
                if rep.consecutive_successes >= self.readmit_threshold:
                    self._transition(rep, "up", event_state="admitted",
                                     reason="health_recovered")
                return
            if rep.burn_rate > self.degrade_burn:
                if rep.state != "degraded":
                    self._transition(rep, "degraded", reason="slo_burn")
            elif rep.state != "up":
                self._transition(rep, "up", reason="burn_recovered")

    def _transition(self, rep: Replica, state: str,
                    event_state: Optional[str] = None,
                    reason: str = "") -> None:
        """Lock held by callers. `event_state` lets a dead→up recovery
        report as 'admitted' while storing the routable 'up'."""
        rep.state = state
        self._up_g[rep.name].set(1.0 if rep.routable() else 0.0)
        fields = {}
        if state == "dead":
            # Point the death record at the replica's flight-recorder
            # dump (when the fleet knows where it will land): the
            # last-N forensic ring outlives the replica even though its
            # tmpdir will not.
            flight = self.flight_paths.get(rep.name)
            if flight is not None:
                fields["flight"] = flight
        self.tele.emit("fleet_replica", replica=rep.name,
                       state=event_state or state, url=rep.url,
                       reason=reason,
                       consecutive_failures=rep.consecutive_failures,
                       burn_rate=round(rep.burn_rate, 4), **fields)

    def _gauge_admitting(self) -> None:
        with self._lock:
            n = sum(1 for r in self.replicas if r.routable())
        self._admitting_g.set(n)

    # ------------------------------------------------------ control plane

    def _by_name(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica {name!r}; have "
                       f"{[r.name for r in self.replicas]}")

    def drain_replica(self, name: str) -> None:
        """Operator drain: stop routing NEW work to `name`. Requests
        already forwarded keep running on the replica (its own drain
        semantics seal them); nothing accepted is dropped."""
        rep = self._by_name(name)
        with self._lock:
            if rep.state != "draining":
                self._transition(rep, "draining", reason="operator")
        self._gauge_admitting()

    def admit_replica(self, name: str) -> None:
        """Re-admit a drained (or dead) replica into the rotation."""
        rep = self._by_name(name)
        with self._lock:
            rep.consecutive_failures = 0
            rep.consecutive_successes = 0
            self._transition(rep, "up", event_state="admitted",
                             reason="operator")
        self._gauge_admitting()

    def replica_status(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.status() for r in self.replicas]

    # ----------------------------------------------------------- routing

    def _pick(self, exclude: set) -> Optional[Replica]:
        """Least-inflight admitting replica, 'up' preferred over
        'degraded', round-robin tiebreak. None when nothing routable."""
        with self._lock:
            for states in (("up",), ("degraded",)):
                cands = [r for r in self.replicas
                         if r.state in states and r.name not in exclude]
                if cands:
                    k = next(self._rr)
                    cands.sort(key=lambda r: (r.inflight, r.name))
                    low = cands[0].inflight
                    lowest = [r for r in cands if r.inflight == low]
                    return lowest[k % len(lowest)]
        return None

    def _has_candidate(self, tried: set) -> bool:
        with self._lock:
            return any(r.routable() and r.name not in tried
                       for r in self.replicas)

    def _try_spend_retry(self, retries_so_far: int) -> bool:
        """Atomically check the per-request cap AND the fleet-wide
        budget and, when allowed, spend one retry. Check-and-spend is
        ONE lock hold: a separate check would let K concurrent
        brown-out requests all observe headroom and collectively
        overshoot the budget by K-1 — during exactly the storm the
        budget exists to bound."""
        if retries_so_far >= self.max_retries:
            return False
        with self._lock:
            allowed = (self.retry_budget_floor
                       + self.retry_budget_ratio * self.accepted_total)
            if self.retries_spent >= allowed:
                return False
            self.retries_spent += 1
        self._retry_c.inc()
        return True

    def _forward(self, rep: Replica, path: str, raw_body: bytes,
                 trace_id: Optional[str] = None) -> Tuple[int, bytes]:
        """One upstream POST; raises ConnectionError-family on transport
        failure, returns (status, body) otherwise (4xx/5xx included).
        `trace_id` rides as X-PBT-Trace — the propagated fleet context
        the replica's RequestTrace joins."""
        if self.injector is not None:
            lat = self.injector.forward_latency(rep.name)
            if lat > 0:
                self._sleep(lat)
            if self.injector.is_dead(rep.name):
                raise ConnectionError(
                    f"injected kill of replica {rep.name}")
        headers = {"Content-Type": "application/json"}
        if trace_id is not None:
            headers["X-PBT-Trace"] = trace_id
        req = urllib.request.Request(
            rep.url + path, data=raw_body, headers=headers, method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            # Non-2xx WITH a response: the replica answered — a typed
            # rejection or error, not a transport failure.
            return e.code, e.read()
        # urllib.error.URLError / OSError / timeout propagate: transport
        # failure, the retry path's business.

    def shadow_forward(self, name: str, path: str, raw_body: bytes,
                       trace_id: str) -> Tuple[int, bytes]:
        """Mirror one request to `name`'s CANDIDATE arm.

        Deliberately outside every live-path ledger: no inflight or
        health bookkeeping, no cache read/write, no retry, no seal —
        a shadow is an observation, not a request. The X-PBT-Shadow
        header routes it through Server.shadow_submit on the replica;
        the trace_id ties the shadow record to its live sibling.
        Transport failures return (0, b"") rather than raising: the
        controller scores them as shadow failures."""
        rep = self._by_name(name)
        if self.injector is not None:
            if self.injector.is_dead(rep.name):
                return 0, b""
        headers = {"Content-Type": "application/json",
                   "X-PBT-Shadow": "1",
                   "X-PBT-Trace": trace_id}
        req = urllib.request.Request(
            rep.url + path, data=raw_body, headers=headers, method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (urllib.error.URLError, OSError):
            return 0, b""

    def control_forward(self, name: str, path: str,
                        body: Optional[Dict[str, Any]] = None
                        ) -> Tuple[int, bytes]:
        """POST one rollout control verb (/v1/rollout/*) to a replica.
        Control traffic never retries and never touches the request
        ledgers — a failed flip must surface, not be papered over.
        Transport failure returns (0, b"")."""
        rep = self._by_name(name)
        if self.injector is not None and self.injector.is_dead(rep.name):
            return 0, b""
        raw = json.dumps(body or {}).encode()
        req = urllib.request.Request(
            rep.url + path, data=raw,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout_s * 2) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (urllib.error.URLError, OSError):
            return 0, b""

    def _cache_key(self, kind: str, body: Any) -> Optional[str]:
        """Content address of one inference request (None = uncacheable
        body — the replica will 400 it). Excludes deadline_ms (QoS, not
        content); includes head_id and top_k (they change the result)."""
        if self.cache.capacity == 0 or not isinstance(body, dict):
            return None
        seq = body.get("seq")
        if not isinstance(seq, str) or not seq:
            return None
        ann = body.get("annotations")
        scope = kind
        if kind == "neighbors":
            # Cacheable only when the router knows WHICH index the
            # fleet serves — the digest + requested k scope the key
            # exactly like the replica-side cache does.
            if self.index_digest is None:
                return None
            scope += f":{self.index_digest[:16]}"
            if body.get("k") is not None:
                scope += f":k{body['k']}"
        if body.get("head_id") is not None:
            scope += f":{body['head_id']}"
        if body.get("top_k") is not None:
            scope += f":top{body['top_k']}"
        try:
            return content_key(scope, seq, ann)
        except (TypeError, ValueError):
            return None

    def route(self, path: str, raw_body: bytes) -> Tuple[int, bytes,
                                                         Dict[str, str]]:
        """Route one accepted inference request; returns (status, body,
        extra headers). EVERY call seals exactly once — the try/finally
        backstop turns an unexpected escape into a sealed `failed`
        rather than a lost request."""
        kind = ROUTE_KINDS[path]
        rid = f"{self._id_prefix}{next(self._req_ids):x}"
        with self._lock:
            self.accepted_total += 1
        sealed = {"done": False}

        def seal(outcome: str, status: int, replica: Optional[str],
                 retries: int) -> None:
            if sealed["done"]:
                return
            sealed["done"] = True
            with self._lock:
                self.sealed_total += 1
                self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
            self._outcome_c[outcome].inc()
            if outcome == "shed":
                self._shed_c.inc()
            # trace_id IS the router's request id (one id names the
            # request end-to-end); replica_id mirrors `replica` under
            # the uniform join key every fleet event carries.
            self.tele.emit("fleet_request", outcome=outcome, path=path,
                           replica=replica, retries=retries,
                           status=status, request_id=rid,
                           trace_id=rid, replica_id=replica)

        try:
            return self._route_sealed(kind, path, raw_body, rid, seal)
        finally:
            if not sealed["done"]:  # belt-and-braces: never lose one
                seal("failed", 500, None, 0)

    def _route_sealed(self, kind: str, path: str, raw_body: bytes,
                      rid: str, seal) -> Tuple[int, bytes, Dict[str, str]]:
        # X-PBT-Request-Id answers with the FLEET id on every response
        # the router composes itself (shed/cache_hit/failed) — the same
        # id the replica's propagated trace answers with on a forwarded
        # 200, so clients read one header regardless of who replied.
        headers = {"X-PBT-Fleet-Request-Id": rid,
                   "X-PBT-Request-Id": rid}

        def attempt(replica: str, outcome: str,
                    status: Optional[int] = None,
                    backoff_s: Optional[float] = None) -> None:
            """One sibling attempt record under this trace:
            `retries` at emit time IS the 0-based attempt index, so
            attempts on record == retries spent + 1 — the accounting
            invariant tests/test_fleet_trace.py audits."""
            if not self.propagate_trace:
                return
            fields: Dict[str, Any] = {}
            if status is not None:
                fields["status"] = status
            if backoff_s is not None:
                fields["backoff_s"] = round(backoff_s, 6)
            self.tele.emit("fleet_attempt", trace_id=rid,
                           attempt=retries, replica=replica,
                           outcome=outcome, path=path, **fields)
        try:
            body = json.loads(raw_body) if raw_body else None
        except ValueError:
            body = None
        key = self._cache_key(kind, body)
        if key is not None:
            hit = self.cache.get(key)
            if hit is not None:
                seal("cache_hit", 200, None, 0)
                headers["X-PBT-Fleet-Cache"] = "hit"
                return 200, hit, headers

        retries = 0
        tried: set = set()
        transport_failed_any = False
        while True:
            rep = self._pick(tried)
            if rep is None:
                if transport_failed_any:
                    # A candidate existed when the retry was spent but
                    # died before the pick: this is an outage reaching
                    # the client, not load shedding — label it so.
                    seal("failed", 502, None, retries)
                    return 502, json.dumps(
                        {"error": "every admitting replica became "
                                  "unreachable",
                         "type": "replica_unavailable"}).encode(), headers
                # Nothing admitting at arrival: typed shed, never a hang.
                seal("shed", 503, None, retries)
                headers["Retry-After"] = "1"
                return 503, json.dumps(
                    {"error": "no admitting replica in the fleet",
                     "type": "no_capacity"}).encode(), headers
            with self._lock:
                rep.inflight += 1
                rep.requests_total += 1
            try:
                status, resp = self._forward(
                    rep, path, raw_body,
                    rid if self.propagate_trace else None)
                transport_failure = False
            except (urllib.error.URLError, OSError) as e:
                status, resp = 502, json.dumps(
                    {"error": f"replica {rep.name} unreachable: {e}",
                     "type": "replica_unavailable"}).encode()
                transport_failure = True
            finally:
                with self._lock:
                    rep.inflight -= 1

            if transport_failure or status in RETRYABLE_STATUSES:
                transport_failed_any = transport_failed_any \
                    or transport_failure
                with self._lock:
                    rep.failures_total += 1
                    if transport_failure:
                        rep.consecutive_failures += 1
                        if (rep.state not in ("dead", "draining")
                                and rep.consecutive_failures
                                >= self.fail_threshold):
                            self._transition(rep, "dead",
                                             reason="forward_failed")
                tried.add(rep.name)
                failed_how = ("transport_failed" if transport_failure
                              else "retryable")
                # Spend a retry only when an untried candidate exists —
                # a token burned on a guaranteed no_capacity would
                # deplete the budget without buying a dispatch.
                if self._has_candidate(tried) \
                        and self._try_spend_retry(retries):
                    wait = min(self.backoff_cap_s,
                               self.backoff_base_s * (2 ** retries))
                    # The backoff rides on the attempt a retry FOLLOWED:
                    # the causal chain reads attempt(failed, waited W) →
                    # attempt(next replica).
                    attempt(rep.name, failed_how, status=status,
                            backoff_s=wait)
                    self._sleep(wait)
                    retries += 1
                    continue
                attempt(rep.name, failed_how, status=status)
                # Budget/cap/candidates exhausted: a replica 503 stays
                # a typed shed; a transport failure surfaces as 502.
                outcome = "failed" if transport_failure else "shed"
                seal(outcome, status, rep.name, retries)
                return status, resp, headers

            headers["X-PBT-Fleet-Replica"] = rep.name
            if status in SHED_STATUSES:
                attempt(rep.name, "shed", status=status)
                seal("shed", status, rep.name, retries)
                return status, resp, headers
            if status == 200:
                if key is not None:
                    self.cache.put(key, resp)
                attempt(rep.name, "ok", status=status)
                seal("retried_ok" if retries else "ok", status,
                     rep.name, retries)
                # Shadow mirror: AFTER the live request is
                # sealed — mirroring can never delay or fail a user
                # response. The controller samples/enqueues; a full
                # queue drops the mirror, never blocks here.
                ctl = self.rollout
                if ctl is not None:
                    try:
                        ctl.mirror(path, raw_body, rid, resp, rep.name)
                    except Exception:  # noqa: BLE001 — shadow plane
                        # must never break the live path.
                        logger.exception("rollout mirror hook failed")
                return status, resp, headers
            # Replica answered with a non-retryable error (400/404/500):
            # pass it through, sealed as failed.
            attempt(rep.name, "failed", status=status)
            seal("failed", status, rep.name, retries)
            return status, resp, headers

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "accepted": self.accepted_total,
                "sealed": self.sealed_total,
                "outcomes": dict(self.outcomes),
                "retries_spent": self.retries_spent,
                "fleet_state": self._fleet_state,
                "replicas": [r.status() for r in self.replicas],
            }
        out["cache"] = self.cache.stats()
        ctl = self.rollout
        if ctl is not None:
            out["rollout"] = ctl.status()
        return out

    # ------------------------------------------------------ rollout verbs

    def start_rollout(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        """Build a RolloutController from an operator spec and start it
        (shadow phase). One rollout at a time: a live controller in a
        non-terminal state refuses a second start."""
        from proteinbert_tpu_torch.rollout import RolloutController
        ctl = self.rollout
        if ctl is not None and not ctl.terminal():
            raise RuntimeError(
                f"a rollout is already {ctl.state}; abort it first "
                "(pbt rollout abort)")
        ctl = RolloutController(self, telemetry=self.tele, **spec)
        self.attach_rollout(ctl)
        return ctl.start()

    def rollout_status(self) -> Dict[str, Any]:
        ctl = self.rollout
        out = {"rollout": None if ctl is None else ctl.status()}
        out.update(self.fingerprint_status())
        return out

    def promote_rollout(self) -> Dict[str, Any]:
        ctl = self.rollout
        if ctl is None:
            raise RuntimeError("no rollout in progress")
        return ctl.promote()

    def abort_rollout(self) -> Dict[str, Any]:
        ctl = self.rollout
        if ctl is None:
            raise RuntimeError("no rollout in progress")
        return ctl.abort()

    # -------------------------------------------------- aggregation plane

    def fleet_metrics(self) -> Dict[str, Any]:
        """Scrape every replica's /metrics.json and merge into ONE
        fleet view (aggregate, then gate): counters SUMMED across
        replicas, gauges kept per-replica (a mean of queue depths hides the hot one) by
        re-labeling each key with `replica=`, histograms merged
        (count/sum added, min/max combined), and quantile windows
        merged over the CONCATENATED raw values — a fleet p99 is not
        any function of per-replica p99s. Unreachable replicas are
        skipped and listed under `missing` (a partial fleet view that
        says so beats a hang)."""
        from proteinbert_tpu_torch.obs.metrics import nearest_rank

        counters: Dict[str, float] = {}
        gauges: Dict[str, Any] = {}
        histograms: Dict[str, Dict[str, Any]] = {}
        window_vals: Dict[str, List[float]] = {}
        scraped: List[str] = []
        missing: List[str] = []
        for rep in self.replicas:
            try:
                with urllib.request.urlopen(
                        rep.url + "/metrics.json",
                        timeout=self.health_timeout_s) as r:
                    payload = json.loads(r.read())
                if not isinstance(payload, dict):
                    raise ValueError("non-dict metrics payload")
            except (urllib.error.URLError, OSError, ValueError):
                missing.append(rep.name)
                continue
            scraped.append(rep.name)
            snap = payload.get("snapshot") or {}
            for k, v in (snap.get("counters") or {}).items():
                if isinstance(v, (int, float)):
                    counters[k] = counters.get(k, 0.0) + float(v)
            for k, v in (snap.get("gauges") or {}).items():
                gauges[_label_replica(k, rep.name)] = v
            for k, h in (snap.get("histograms") or {}).items():
                if not isinstance(h, dict) or not h.get("count"):
                    continue
                m = histograms.get(k)
                if m is None:
                    m = histograms[k] = {"count": 0, "sum": 0.0,
                                         "min": None, "max": None}
                m["count"] += int(h["count"])
                m["sum"] += float(h.get("sum") or 0.0)
                for side, pick in (("min", min), ("max", max)):
                    v = h.get(side)
                    if isinstance(v, (int, float)):
                        m[side] = (float(v) if m[side] is None
                                   else pick(m[side], float(v)))
            for k, vals in (payload.get("windows") or {}).items():
                if isinstance(vals, list):
                    window_vals.setdefault(k, []).extend(
                        float(v) for v in vals
                        if isinstance(v, (int, float)))
        windows = {}
        for k, vals in window_vals.items():
            vals.sort()
            windows[k] = {
                "n": len(vals),
                "p50_s": (round(nearest_rank(vals, 0.50), 6)
                          if vals else None),
                "p99_s": (round(nearest_rank(vals, 0.99), 6)
                          if vals else None),
                "mean_s": (round(sum(vals) / len(vals), 6)
                           if vals else None),
            }
        return {"replicas": scraped, "missing": missing,
                "counters": counters, "gauges": gauges,
                "histograms": histograms, "windows": windows}


def _label_replica(key: str, replica: str) -> str:
    """Append `replica="..."` to a registry key (`name` or
    `name{l="v"}`) — how fleet_metrics keeps per-replica gauges apart
    without inventing a second key syntax."""
    name, sep, rest = key.partition("{")
    if not sep:
        return f'{name}{{replica="{replica}"}}'
    inner = rest[:-1]
    inner = f'{inner},replica="{replica}"' if inner \
        else f'replica="{replica}"'
    return f"{name}{{{inner}}}"


class FleetCollector:
    """The fleet event funnel: tails the router's and every
    replica's event JSONL into ONE merged, seq-ordered stream keyed by
    `trace_id` — the stream a diagnosis reconstructs causal
    chains from.

    Reuses `obs/events.read_events` in tolerant mode, so a replica
    SIGKILLed mid-write contributes everything up to its torn final
    line (the drill's core scenario). Each record is stamped with its
    source (`src`, `src_seq`) and a `replica_id` default (existing
    stamps win — a fleet_request's serving-replica id is never
    overwritten), then the merged stream is re-sequenced 0..N-1 so it
    passes the same monotonic-seq validation as any single stream.
    Ordering is (t, src, src_seq): wall-clock first, with per-source
    emission order as the tiebreak inside one timestamp."""

    def __init__(self, sources: Optional[Dict[str, str]] = None):
        # name -> JSONL path; insertion order is irrelevant (merge
        # sorts), uniqueness is not: one stream per name.
        self.sources: Dict[str, str] = dict(sources or {})

    def add_source(self, name: str, path: str) -> None:
        self.sources[name] = path

    def collect(self) -> List[Dict[str, Any]]:
        from proteinbert_tpu_torch.obs.events import read_events

        merged: List[Dict[str, Any]] = []
        for name in sorted(self.sources):
            path = self.sources[name]
            if not os.path.exists(path):
                continue
            for rec in read_events(path, strict=False):
                rec = dict(rec)
                rec["src"] = name
                rec["src_seq"] = rec.get("seq", 0)
                rec.setdefault("replica_id", name)
                merged.append(rec)
        merged.sort(key=lambda r: (r.get("t", 0.0), r["src"],
                                   r["src_seq"]))
        for i, rec in enumerate(merged):
            rec["seq"] = i
        return merged

    @staticmethod
    def seal_violations(records) -> Dict[str, int]:
        """trace_id -> fleet_request seal count, for every trace sealed
        != exactly once in the merged stream (empty == the exactly-once
        invariant holds fleet-wide)."""
        counts: Dict[str, int] = {}
        for rec in records:
            if rec.get("event") == "fleet_request":
                tid = rec.get("trace_id") or rec.get("request_id")
                if tid:
                    counts[tid] = counts.get(tid, 0) + 1
        return {tid: n for tid, n in counts.items() if n != 1}

    def write(self, out_path: str) -> int:
        """Collect + write the merged stream as JSONL; returns the
        record count. Plain sequential write (no append contention —
        the merge is a post-hoc pass, not a live tail)."""
        records = self.collect()
        with open(out_path, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        return len(records)


# ------------------------------------------------------------ HTTP front

def make_fleet_handler(router: FleetRouter):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Socket read timeout: bounds how long an idle keep-alive
        # connection holds its handler thread, which in turn bounds how
        # long server_close() blocks joining handlers at drain (the
        # front runs NON-daemon threads so in-flight requests seal
        # BEFORE fleet_end — make_fleet_http_server).
        timeout = 10

        def log_message(self, fmt, *args):  # telemetry covers it
            pass

        def _reply(self, status: int, payload,
                   extra: Optional[Dict[str, str]] = None) -> None:
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode())
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            if not 0 <= length <= _MAX_BODY:
                raise ValueError(f"bad Content-Length {length}")
            return self.rfile.read(length)

        def do_GET(self):
            if self.path == "/healthz":
                reps = router.replica_status()
                ok = any(r["state"] in ("up", "degraded") for r in reps)
                self._reply(200 if ok else 503,
                            {"ok": ok, "role": "fleet-router",
                             "fleet_state": router.fingerprint_status()[
                                 "fleet_state"],
                             "replicas": reps})
            elif self.path == "/fleet/status":
                self._reply(200, {"replicas": router.replica_status(),
                                  "stats": router.stats()})
            elif self.path == "/rollout/status":
                self._reply(200, router.rollout_status())
            elif self.path == "/fleet/metrics":
                # The fleet-wide merged registry view (counters summed,
                # gauges per-replica, windows percentile-merged) — the
                # autoscaler/SLO-burn scrape point.
                self._reply(200, router.fleet_metrics())
            elif self.path == "/metrics":
                text = router.tele.metrics.prometheus_text() \
                    if getattr(router.tele, "metrics", None) is not None \
                    else ""
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"no such route {self.path}"})

        def _control(self, raw: bytes, drain: bool) -> None:
            try:
                body = json.loads(raw)
            except ValueError as e:
                self._reply(400, {"error": f"bad request: {e}",
                                  "type": "bad_request"})
                return
            name = body.get("replica") if isinstance(body, dict) else None
            if not isinstance(name, str):
                self._reply(400, {"error": "'replica' must be a string",
                                  "type": "bad_request"})
                return
            try:
                if drain:
                    router.drain_replica(name)
                else:
                    router.admit_replica(name)
            except KeyError as e:
                self._reply(404, {"error": str(e),
                                  "type": "unknown_replica"})
            else:
                self._reply(200, {"ok": True,
                                  "replicas": router.replica_status()})

        def _rollout_control(self, verb: str, raw: bytes) -> None:
            """POST /rollout/start|promote|abort. Typed
            errors: a spec problem is a 400, an illegal phase (double
            start, promote with no rollout) a 409, anything else 500."""
            try:
                if verb == "start":
                    spec = json.loads(raw) if raw else {}
                    if not isinstance(spec, dict):
                        raise ValueError("rollout spec must be an object")
                    out = router.start_rollout(spec)
                elif verb == "promote":
                    out = router.promote_rollout()
                elif verb == "abort":
                    out = router.abort_rollout()
                else:
                    self._reply(404, {"error": f"no such rollout verb "
                                               f"{verb!r}"})
                    return
            except (TypeError, ValueError, KeyError) as e:
                self._reply(400, {"error": str(e), "type": "bad_request"})
            except RuntimeError as e:
                self._reply(409, {"error": str(e),
                                  "type": "rollout_conflict"})
            except Exception as e:  # noqa: BLE001 — typed 500 beats a
                # torn keep-alive connection.
                self._reply(500, {"error": f"{type(e).__name__}: {e}",
                                  "type": "internal"})
            else:
                self._reply(200, {"ok": True, **out})

        def do_POST(self):
            # Read the body BEFORE any reply: this handler speaks
            # HTTP/1.1 keep-alive, and answering an unknown route or a
            # bad request while the body bytes sit unread on the socket
            # desyncs the connection — the NEXT request would be parsed
            # starting at the leftover bytes.
            try:
                raw = self._read_body()
            except ValueError as e:
                self.close_connection = True  # body left unread
                self._reply(400, {"error": f"bad request: {e}",
                                  "type": "bad_request"})
                return
            if self.path == "/fleet/drain":
                self._control(raw, drain=True)
                return
            if self.path == "/fleet/admit":
                self._control(raw, drain=False)
                return
            if self.path.startswith("/rollout/"):
                self._rollout_control(self.path[len("/rollout/"):], raw)
                return
            if self.path not in ROUTE_KINDS:
                self._reply(404, {"error": f"no such route {self.path}"})
                return
            status, body, extra = router.route(self.path, raw)
            self._reply(status, body, extra)

    return Handler


def make_fleet_http_server(router: FleetRouter, host: str = "127.0.0.1",
                           port: int = 0) -> ThreadingHTTPServer:
    """Bind the router's HTTP front (port 0 = ephemeral; read
    `.server_address[1]`); callers run `.serve_forever()` and own
    shutdown ordering (httpd.shutdown() + server_close() BEFORE
    router.drain()).

    Handler threads are NON-daemon with block_on_close: server_close()
    joins every in-flight handler, so a request mid-route() seals
    BEFORE router.drain() emits the terminal fleet_end stats — daemon
    threads (the single-replica endpoint's choice) would let a seal
    land after the terminal record and make accepted != sealed flicker
    at shutdown. The Handler's socket timeout bounds the join: an idle
    keep-alive connection releases its thread within `timeout` s."""
    httpd = ThreadingHTTPServer((host, port), make_fleet_handler(router))
    httpd.daemon_threads = False
    httpd.block_on_close = True
    return httpd
