"""Service-level objectives over the serving path — a copy of
`proteinbert_tpu/obs/slo.py` whose profile trigger records with
`torch.profiler`.

Declarative objectives → windowed burn rates → breach actions:

- **`SLObjective`** — one declarative objective, parseable from a
  config dict or a `key=value,...` CLI string (`pbt serve --slo`).
  Two kinds:
  - `latency`: at least `target` of served requests must finish the
    given `stage` (default the whole request, `e2e`) within
    `threshold_s`;
  - `error_rate`: at most `1 - target` of requests may end in a
    server-caused failure (`error` / `expired` outcomes).
- **`SLOEvaluator`** — feeds on per-request completions (outcome,
  end-to-end seconds, optional per-stage attribution from a
  `RequestTrace`) and maintains, per objective, a sliding
  `window_s`-second window with its **burn rate**: the fraction of the
  error budget (`1 - target`) being consumed —
  `bad_fraction / (1 - target)`. Burn 1.0 = exactly consuming budget;
  2.0 = burning at twice the sustainable rate. Surfaced on the metrics
  registry (`slo_burn_rate{objective=}` gauges → `/metrics`),
  `Server.stats()["slo"]`, and `pbt diagnose --serve`.
- **exemplar-linked histograms** — each latency objective keeps a
  bucketed histogram of observed values where every bucket remembers
  its most recent exemplar (request id + value + time): a burn-rate
  page links straight to a traced request to blame. Violating requests
  additionally accumulate a per-stage **attribution** (queue vs
  compute vs padding waste — `pad_wasted` is `execute × pad_fraction`,
  fed by the server), so "p99 breached" comes with "…and the time went
  HERE".
- **`ProfileTrigger`** — an `on_breach` action that captures an
  on-demand device profile with `torch.profiler` (CPU and, where there
  is a card, CUDA activity; stopped by a timer thread after
  `duration_s` and written as a Chrome trace into the directory), with
  a cooldown so a sustained breach cannot fill the disk. torch is looked
  up through `sys.modules` (never imported here), so the obs package
  stays importable without it. The profiler hook (`_profiler` and the
  `_TorchTrace` it returns) is the one difference from the JAX module.

Everything takes an injected clock, so burn-rate math is exact under a
fake clock (tests/test_slo.py). Never raises into the serving path.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

SLO_KINDS = ("latency", "error_rate")

# Outcomes a LATENCY objective judges: the request was actually served
# (or should have been — errors/expiries are latency violations too).
# Admission-control outcomes (evicted/rejected/aborted) are excluded:
# they are load shedding, tracked by error_rate objectives if desired.
_LATENCY_OUTCOMES = ("ok", "cache_hit", "error", "expired")

DEFAULT_BAD_OUTCOMES = ("error", "expired")

# Default exemplar-histogram bucket upper bounds (seconds, log-spaced).
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Durations a stage-scoped latency objective may target: "e2e" plus the
# request-trace stage names (serve/trace.STAGES — tests assert the two
# stay in sync) and the synthetic padding-waste attribution the server
# derives. A typo'd stage must fail at parse time, not silently judge
# the wrong duration.
VALID_STAGES = ("e2e", "submit", "queue", "batch_form", "dispatch",
                "execute", "lookup", "finalize", "pad_wasted")


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective (see module doc)."""

    name: str
    kind: str                              # in SLO_KINDS
    target: float = 0.99                   # required good fraction
    window_s: float = 300.0
    threshold_s: Optional[float] = None    # latency only
    stage: str = "e2e"                     # latency only: which duration
    bad_outcomes: Tuple[str, ...] = DEFAULT_BAD_OUTCOMES

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(f"slo kind must be one of {SLO_KINDS}, "
                             f"got {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"slo target must be in (0, 1), got "
                             f"{self.target!r} — 1.0 leaves no error "
                             "budget to burn")
        if self.window_s <= 0:
            raise ValueError(f"slo window_s must be > 0, got "
                             f"{self.window_s!r}")
        if self.kind == "latency":
            if self.threshold_s is None or self.threshold_s <= 0:
                raise ValueError(
                    f"latency slo {self.name!r} needs threshold_s > 0 "
                    f"(or threshold_ms), got {self.threshold_s!r}")
            if self.stage not in VALID_STAGES:
                raise ValueError(
                    f"latency slo {self.name!r}: unknown stage "
                    f"{self.stage!r} (valid: {VALID_STAGES})")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def parse_slo(spec) -> SLObjective:
    """Build an objective from a dict (config) or a `key=value,...`
    string (CLI), e.g.:

        kind=latency,threshold_ms=250,target=0.99,window_s=300
        name=go_errors,kind=error_rate,target=0.999
        kind=latency,stage=execute,threshold_ms=50

    Accepted keys: name, kind, target (`0.99` or `99%`), window_s,
    threshold_s / threshold_ms, stage, bad_outcomes (`a|b`)."""
    if isinstance(spec, SLObjective):
        return spec
    if isinstance(spec, str):
        fields: Dict[str, str] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"slo spec item {part!r} is not "
                                 f"key=value (spec: {spec!r})")
            k, _, v = part.partition("=")
            fields[k.strip()] = v.strip()
        spec = fields
    if not isinstance(spec, dict):
        raise ValueError(f"slo spec must be a dict or key=value string, "
                         f"got {type(spec).__name__}")
    spec = dict(spec)
    kind = spec.pop("kind", None)
    if kind is None:
        raise ValueError("slo spec needs kind=latency or kind=error_rate")
    target = spec.pop("target", 0.99)
    if isinstance(target, str):
        target = (float(target[:-1]) / 100.0 if target.endswith("%")
                  else float(target))
    threshold_s = spec.pop("threshold_s", None)
    if "threshold_ms" in spec:
        if threshold_s is not None:
            raise ValueError("give threshold_s OR threshold_ms, not both")
        threshold_s = float(spec.pop("threshold_ms")) / 1000.0
    if threshold_s is not None:
        threshold_s = float(threshold_s)
    stage = spec.pop("stage", "e2e")
    window_s = float(spec.pop("window_s", 300.0))
    bad = spec.pop("bad_outcomes", None)
    if isinstance(bad, str):
        bad = tuple(b for b in bad.split("|") if b)
    name = spec.pop("name", None)
    if name is None:
        name = (f"{kind}_{stage}" if kind == "latency" else kind)
    if spec:
        raise ValueError(f"unknown slo spec key(s): {sorted(spec)}")
    kwargs: Dict[str, Any] = dict(name=str(name), kind=str(kind),
                                  target=float(target),
                                  window_s=window_s,
                                  threshold_s=threshold_s, stage=stage)
    if bad is not None:
        kwargs["bad_outcomes"] = tuple(bad)
    return SLObjective(**kwargs)


def parse_slos(specs: Optional[Sequence]) -> List[SLObjective]:
    objectives = [parse_slo(s) for s in (specs or [])]
    names = [o.name for o in objectives]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate slo objective name(s): "
                         f"{sorted(dupes)} — give name=... to "
                         "disambiguate")
    return objectives


class ExemplarHistogram:
    """Fixed-bucket histogram where each bucket remembers its most
    recent exemplar — the (request_id, value, t) to pull up when a
    dashboard asks "show me one of THOSE requests"."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("exemplar histogram needs >= 1 bucket bound")
        # One extra overflow bucket for values past the last bound.
        self.counts = [0] * (len(self.bounds) + 1)
        self.exemplars: List[Optional[Dict[str, Any]]] = (
            [None] * (len(self.bounds) + 1))

    def observe(self, value: float, exemplar_id: Optional[str] = None,
                t: Optional[float] = None) -> None:
        i = bisect.bisect_left(self.bounds, value)
        self.counts[i] += 1
        if exemplar_id is not None:
            self.exemplars[i] = {"request_id": exemplar_id,
                                 "value": round(float(value), 9), "t": t}

    def snapshot(self) -> List[Dict[str, Any]]:
        out = []
        for i, count in enumerate(self.counts):
            le = self.bounds[i] if i < len(self.bounds) else None  # +Inf
            out.append({"le": le, "count": count,
                        "exemplar": self.exemplars[i]})
        return out


class _ObjectiveState:
    __slots__ = ("objective", "window", "bad", "histogram",
                 "attribution", "last_breach_t", "breaches")

    def __init__(self, objective: SLObjective, buckets):
        self.objective = objective
        # (t, bad, value) — pruned past window_s on observe and read.
        self.window: "collections.deque[Tuple[float, bool, float]]" = (
            collections.deque())
        self.bad = 0
        self.histogram = (ExemplarHistogram(buckets)
                          if objective.kind == "latency" else None)
        # Per-stage seconds accumulated over VIOLATING requests only:
        # where the time of the bad tail actually went.
        self.attribution: Dict[str, float] = {}
        self.last_breach_t: Optional[float] = None
        self.breaches = 0

    def prune(self, now: float) -> None:
        horizon = now - self.objective.window_s
        w = self.window
        while w and w[0][0] <= horizon:
            _, was_bad, _ = w.popleft()
            if was_bad:
                self.bad -= 1


class SLOEvaluator:
    """Sliding-window burn-rate evaluator over per-request completions
    (see module doc). Thread-safe; observation is O(1) amortized."""

    def __init__(
        self,
        objectives: Sequence,
        metrics=None,
        telemetry=None,
        clock: Callable[[], float] = time.monotonic,
        on_breach: Optional[Callable[[str, Dict[str, Any]], None]] = None,
        breach_cooldown_s: float = 60.0,
        exemplar_buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        self.objectives = parse_slos(objectives)
        self.clock = clock
        self.on_breach = on_breach
        self.breach_cooldown_s = float(breach_cooldown_s)
        self._states = {o.name: _ObjectiveState(o, exemplar_buckets)
                        for o in self.objectives}
        self._lock = threading.Lock()
        self._tele = telemetry
        self._burn_g = {}
        if metrics is not None:
            self._burn_g = {o.name: metrics.gauge("slo_burn_rate",
                                                  objective=o.name)
                            for o in self.objectives}

    def __bool__(self) -> bool:
        return bool(self.objectives)

    # --------------------------------------------------------- feeding

    def observe(self, outcome: str, e2e_s: float,
                stages: Optional[Dict[str, float]] = None,
                request_id: Optional[str] = None,
                now: Optional[float] = None) -> None:
        """One completed request. `stages` (from a RequestTrace, may be
        None when tracing is off) powers per-stage objectives and the
        violation attribution; burn math needs only outcome + e2e."""
        if now is None:
            now = self.clock()
        breaches = []
        with self._lock:
            for name, st in self._states.items():
                o = st.objective
                if o.kind == "latency":
                    if outcome not in _LATENCY_OUTCOMES:
                        continue
                    if o.stage == "e2e":
                        value = e2e_s
                    else:
                        # A stage objective with no stage measurement
                        # (tracing off, or the request never reached
                        # that stage) SKIPS rather than silently
                        # judging e2e against a stage threshold.
                        value = (stages or {}).get(o.stage)
                        if value is None:
                            continue
                    bad = (value > o.threshold_s
                           or outcome in o.bad_outcomes)
                    if st.histogram is not None:
                        st.histogram.observe(value, request_id, now)
                else:  # error_rate
                    value = e2e_s
                    bad = outcome in o.bad_outcomes
                st.window.append((now, bad, value))
                if bad:
                    st.bad += 1
                    if stages:
                        for stage, dur in stages.items():
                            st.attribution[stage] = (
                                st.attribution.get(stage, 0.0) + dur)
                st.prune(now)
                burn = self._burn_locked(st)
                gauge = self._burn_g.get(name)
                if gauge is not None:
                    gauge.set(burn)
                if burn > 1.0 and (
                        st.last_breach_t is None
                        or now - st.last_breach_t
                        >= self.breach_cooldown_s):
                    st.last_breach_t = now
                    st.breaches += 1
                    breaches.append((name, self._status_locked(st, now)))
        # Breach actions run OUTSIDE the lock: an on_breach that blocks
        # (profile capture) must not stall concurrent observers.
        for name, status in breaches:
            if self._tele is not None:
                self._tele.emit(
                    "slo_breach", objective=name,
                    burn_rate=status["burn_rate"],
                    window_s=status["window_s"], bad=status["bad"],
                    total=status["total"],
                    bad_fraction=status["bad_fraction"],
                    attribution=status["attribution"])
            if self.on_breach is not None:
                try:
                    self.on_breach(name, status)
                except Exception:
                    logger.warning("slo on_breach action failed",
                                   exc_info=True)

    # --------------------------------------------------------- reading

    def _burn_locked(self, st: _ObjectiveState) -> float:
        total = len(st.window)
        if not total:
            return 0.0
        return (st.bad / total) / st.objective.budget

    def _status_locked(self, st: _ObjectiveState,
                       now: float) -> Dict[str, Any]:
        st.prune(now)
        o = st.objective
        total = len(st.window)
        burn = self._burn_locked(st)
        out: Dict[str, Any] = {
            "kind": o.kind, "target": o.target, "window_s": o.window_s,
            "total": total, "bad": st.bad,
            "bad_fraction": round(st.bad / total, 6) if total else 0.0,
            "burn_rate": round(burn, 6),
            "breached": burn > 1.0,
            "breaches_total": st.breaches,
            "attribution": {k: round(v, 6)
                            for k, v in sorted(st.attribution.items())},
        }
        if o.kind == "latency":
            out["threshold_s"] = o.threshold_s
            out["stage"] = o.stage
            if st.histogram is not None:
                out["histogram"] = st.histogram.snapshot()
        return out

    def burn_rate(self, name: str, now: Optional[float] = None) -> float:
        if now is None:
            now = self.clock()
        with self._lock:
            st = self._states[name]
            st.prune(now)
            return self._burn_locked(st)

    def refresh_gauges(self, now: Optional[float] = None) -> None:
        """Re-prune every window and re-set the burn gauges: called at
        scrape/stats time so an idle stream's gauge decays with the
        window instead of freezing at the last observed burn."""
        if now is None:
            now = self.clock()
        with self._lock:
            for name, st in self._states.items():
                st.prune(now)
                gauge = self._burn_g.get(name)
                if gauge is not None:
                    gauge.set(self._burn_locked(st))

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """{objective name: status dict} — the Server.stats()["slo"]
        and `pbt diagnose --serve` payload. Also refreshes the burn
        gauges (prune-at-read): stats() and /metrics agree."""
        if now is None:
            now = self.clock()
        with self._lock:
            out = {}
            for name, st in self._states.items():
                out[name] = self._status_locked(st, now)
                gauge = self._burn_g.get(name)
                if gauge is not None:
                    gauge.set(out[name]["burn_rate"])
            return out


class _TorchTrace:
    """`start_trace(directory)` / `stop_trace()` — the pair
    `jax.profiler` offers — over one `torch.profiler` capture, written
    as a Chrome trace into the directory when it stops. torch's profiler
    must stop on the thread it started on, and the trigger stops it from
    a timer thread, so the capture runs on a thread of its own."""

    def __init__(self, torch):
        self._torch = torch
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []

    def start_trace(self, directory: str) -> None:
        profiler = self._torch.profiler
        activities = [profiler.ProfilerActivity.CPU]
        if self._torch.cuda.is_available():
            activities.append(profiler.ProfilerActivity.CUDA)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"slo_profile_{os.getpid()}_{time.time_ns()}.json")
        started = threading.Event()

        def capture():
            try:
                with profiler.profile(activities=activities) as prof:
                    started.set()
                    self._stop.wait()
                prof.export_chrome_trace(path)
            except Exception as e:  # noqa: BLE001 — reported by stop/start
                self._errors.append(e)
            finally:
                started.set()

        self._stop.clear()
        self._thread = threading.Thread(target=capture,
                                        name="pbt-slo-profile", daemon=True)
        self._thread.start()
        started.wait()
        if self._errors:
            raise self._errors.pop()

    def stop_trace(self) -> None:
        self._stop.set()
        self._thread.join()
        if self._errors:
            raise self._errors.pop()


class ProfileTrigger:
    """`on_breach` action: capture a short on-demand device profile.

    Starts a `torch.profiler` capture into `directory` and stops it from
    a timer thread after `duration_s`; at most one capture per
    `cooldown_s` and never more than one in flight. All failure modes
    (torch absent, profiler already active, full disk) log and return —
    an SLO breach must never take the server down with it."""

    def __init__(self, directory: str, duration_s: float = 2.0,
                 cooldown_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic,
                 start=None, stop=None):
        self.directory = directory
        self.duration_s = float(duration_s)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._start = start
        self._stop = stop
        self._lock = threading.Lock()
        self._active = False
        self._last_t: Optional[float] = None
        self.captures: List[Dict[str, Any]] = []

    def _profiler(self):
        torch = sys.modules.get("torch")
        return None if torch is None else _TorchTrace(torch)

    def __call__(self, objective: str, status: Dict[str, Any]) -> None:
        now = self.clock()
        with self._lock:
            if self._active:
                return
            if self._last_t is not None \
                    and now - self._last_t < self.cooldown_s:
                return
            start = self._start
            stop = self._stop
            if start is None or stop is None:
                prof = self._profiler()
                if prof is None:
                    logger.info("slo breach on %r but torch is not live; "
                                "skipping device profile", objective)
                    return
                start = start or prof.start_trace
                stop = stop or prof.stop_trace
            try:
                start(self.directory)
            except Exception:
                logger.warning("slo breach profile capture failed to "
                               "start", exc_info=True)
                return
            self._active = True
            self._last_t = now
            self.captures.append({"objective": objective, "t": now,
                                  "directory": self.directory})
        logger.warning("slo breach on %r (burn %.2f): capturing %.1fs "
                       "device profile to %s", objective,
                       status.get("burn_rate", 0.0), self.duration_s,
                       self.directory)

        def _finish():
            try:
                stop()
            except Exception:
                logger.warning("slo breach profile capture failed to "
                               "stop", exc_info=True)
            finally:
                with self._lock:
                    self._active = False

        timer = threading.Timer(self.duration_s, _finish)
        timer.daemon = True
        timer.start()
