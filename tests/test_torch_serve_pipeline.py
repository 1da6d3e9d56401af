"""The port's pipelined dispatch on the CPU: the JAX package's
`TestPipelinedWindow` cases (tests/test_serve.py) run against the JAX
schedulers and the port's, with the same async fake dispatcher, and
must come out the same; drain and abort with batches genuinely in flight
(a gate holds the completer) resolve every future exactly once, for the
bucketed and the packed scheduler and through the `Server`; a tiny trunk
served at pipeline_depth 2 answers bit for bit as at depth 1, bucketed
and ragged; `InFlightBatch` and the dispatchers' async entries keep the
synchronous entries' answers and timings; the launch-count recording that
credits a graph's replays. On a card, a graph replay equals the eager
run bit for bit (skipped without one)."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from proteinbert_tpu.serve import queue as jqueue
from proteinbert_tpu.serve import scheduler as jsched
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.kernels import build
from proteinbert_tpu_torch.models.proteinbert import init
from proteinbert_tpu_torch.serve import queue as tqueue
from proteinbert_tpu_torch.serve import scheduler as tsched
from proteinbert_tpu_torch.serve.dispatch import (
    KINDS, BucketDispatcher, InFlightBatch, RaggedDispatcher,
)
from proteinbert_tpu_torch.serve.errors import ServerClosedError
from proteinbert_tpu_torch.serve.server import Server

BUCKETS = (32, 64, 128)
PACKAGES = {"jax": (jqueue, jsched), "port": (tqueue, tsched)}


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class FakeDispatcher:
    """The dispatcher surface the scheduler touches; records every batch
    and echoes row indices as results (tests/test_serve.py)."""

    def __init__(self, fail_kinds=()):
        self.cfg = type("C", (), {})()
        self.cfg.model = type("M", (), {"num_annotations": 4})()
        self.cfg.data = type("D", (), {"seq_len": 64})()
        self.batches = []
        self.fail_kinds = set(fail_kinds)

    def batch_class(self, rows):
        c = 1
        while c < rows:
            c *= 2
        return c

    def run(self, kind, tokens, annotations=None):
        if kind in self.fail_kinds:
            raise RuntimeError(f"injected dispatch failure for {kind}")
        self.batches.append((kind, tokens.shape))
        return np.arange(tokens.shape[0], dtype=np.float32)


class AsyncFakeDispatcher(FakeDispatcher):
    """FakeDispatcher with the `run_timed_async` / `run_packed_timed_async`
    in-flight surface: submit records the batch and returns a handle whose
    result materializes at finalize(); an optional `finalize_gate` holds
    every finalize until set, so threaded tests pin work in flight."""

    def __init__(self, fail_kinds=(), finalize_gate=None):
        super().__init__(fail_kinds)
        self.finalized = []
        self.finalize_gate = finalize_gate

    def _handle(self, kind, shape, result):
        disp = self

        class _Handle:
            def finalize(self):
                if disp.finalize_gate is not None:
                    disp.finalize_gate.wait(10)
                disp.finalized.append((kind, shape))
                return result, {}

        return _Handle()

    def run_timed_async(self, kind, tokens, annotations=None,
                        timed=False, **extra):
        if kind in self.fail_kinds:
            raise RuntimeError(f"injected dispatch failure for {kind}")
        self.batches.append((kind, tokens.shape))
        return self._handle(kind, tokens.shape,
                            np.arange(tokens.shape[0], dtype=np.float32))

    def run_packed_timed_async(self, kind, tokens, segment_ids, annotations,
                               riders, timed=False, **extra):
        self.batches.append((kind, tokens.shape))
        return self._handle(kind, tokens.shape,
                            [float(i) for i in range(len(riders))])


def _req(pkg, kind="embed", seq="MKT", bucket_len=16, clock=None):
    queue_mod, _ = PACKAGES[pkg]
    return queue_mod.Request(kind=kind, seq=seq,
                             tokens=np.zeros(bucket_len, np.int32),
                             bucket_len=bucket_len, future=Future(),
                             enqueued_at=clock() if clock else 0.0)


def _sched(pkg, queue, dispatcher, clock, **kw):
    done = []
    s = PACKAGES[pkg][1].MicroBatchScheduler(
        queue, dispatcher, lambda req, row: done.append((req, row))
        or req.future.set_result(row), clock=clock, **kw)
    return s, done


# ------------------------------------- the JAX TestPipelinedWindow cases

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fake_clock_formation_deterministic_with_async_dispatch(pkg):
    """poll() without a completer sync-drains: formation, seal order and
    results are the blocking stub's, byte for byte."""
    results = []
    for d in (FakeDispatcher(), AsyncFakeDispatcher()):
        clock = FakeClock()
        q = PACKAGES[pkg][0].RequestQueue(max_depth=16)
        s, done = _sched(pkg, q, d, clock, max_batch=4, max_wait_s=0.5)
        for i in range(6):
            q.push(_req(pkg, seq=f"s{i}", clock=clock))
        assert s.poll() == 4
        assert len(done) == 4
        clock.advance(0.6)
        assert s.poll() == 2
        assert s.poll() == 0
        results.append(([r.seq for r, _ in done],
                        [b[1] for b in d.batches],
                        [float(r.future.result(timeout=0))
                         for r, _ in done]))
    assert results[0] == results[1]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sync_drain_never_accumulates_inflight(pkg):
    q = PACKAGES[pkg][0].RequestQueue()
    s, _ = _sched(pkg, q, AsyncFakeDispatcher(), FakeClock(), max_batch=2,
                  max_wait_s=10.0)
    for i in range(4):
        q.push(_req(pkg, seq=f"s{i}"))
    assert s.poll() == 2 and s.poll() == 2
    stats = s.pipeline_stats()
    assert stats["inflight_max"] == 1
    assert stats["finalize_seconds_total"] > 0.0
    assert set(stats) == {"depth", "inflight_max", "finalize_seconds_total",
                          "overlap_seconds_total", "overlap_ratio"}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_submit_failure_rides_window_fails_batch_keeps_scheduler(pkg):
    clock = FakeClock()
    q = PACKAGES[pkg][0].RequestQueue()
    d = AsyncFakeDispatcher(fail_kinds={"embed"})
    s, done = _sched(pkg, q, d, clock, max_batch=2, max_wait_s=10.0)
    bad = [_req(pkg, kind="embed", clock=clock) for _ in range(2)]
    for r in bad:
        q.push(r)
    assert s.poll() == 2
    for r in bad:
        with pytest.raises(RuntimeError, match="injected"):
            r.future.result(timeout=0)
    ok = [_req(pkg, kind="predict_go", clock=clock) for _ in range(2)]
    for r in ok:
        q.push(r)
    assert s.poll() == 2
    assert len(done) == 2


def _run_threaded(pkg, n_requests, finish, packed=False):
    """A real scheduler + completer with the FIRST finalize held behind a
    gate until three batches are submitted (work genuinely in flight),
    then `finish(s, q)`, release, join. Returns (scheduler, dispatcher,
    reqs, done)."""
    queue_mod, sched_mod = PACKAGES[pkg]
    gate = threading.Event()
    d = AsyncFakeDispatcher(finalize_gate=gate)
    q = queue_mod.RequestQueue(max_depth=2 * n_requests)
    done = []

    def seal(req, row):
        done.append(req)
        req.future.set_result(row)

    if packed:
        # A (rows_per_batch=1, 64) grid of 4 segments of 16: every batch
        # carries 4 requests, as the bucketed one does at max_batch 4.
        s = sched_mod.PackedBatchScheduler(
            q, d, seal, rows_per_batch=1, max_wait_s=0.005,
            max_segments=4, pipeline_depth=2)
    else:
        s = sched_mod.MicroBatchScheduler(
            q, d, seal, max_batch=4, max_wait_s=0.005, pipeline_depth=2)
    reqs = [_req(pkg, seq=f"s{i}") for i in range(n_requests)]
    for r in reqs:
        q.push(r)
    s.start()
    deadline = time.monotonic() + 5.0
    while len(d.batches) < 3 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert len(d.batches) >= 3, "scheduler never filled the window"
    finish(s, q)
    gate.set()
    assert s.join(10), "scheduler thread failed to drain"
    return s, d, reqs, done


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_drain_with_batches_in_flight_seals_exactly_once(pkg, packed):
    s, d, reqs, done = _run_threaded(pkg, 12, lambda s, q: q.close(),
                                     packed=packed)
    assert len(done) == len(reqs)
    assert len({id(r) for r in done}) == len(reqs)
    for r in reqs:
        assert r.future.done() and r.future.exception() is None
    assert len(d.finalized) == len(d.batches) == 3
    assert s.stats_counts()[:2] == (3, 12)
    assert s.pipeline_stats()["inflight_max"] == 2


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_abort_with_batch_in_flight_seals_exactly_once(pkg, packed):
    boom = ServerClosedError("aborted")
    s, d, reqs, done = _run_threaded(pkg, 16, lambda s, q: s.stop(),
                                     packed=packed)
    failed = s.fail_pending(boom)
    sealed = {id(r) for r in done}
    aborted = {id(r) for r in failed}
    assert not (sealed & aborted)
    assert len(sealed) + len(aborted) == len(reqs)
    assert len(done) == len(d.finalized) * 4
    for r in reqs:
        assert r.future.done()
        exc = r.future.exception()
        assert exc is None or exc is boom


# ----------------------------------------- the Server on a tiny trunk

@pytest.fixture(scope="module")
def trunk():
    cfg = get_preset("tiny")
    params = init(cfg.model, torch.Generator().manual_seed(4), device="cpu")
    return params, cfg


REQS = [("embed", "MKTAYIAKQR"), ("predict_go", "ACDEFGHIKLMNPQRSTVWY"),
        ("predict_residues", "MK?AYIA?QR"), ("embed", "GG"),
        ("embed", "ACDEFGHIKLMNPQRSTVWY" * 3), ("predict_go", "WWW" * 30),
        ("predict_residues", "A?" * 20), ("embed", "MKTAYIAKQRMKTAYIAKQRAC"),
        ("predict_go", "MKT"), ("embed", "W" * 100), ("embed", "QQ" * 7),
        ("predict_residues", "?MKTAYIAKQR")]


def _same(kind, a, b):
    if kind == "embed":
        return all(np.array_equal(a[k], b[k]) for k in ("global",
                                                         "local_mean"))
    if kind == "predict_go":
        return np.array_equal(a, b)
    return a[0] == b[0] and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_depth_two_answers_bit_for_bit_as_depth_one(trunk, mode):
    """Every request submitted before start(), so both depths form the
    same batches; each future sealed once; the depth-2 server runs its
    completer thread and reports its window."""
    params, cfg = trunk
    answers, pipes = {}, {}
    for depth in (2, 1):
        srv = Server(params, cfg, device="cpu", buckets=BUCKETS,
                     max_batch=4, max_wait_s=0.002, cache_size=0,
                     warm_kinds=(), serve_mode=mode, pipeline_depth=depth)
        sealed = [0] * len(REQS)
        futures = []
        for i, (kind, seq) in enumerate(REQS):
            f = srv.submit(kind, seq)
            f.add_done_callback(
                lambda f, i=i: sealed.__setitem__(i, sealed[i] + 1))
            futures.append(f)
        srv.start()
        assert (srv.scheduler._completer is not None) == (depth == 2)
        assert srv.drain(timeout=120)
        answers[depth] = [f.result(timeout=0) for f in futures]
        assert sealed == [1] * len(REQS)
        pipes[depth] = srv.stats()["pipeline"]
        assert srv.completed_total == len(REQS)
    for (kind, _), a, b in zip(REQS, answers[2], answers[1]):
        assert _same(kind, a, b), kind
    assert pipes[2]["depth"] == 2 and pipes[1]["depth"] == 1
    assert 1 <= pipes[2]["inflight_max"] <= 2
    assert pipes[1]["inflight_max"] == 1


def test_pipeline_depth_defaults_to_the_config(trunk):
    params, cfg = trunk
    srv = Server(params, cfg, device="cpu", buckets=BUCKETS, warm_kinds=())
    assert srv.pipeline_depth == cfg.serve.pipeline_depth == 2
    assert srv.scheduler.pipeline_depth == 2
    assert srv.stats()["pipeline"]["depth"] == 2


class _GatedDispatcher(BucketDispatcher):
    """The real dispatcher with every finalize held behind a gate."""

    gate: threading.Event

    def run_timed_async(self, *args, **kwargs):
        handle = super().run_timed_async(*args, **kwargs)
        gate = self.gate

        class _Held:
            def finalize(self):
                gate.wait(10)
                return handle.finalize()

        return _Held()


@pytest.mark.parametrize("how", ["drain", "abort"])
def test_server_shutdown_with_batches_in_flight(trunk, how, tmp_path):
    """Through the Server: batches held in flight when drain() or abort()
    lands each resolve exactly once — drained ones with answers, aborted
    pending ones with ServerClosedError — and the stream ends with
    serve_end of that outcome."""
    from proteinbert_tpu_torch.obs import Telemetry, read_events

    params, cfg = trunk
    tele = Telemetry(events_path=str(tmp_path / "ev.jsonl"))
    srv = Server(params, cfg, device="cpu", buckets=BUCKETS, max_batch=2,
                 max_wait_s=0.001, cache_size=0, warm_kinds=(),
                 telemetry=tele, pipeline_depth=2)
    disp = srv.dispatcher
    disp.__class__ = _GatedDispatcher
    disp.gate = threading.Event()
    sealed = []
    futures = []
    for i in range(12):
        f = srv.submit("embed", "MKTAYIAKQR"[: 3 + i % 7] + "A" * i)
        f.add_done_callback(lambda f: sealed.append(f))
        futures.append(f)
    srv.start()
    deadline = time.monotonic() + 10
    while (srv.scheduler.pipeline_stats()["inflight_max"] < 2
           and time.monotonic() < deadline):
        time.sleep(0.002)
    assert srv.scheduler.pipeline_stats()["inflight_max"] == 2
    if how == "drain":
        threading.Timer(0.05, disp.gate.set).start()
        assert srv.drain(timeout=60)
    else:
        threading.Timer(0.05, disp.gate.set).start()
        srv.abort()
    tele.close()
    assert len(sealed) == len(futures)
    assert len({id(f) for f in sealed}) == len(futures)
    outcomes = [f.exception() for f in futures]
    if how == "drain":
        assert all(e is None for e in outcomes)
    else:
        assert all(e is None or isinstance(e, ServerClosedError)
                   for e in outcomes)
        assert any(e is None for e in outcomes)  # in flight: finished
    recs = read_events(str(tmp_path / "ev.jsonl"), strict=True)
    assert recs[-1]["event"] == "serve_end"
    assert recs[-1]["outcome"] == ("drained" if how == "drain"
                                   else "aborted")
    served = [r for r in recs if r["event"] == "serve_request"]
    assert len(served) == len(futures)
    assert len({r["request_id"] for r in served}) == len(futures)


# ----------------------------------------------- dispatcher entries

def test_inflight_batch_finalize_is_idempotent():
    calls = []
    h = InFlightBatch(3, {"x": 1}, lambda: calls.append(1) or "out")
    assert h.finalize() == ("out", {"x": 1})
    assert h.finalize() == ("out", {"x": 1})
    assert calls == [1] and h.rows == 3


def test_async_entries_equal_the_sync_ones(trunk):
    params, cfg = trunk
    d = BucketDispatcher(params, cfg, buckets=BUCKETS, device="cpu")
    from proteinbert_tpu_torch import inference

    tokens = inference._tokenize_masked(["MKTAYIAKQR", "GG", "ACD"],
                                        cfg.data.seq_len)[:, :32]
    handle = d.run_timed_async("embed", tokens)
    out, timings = handle.finalize()
    sync, sync_t = d.run_timed("embed", tokens)
    for k in out:
        np.testing.assert_array_equal(out[k], sync[k])
        assert out[k].shape[0] == 3
    assert set(timings) == set(sync_t) == {"pad_fraction", "prep_s",
                                           "device_s", "finalize_s"}
    assert 0 <= timings["finalize_s"] <= timings["device_s"]
    assert handle.finalize()[0] is out
    # Nothing is captured on the CPU; warmup still runs each shape.
    assert d.executable_count == 0 and d.trunk_executable_count == 0
    assert d.graph_pool_bytes() == 0
    assert d.warmup(("embed",)) == len(BUCKETS) * len(d.batch_classes)
    assert d.executable_count == 0 and d.warmup_seconds_total > 0


def test_packed_async_entry_and_parity_shadow_run_at_finalize(trunk):
    params, cfg = trunk
    d = RaggedDispatcher(params, cfg, buckets=BUCKETS, rows_per_batch=2,
                         max_segments=4, device="cpu", quant="int8",
                         quant_parity_every=1)
    tokens, seg, ann, riders = d._dummy_packed()
    handle = d.run_packed_timed_async("embed", tokens, seg, ann, riders)
    assert "parity_samples" not in d.quant_report    # not yet: finalize
    outs, timings = handle.finalize()
    assert d.quant_report["parity_samples"] == 1
    assert timings["quant"] == "int8" and "quant_parity_max" in timings
    sync = d.run_packed("embed", tokens, seg, ann, riders)
    for a, b in zip(outs, sync):
        np.testing.assert_array_equal(a["global"], b["global"])
    with pytest.raises(NotImplementedError):
        d.run_timed_async("embed", tokens)


def test_dispatcher_metrics_feed_the_registry(trunk):
    from proteinbert_tpu_torch.obs import MetricsRegistry

    params, cfg = trunk
    reg = MetricsRegistry()
    d = BucketDispatcher(params, cfg, buckets=BUCKETS, max_batch=2,
                         device="cpu", metrics=reg)
    d.warmup(KINDS[:1])
    snap = reg.snapshot()
    assert snap["histograms"]["serve_compile_seconds"]["count"] == 6
    assert snap["gauges"]["serve_warmup_seconds_total"] > 0


# ------------------------------------------- launch counts of a replay

def test_recorded_launches_are_credited_per_replay():
    """A launch inside `recording_launches` (a graph being captured)
    counts nothing; each `credit` (a replay) adds what was recorded."""
    k = build.Kernel("probe", "local_track.cu", "probe", [])
    k._fn = lambda *args: 0
    k.launch()
    assert k.launches == 1
    with build.recording_launches() as recorded:
        k.launch()
        k.launch()
        with pytest.raises(RuntimeError, match="nest"):
            with build.recording_launches():
                pass
    assert k.launches == 1 and recorded == {k: 2}
    build.credit(recorded)
    build.credit(recorded)
    assert k.launches == 5
    k.launch()                       # recording is off again
    assert k.launches == 6

    seen = {}

    def other_thread():
        k.launch()
        seen["n"] = k.launches

    with build.recording_launches() as recorded:
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(10)
    assert recorded == {} and seen["n"] == 7   # per thread


def test_a_failed_launch_raises_and_counts_nothing():
    k = build.Kernel("probe", "local_track.cu", "probe", [])
    k._fn = lambda *args: 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        k.launch()
    with build.recording_launches() as recorded:
        with pytest.raises(RuntimeError):
            k.launch()
    assert k.launches == 0 and recorded == {}


def test_graph_replay_equals_eager_on_the_card(trunk):
    """On a CUDA card: a bucketed dispatcher's second batch of a shape
    replays the graph captured on its first, and equals the eager run bit
    for bit, with the replay's launches credited."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.models.proteinbert import to_device

    params, cfg = trunk
    dev = torch.device("cuda")
    d = BucketDispatcher(to_device(params, dev), cfg, buckets=BUCKETS,
                         device=dev)
    tokens = inference._tokenize_masked(["MKTAYIAKQR", "GG"],
                                        cfg.data.seq_len)[:, :32]
    d.run("embed", tokens)
    assert d.executable_count == 1
    before = {k: k.launches for k in KERNELS}
    got = d.run("embed", tokens)
    credited = {k.name: k.launches - before[k] for k in KERNELS}
    want = inference.run_batch(d._fn("embed", False), d.params, cfg,
                               tokens, np.zeros((2, cfg.model.num_annotations),
                                                np.float32), device=dev)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert d.executable_count == 1 and sum(credited.values()) > 0
