"""The port's serving layer on the CPU: queue, cache, dispatch routing,
scheduler formation (stub dispatcher, fake clock), and the `Server` facade
on the tiny preset — mixed requests from several threads answered exactly
as the port's `inference` answers them, the cache hit, the queue-full
error, `on_long` truncate/reject, deadlines, drain and abort."""

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from proteinbert_tpu_torch import inference
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.models.proteinbert import init
from proteinbert_tpu_torch.serve.cache import EmbeddingCache, content_key
from proteinbert_tpu_torch.serve.dispatch import (
    BucketDispatcher, default_batch_classes, resolve_buckets,
)
from proteinbert_tpu_torch.serve.errors import (
    DeadlineExceededError, QueueFullError, SequenceTooLongError,
    ServerClosedError,
)
from proteinbert_tpu_torch.serve.queue import Request, RequestQueue
from proteinbert_tpu_torch.serve.scheduler import MicroBatchScheduler
from proteinbert_tpu_torch.serve.server import Server

torch.set_num_threads(1)

BUCKETS = (32, 64, 128)
SEQS = ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWY", "GG",
        "ACDEFGHIKLMNPQRSTVWY" * 3, "MKTAYIAKQRMKTAYIAKQRAC",
        "WWW" * 30]


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def trunk():
    cfg = get_preset("tiny")
    params = init(cfg.model, torch.Generator().manual_seed(4), device="cpu")
    return params, cfg


def _server(trunk, **kw):
    params, cfg = trunk
    kw = {"buckets": BUCKETS, "warm_kinds": (), "device": "cpu", **kw}
    return Server(params, cfg, **kw)


# ----------------------------------------------------- queue + cache

def _req(kind="embed", L=16, t=0.0, deadline=None):
    return Request(kind=kind, seq="M" * (L - 2),
                   tokens=np.zeros(L, np.int32), bucket_len=L,
                   future=Future(), enqueued_at=t, deadline=deadline)


def test_queue_overflow_evicts_oldest_and_closes():
    q = RequestQueue(max_depth=2)
    a, b, c = _req(), _req(), _req()
    q.push(a)
    q.push(b)
    assert q.push(c) == [a]
    with pytest.raises(QueueFullError):
        a.future.result(timeout=0)
    assert q.pop_all() == [b, c] and q.evicted_total == 1
    q.close()
    with pytest.raises(ServerClosedError):
        q.push(_req())


def test_cache_lru_and_content_keys():
    cache = EmbeddingCache(capacity=2)
    k1, k2, k3 = (content_key("embed", s) for s in ("A", "B", "C"))
    assert content_key("embed", "A") == k1 != content_key("predict_go", "A")
    assert content_key("embed", "A", np.zeros(3)) != k1
    cache.put(k1, 1)
    cache.put(k2, 2)
    assert cache.get(k1) == 1          # k1 most recent now
    cache.put(k3, 3)                   # evicts k2
    assert cache.get(k2) is None
    assert cache.stats()["evictions"] == 1 and cache.hits == 1
    off = EmbeddingCache(capacity=0)
    off.put(k1, 1)
    assert off.get(k1) is None


# ------------------------------------------------------ dispatch routing

def test_bucket_and_class_routing(trunk):
    params, cfg = trunk
    assert resolve_buckets(cfg) == (cfg.data.seq_len,)
    with pytest.raises(ValueError, match="ascending"):
        resolve_buckets(cfg, (64, 32, 128))
    with pytest.raises(ValueError, match="seq_len"):
        resolve_buckets(cfg, (32, 64))
    assert default_batch_classes(8) == (1, 2, 4, 8)
    assert default_batch_classes(12) == (1, 2, 4, 8, 12)
    d = BucketDispatcher(params, cfg, buckets=BUCKETS, device="cpu")
    assert d.bucket_len(10) == 32 and d.bucket_len(30) == 32
    assert d.bucket_len(31) == 64 and d.bucket_len(1000) == 128
    assert d.batch_class(3) == 4
    with pytest.raises(ValueError, match="exceed"):
        d.batch_class(9)


def test_run_timed_pads_to_the_class_and_trims(trunk):
    params, cfg = trunk
    d = BucketDispatcher(params, cfg, buckets=BUCKETS, device="cpu")
    tokens = inference._tokenize_masked(["MKTAYIAKQR", "GG", "ACD"],
                                        cfg.data.seq_len)[:, :32]
    out, timings = d.run_timed("predict_go", tokens)
    assert out.shape == (3, cfg.model.num_annotations)
    # 3 rows ride the 4-row class: 1 - 21 real tokens / (4 x 32).
    assert timings["pad_fraction"] == pytest.approx(1 - 21 / 128)
    assert timings["prep_s"] >= 0 and timings["device_s"] > 0
    np.testing.assert_array_equal(out, d.run("predict_go", tokens))
    with pytest.raises(ValueError, match="buckets"):
        d.run("embed", tokens[:, :30])


# --------------------------------------------- scheduler (stub dispatcher)

class StubDispatcher:
    def __init__(self, cfg, fail=False):
        self.cfg = cfg
        self.fail = fail
        self.batches = []

    def run(self, kind, tokens, annotations):
        self.batches.append((kind, tokens.shape))
        if self.fail:
            raise RuntimeError("device fell over")
        return {"global": np.zeros((len(tokens), 2), np.float32)}


def _sched(cfg, **kw):
    q = RequestQueue(64)
    d = StubDispatcher(cfg, fail=kw.pop("fail", False))
    done = []
    clock = FakeClock()
    s = MicroBatchScheduler(q, d, lambda r, row: done.append(r),
                            clock=clock, **kw)
    return q, d, s, done, clock


def test_full_group_dispatches_and_underfull_waits(trunk):
    _, cfg = trunk
    q, d, s, done, clock = _sched(cfg, max_batch=2, max_wait_s=1.0)
    for _ in range(3):
        q.push(_req(t=clock()))
    assert s.poll() == 2               # full group goes at once
    assert s.poll() == 0               # the third waits for max_wait
    clock.advance(1.0)
    assert s.poll() == 1
    assert len(done) == 3 and s.stats_counts()[:2] == (2, 3)


def test_groups_split_by_kind_and_bucket(trunk):
    _, cfg = trunk
    q, d, s, done, clock = _sched(cfg, max_batch=8, max_wait_s=0.0)
    for kind, L in (("embed", 16), ("embed", 32), ("predict_go", 16),
                    ("embed", 16)):
        q.push(_req(kind, L, t=clock()))
    while s.poll():
        pass
    assert sorted(d.batches) == [("embed", (1, 32)), ("embed", (2, 16)),
                                 ("predict_go", (1, 16))]


def test_deadline_expiry_and_failed_batches(trunk):
    _, cfg = trunk
    q, d, s, done, clock = _sched(cfg, max_batch=8, max_wait_s=5.0,
                                  fail=True)
    late = _req(t=clock(), deadline=clock() + 0.5)
    ok = _req(t=clock())
    q.push(late)
    q.push(ok)
    clock.advance(1.0)
    assert s.poll() == 0
    with pytest.raises(DeadlineExceededError):
        late.future.result(timeout=0)
    clock.advance(5.0)
    assert s.poll() == 1               # dispatch raises: batch fails...
    with pytest.raises(RuntimeError, match="fell over"):
        ok.future.result(timeout=0)
    assert s.stats_counts()[2] == 1    # ...and the scheduler lives on


# ----------------------------------------------------------- e2e Server

def test_served_batch_equals_offline_inference(trunk):
    params, cfg = trunk
    srv = _server(trunk, max_batch=4, max_wait_s=60.0, cache_size=0)
    seqs = ["MKTAYIAKQR", "GG", "ACDEF", "MKT"]
    futures = [srv.submit("embed", s) for s in seqs]
    assert srv.scheduler.poll() == 4   # one batch, formed by hand
    offline = inference.embed(params, cfg, seqs, bucketed=True,
                              buckets=BUCKETS, batch_size=4, device="cpu")
    for i, f in enumerate(futures):
        row = f.result(timeout=0)
        np.testing.assert_array_equal(row["global"], offline["global"][i])
        np.testing.assert_array_equal(row["local_mean"],
                                      offline["local_mean"][i])


def test_mixed_concurrent_requests_match_inference(trunk):
    params, cfg = trunk
    kinds = ("embed", "predict_go", "predict_residues")
    reqs = [(kinds[i % 3], SEQS[i % len(SEQS)] if i % 3 != 2
             else "MK?AYIA?QR" + "A" * i) for i in range(18)]
    results = {}
    with _server(trunk, max_batch=4, max_wait_s=0.002, cache_size=0) as srv:
        def client(idx):
            for i in idx:
                results[i] = srv.submit(*reqs[i]).result(timeout=60)

        threads = [threading.Thread(target=client, args=(range(j, 18, 3),))
                   for j in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    assert len(results) == 18 and srv.completed_total == 18
    for i, (kind, seq) in enumerate(reqs):
        if kind == "embed":
            want = inference.embed(params, cfg, [seq], bucketed=True,
                                   buckets=BUCKETS, batch_size=1,
                                   device="cpu")
            for k in want:
                np.testing.assert_allclose(results[i][k], want[k][0],
                                           rtol=1e-6, atol=1e-6)
        elif kind == "predict_go":
            want = inference.predict_go(params, cfg, [seq], bucketed=True,
                                        buckets=BUCKETS, batch_size=1,
                                        device="cpu")
            np.testing.assert_allclose(results[i], want[0], rtol=1e-6,
                                       atol=1e-6)
        else:
            filled, probs = inference.predict_residues(
                params, cfg, [seq], bucketed=True, buckets=BUCKETS,
                batch_size=1, device="cpu")
            L = srv.dispatcher.bucket_len(len(seq))
            assert results[i][0] == filled[0] and "?" not in filled[0]
            np.testing.assert_allclose(results[i][1], probs[0, :L],
                                       rtol=1e-6, atol=1e-6)
    assert srv.stats()["latency"]["n"] == 18


def test_cache_short_circuits_repeats(trunk):
    with _server(trunk, max_batch=2, max_wait_s=0.002, cache_size=8) as srv:
        first = srv.embed("MKTAYIAKQR", timeout=30)
        again = srv.embed("MKTAYIAKQR", timeout=30)
        top = srv.predict_go("MKTAYIAKQR", top_k=2, timeout=30)
        assert len(top) == 2 and top[0][1] >= top[1][1]
    assert srv.cache_hit_returns == 1 and srv.cache.hits == 1
    np.testing.assert_array_equal(first["global"], again["global"])
    assert srv.stats()["batches"] == 2


def test_queue_full_then_abort(trunk):
    srv = _server(trunk, max_batch=4, max_wait_s=60.0, queue_depth=2,
                  cache_size=0)
    futures = [srv.submit("embed", s) for s in ("MKT", "ACD", "GGG")]
    with pytest.raises(QueueFullError):
        futures[0].result(timeout=0)       # oldest evicted, not dropped
    assert srv.rejected_total["queue_full"] == 1
    srv.abort()
    for f in futures[1:]:
        with pytest.raises(ServerClosedError):
            f.result(timeout=5)


def test_on_long_reject_and_truncate(trunk):
    _, cfg = trunk
    window = cfg.data.seq_len - 2
    rej = _server(trunk, on_long="reject", cache_size=0)
    with pytest.raises(SequenceTooLongError):
        rej.submit("embed", "A" * (window + 10))
    assert rej.rejected_total["too_long"] == 1
    with _server(trunk, on_long="truncate", max_batch=1, max_wait_s=0.002,
                 cache_size=0) as tr:
        out = tr.embed("A" * (window + 10), timeout=30)
        assert tr.truncated_total == 1 and np.isfinite(out["global"]).all()
        # A '?' beyond the window can never be filled: reject even here.
        with pytest.raises(SequenceTooLongError):
            tr.submit("predict_residues", "A" * window + "?")


def test_deadline_expiry_e2e(trunk):
    clock = FakeClock()
    srv = _server(trunk, max_batch=8, max_wait_s=60.0, cache_size=0,
                  clock=clock)
    f = srv.submit("embed", "MKT", deadline_s=0.5)
    clock.advance(1.0)
    assert srv.scheduler.poll() == 0
    with pytest.raises(DeadlineExceededError):
        f.result(timeout=0)
    assert srv.stats()["rejected"]["deadline"] == 1


def test_drain_completes_queued_work_then_refuses(trunk):
    srv = _server(trunk, max_batch=8, max_wait_s=60.0, cache_size=0)
    srv.start()
    futures = [srv.submit("embed", s) for s in SEQS]
    assert srv.drain(timeout=60)
    for f in futures:
        assert np.isfinite(f.result(timeout=0)["global"]).all()
    assert srv.completed_total == len(SEQS)
    with pytest.raises(ServerClosedError):
        srv.submit("embed", "MKT")
    assert srv.rejected_total["closed"] == 1
