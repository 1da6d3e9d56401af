"""Served neighbours (`Server(index=)`, `/v1/neighbors`) of the port on the
CPU beside the JAX package's, on the same weights (carried through the
flat export layout) and the same index: a store mapped by the port,
indexed by the port's builder (the JAX builder's bytes), loaded by each
package's scorer. In both serve modes the port's served answer equals
the port's offline `lookup_one` over the same request's served embedding
exactly, and the JAX `Server`'s answer: the same corpus ids, scores
within 1e-6 (the lookups' tolerance, test_torch_index.py; the served
embeddings agree within 1e-5, test_torch_mapper.py, and move the cosine
scores by less). The default k,
the outcome funnel, the typed refusals (no index: ValueError; an index
of another trunk: TrunkMismatchError), the cache key's scope (index
digest, k, nprobe), the `neighbor_query` event and `lookup` trace stage
come where the JAX server has them, and `/v1/neighbors` answers what the
JAX handler answers for the same body (400 for an invalid `k`)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from proteinbert_tpu.configs import (
    DataConfig as JData, ModelConfig as JModel, PretrainConfig as JCfg,
)
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.index.scorer import NeighborIndex as JIndex
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.obs import read_events as jread_events
from proteinbert_tpu.serve import Server as JServer
from proteinbert_tpu.serve.http import make_http_server as jmake_http
from proteinbert_tpu.serve.server import (
    DEFAULT_NEIGHBORS_K as JDEFAULT_K,
)
from proteinbert_tpu_torch import obs
from proteinbert_tpu_torch.configs import DataConfig, ModelConfig, PretrainConfig
from proteinbert_tpu_torch.heads import TrunkMismatchError
from proteinbert_tpu_torch.index import build_index
from proteinbert_tpu_torch.index.scorer import NeighborIndex
from proteinbert_tpu_torch.mapper import run_map
from proteinbert_tpu_torch.serve.cache import content_key
from proteinbert_tpu_torch.serve.dispatch import BucketDispatcher
from proteinbert_tpu_torch.serve.http import make_http_server
from proteinbert_tpu_torch.serve.server import DEFAULT_NEIGHBORS_K, Server
from proteinbert_tpu_torch.weights import params_from_flat

TOL = 1e-6
SEQ_LEN = 48
BUCKETS = (16, 32, 48)
MODEL = dict(local_dim=16, global_dim=32, key_dim=8, num_heads=2,
             num_blocks=2, num_annotations=32, dtype="float32")
ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
QUERIES = ["MKTAYIAKQR", "GDSLAVVL", "MNNQRKKTWWYACDEFGHIKLMNPQRSTV"]
MODES = ["bucketed", "ragged"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX cfg, port cfg, JAX params, port params, JAX index, port index,
    index dir)."""
    jcfg = JCfg(model=JModel(**MODEL),
                data=JData(seq_len=SEQ_LEN, batch_size=4, buckets=BUCKETS))
    tcfg = PretrainConfig(model=ModelConfig(**MODEL),
                          data=DataConfig(seq_len=SEQ_LEN, batch_size=4,
                                          buckets=BUCKETS))
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list(ALPHABET), size=int(n)))
            for n in rng.integers(5, 44, size=48)]
    ids = [f"c{i}" for i in range(len(seqs))]
    root = tmp_path_factory.mktemp("nbr")
    run_map(tparams, tcfg, ids, seqs, str(root / "store"), num_shards=2,
            block_size=8, rows_per_batch=2, max_segments=4,
            stop_flag=lambda: False, device="cpu")
    index_dir = str(root / "index")
    build_index(str(root / "store"), index_dir, num_centroids=4,
                block_size=8, kmeans_iters=4)
    return (jcfg, tcfg, jparams, tparams, JIndex.load(index_dir),
            NeighborIndex.load(index_dir, device="cpu"), index_dir)


def _servers(setup, mode, **kw):
    jcfg, tcfg, jparams, tparams, jidx, tidx, _ = setup
    opts = dict(max_batch=4, max_wait_s=0.005, warm_kinds=(),
                serve_mode=mode, **kw)
    return (JServer(jparams, jcfg, index=jidx, **opts),
            Server(tparams, tcfg, device="cpu", index=tidx, **opts))


def _same_neighbors(want, got, tol=TOL):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=tol)


@pytest.mark.parametrize("mode", MODES)
def test_served_equals_offline_and_jax(setup, mode):
    tidx = setup[5]
    jsrv, tsrv = _servers(setup, mode, cache_size=0, nprobe=4)
    answers = []
    for srv in (jsrv, tsrv):
        nf = [srv.submit("neighbors", s, top_k=5) for s in QUERIES]
        ef = [srv.submit("embed", s) for s in QUERIES]
        srv.start()
        answers.append(([f.result(60) for f in nf],
                        [f.result(60) for f in ef]))
        assert srv.stats()["neighbors"]["by_outcome"]["ok"] == 3
        srv.drain(timeout=60)
    (jn, _), (tn, te) = answers
    for got, emb, want in zip(tn, te, jn):
        assert got["neighbors"] == tidx.lookup_one(emb["global"], k=5,
                                                   nprobe=4)
        assert len(got["neighbors"]) == 5
        _same_neighbors(want["neighbors"], got["neighbors"])


def test_dispatchers_run_neighbors_as_embed(setup):
    tcfg, tparams = setup[1], setup[3]
    disp = BucketDispatcher(tparams, tcfg, buckets=BUCKETS, max_batch=4,
                            device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(4, 26, (3, 32)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 1, 2
    got, want = disp.run("neighbors", tokens), disp.run("embed", tokens)
    assert set(got) == set(want) == {"global", "local_mean"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_default_k_and_outcome_funnel(setup):
    tidx = setup[5]
    jsrv, tsrv = _servers(setup, "ragged", cache_size=8, nprobe=2)
    stats = []
    for srv in (jsrv, tsrv):
        srv.start()
        first = srv.submit("neighbors", QUERIES[0])
        out = first.result(60)
        assert len(out["neighbors"]) == DEFAULT_NEIGHBORS_K == JDEFAULT_K
        hit = srv.submit("neighbors", QUERIES[0])
        assert hit.done() and hit.result() == out
        srv.drain(timeout=60)
        stats.append(srv.stats()["neighbors"])
    jst, tst = stats
    assert set(tst) == set(jst)
    assert tst["by_outcome"] == jst["by_outcome"]
    assert tst["by_outcome"]["ok"] == 1 and tst["by_outcome"]["cache_hit"] == 1
    assert tst["index_digest"] == jst["index_digest"] == tidx.digest
    assert tst["corpus_digest"] == jst["corpus_digest"]
    assert tst["num_vectors"] == jst["num_vectors"] == 48
    assert tst["nprobe"] == 2 and tst["lookup_executables"] >= 1


def test_no_index_is_a_typed_submit_error(setup):
    tcfg, tparams = setup[1], setup[3]
    srv = Server(tparams, tcfg, device="cpu", max_batch=2, warm_kinds=(),
                 serve_mode="ragged")
    with pytest.raises(ValueError, match="no neighbor index"):
        srv.submit("neighbors", "MKTAYIAKQR")
    assert srv.stats()["neighbors"] is None
    srv.drain(timeout=10)


def test_trunk_mismatch_refused_at_attach(setup, tmp_path):
    tcfg, tparams = setup[1], setup[3]
    other = params_from_flat(flatten_params(jmodel.init(
        jax.random.PRNGKey(1), JModel(**MODEL))), tcfg.model, device="cpu")
    with pytest.raises(TrunkMismatchError, match="rebuild"):
        Server(other, tcfg, device="cpu", max_batch=2, warm_kinds=(),
               index=setup[5])
    with pytest.raises(ValueError, match="nprobe"):
        Server(tparams, tcfg, device="cpu", index=setup[5], nprobe=0)


def test_cache_key_carries_the_index_digest_k_and_nprobe(setup):
    tidx = setup[5]
    _, srv = _servers(setup, "bucketed", cache_size=8, nprobe=3)
    srv.start()
    srv.neighbors(QUERIES[1], k=4, timeout=60)
    srv.neighbors(QUERIES[1], timeout=60)
    scope = f"neighbors:{tidx.digest[:16]}"
    for k in (4, DEFAULT_NEIGHBORS_K):
        assert srv.cache.get(content_key(f"{scope}:k{k}:p3", QUERIES[1])) \
            is not None
    for other in (f"{scope}:k4:p2", f"neighbors:{'0' * 16}:k4:p3",
                  "neighbors", "embed"):
        assert srv.cache.get(content_key(other, QUERIES[1])) is None
    fut = srv.submit("neighbors", QUERIES[1], top_k=2)   # another k: a miss
    assert len(fut.result(60)["neighbors"]) == 2
    assert srv.stats()["neighbors"]["by_outcome"]["cache_hit"] == 0
    srv.drain(timeout=60)


def test_lookup_stage_and_neighbor_query_event(setup, tmp_path):
    """The port's stream carries a sampled `neighbor_query` per served
    neighbours request and a `lookup` stage on its `serve_request`, as the
    JAX server's does; both readers take it."""
    tcfg, tparams, tidx = setup[1], setup[3], setup[5]
    path = str(tmp_path / "events.jsonl")
    tele = obs.Telemetry(events_path=path)
    srv = Server(tparams, tcfg, device="cpu", max_batch=2, warm_kinds=(),
                 index=tidx, nprobe=2, telemetry=tele,
                 trace_sample_rate=1.0).start()
    srv.neighbors(QUERIES[2], k=3, timeout=60)
    srv.drain(timeout=60)
    tele.close()
    recs = jread_events(path, strict=True)
    assert obs.read_events(path, strict=True) == recs
    (query,) = [r for r in recs if r["event"] == "neighbor_query"]
    assert (query["k"], query["nprobe"], query["outcome"]) == (3, 2, "ok")
    assert query["candidates"] == min(48, 2 * tidx.members.shape[1])
    (req,) = [r for r in recs if r["event"] == "serve_request"]
    assert req["kind"] == "neighbors" and "lookup" in req["stages"]
    assert abs(sum(req["stages"].values()) - req["e2e_s"]) < 1e-6
    start = [r for r in recs if r["event"] == "serve_start"][0]
    assert start["config"]["neighbor_index"] == tidx.digest
    assert start["config"]["nprobe"] == 2


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_neighbors_answers_as_the_jax_handler(setup):
    jsrv, tsrv = _servers(setup, "bucketed", cache_size=0, nprobe=4)
    bodies = [{"seq": QUERIES[0], "k": 5}, {"seq": QUERIES[2]},
              {"seq": QUERIES[1], "k": 0}, {"seq": QUERIES[1], "k": "3"},
              {"seq": QUERIES[1], "k": True}, {"k": 3}]
    replies = []
    for srv, make in ((jsrv, jmake_http), (tsrv, make_http_server)):
        srv.start()
        httpd = make(srv, host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/neighbors"
        try:
            replies.append([_post(url, b) for b in bodies])
            inproc = srv.neighbors(QUERIES[0], k=5, timeout=60)
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(30)
        assert replies[-1][0][1]["neighbors"] == [
            [i, s] for i, s in inproc["neighbors"]]
        srv.drain(timeout=60)
    for (js, jb), (ts, tb) in zip(*replies):
        assert ts == js
        if js == 200:
            _same_neighbors([tuple(p) for p in jb["neighbors"]],
                            [tuple(p) for p in tb["neighbors"]])
        else:
            assert js == 400 and tb["type"] == jb["type"] == "bad_request"
    assert [s for s, _ in replies[1]] == [200, 200, 400, 400, 400, 400]
    assert len(replies[1][1][1]["neighbors"]) == DEFAULT_NEIGHBORS_K
