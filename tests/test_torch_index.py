"""The port's neighbour index (`proteinbert_tpu_torch.index`) on the CPU
against the JAX package's, on stores written through the mapper's own
commit protocol: the port's `build_index` writes the JAX builder's bytes
(`index_digests`); a port `NeighborIndex` loaded from a JAX-built index
scores within 1e-6 of the JAX `lookup_rows` (float32, the same operations
in another summation order) and answers the same rows wherever a score
stands more than 1e-6 from its neighbours in the ranking — at several
(Q, nprobe, k), a full probe, k clamped to N and slots beyond the
candidate set (-inf) included — and breaks the ties of duplicated vectors
in the JAX order (lower row first). Then the JAX tests' quality gates
and typed refusals, and the device rule."""

import numpy as np
import pytest
import torch

from proteinbert_tpu.index import build_index as jbuild_index
from proteinbert_tpu.index import index_digests as jindex_digests
from proteinbert_tpu.index.scorer import NeighborIndex as JIndex
from proteinbert_tpu.parallel import quant as jquant
from proteinbert_tpu_torch.index import (
    IndexBuildError, build_index, index_digests, index_identity,
    verify_index,
)
from proteinbert_tpu_torch.index.scorer import (
    NeighborIndex, evaluate_recall, exact_topk,
    store_vectors_in_index_order,
)
from proteinbert_tpu_torch.mapper import StoreConfigError, StoreError
from proteinbert_tpu_torch.mapper.store import (
    EmbeddingStore, ShardCursor, block_digest, commit_block, corpus_digest,
    serialize_block, shard_ranges,
)
from proteinbert_tpu_torch.parallel import quant as tquant

torch.set_num_threads(1)

SCORE_TOL = 1e-6
DIM = 16
STORE_BLOCK = 8
BUILD_KW = dict(num_centroids=4, block_size=8, kmeans_iters=4)


def make_store(store_dir, n=40, seed=7, dim=DIM, fingerprint=None,
               num_shards=2, duplicates=0, done=True, quarantine=False):
    """A complete embedding store of clustered synthetic vectors (row
    2i + 1 repeats row 2i for i < `duplicates`), written through the
    commit protocol; with `quarantine` every other block quarantined its
    first record. Returns the float32 vectors in index row order."""
    rng = np.random.default_rng(seed)
    ids = [f"syn{i:05d}" for i in range(n)]
    seqs = ["A" * (10 + i % 7) for i in range(n)]
    anchors = rng.standard_normal((4, dim)).astype(np.float32)
    vecs = (anchors[rng.integers(0, 4, size=n)]
            + 0.15 * rng.standard_normal((n, dim))).astype(np.float32)
    for i in range(duplicates):
        vecs[2 * i + 1] = vecs[2 * i]
    store = EmbeddingStore(store_dir)
    fingerprint = fingerprint or "deadbeef" * 8
    store.ensure_manifest({
        "kind": "embedding_store", "corpus_n": n,
        "corpus_digest": corpus_digest(ids, seqs),
        "model_fingerprint": fingerprint,
        "num_shards": num_shards, "block_size": STORE_BLOCK,
        "rows_per_batch": 2, "max_segments": 4, "seq_len": 48,
        "buckets": [16, 32, 48],
    })
    kept = []
    for shard, (lo, hi) in enumerate(shard_ranges(n, num_shards)):
        cursor = ShardCursor(store_dir, shard)
        state = cursor.write_state(cursor.fresh_state())
        for start in range(0, hi - lo, STORE_BLOCK):
            end = min(start + STORE_BLOCK, hi - lo)
            rows = np.arange(lo + start, lo + end)
            dropped = []
            if quarantine and (start // STORE_BLOCK) % 2 == 0:
                dropped = [[ids[rows[0]], "empty"]]
                rows = rows[1:]
            kept.append(rows)
            arrays = {
                "ids": np.array([ids[i] for i in rows], dtype="S"),
                "lengths": np.array([len(seqs[i]) for i in rows],
                                    np.int32),
                "global": vecs[rows],
                "local_mean": np.zeros((len(rows), dim), np.float32),
            }
            payload = serialize_block(
                {"shard": shard, "block": start // STORE_BLOCK,
                 "start": start, "end": end,
                 "model_fingerprint": fingerprint}, arrays)
            entry = {"block": start // STORE_BLOCK,
                     "digest": block_digest(payload), "start": start,
                     "end": end, "n": len(rows), "quarantined": dropped}
            state = commit_block(store, cursor, state, payload, entry)
        if done:
            cursor.write_state(dict(state, done=True))
    return vecs[np.concatenate(kept)]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A 96-vector store indexed by the JAX builder: (JAX index, port
    index on the CPU, vectors, the JAX build stats)."""
    tmp = tmp_path_factory.mktemp("built")
    store = str(tmp / "store")
    vectors = make_store(store, n=96)
    index_dir = str(tmp / "index")
    stats = jbuild_index(store, index_dir, **BUILD_KW)
    return (JIndex.load(index_dir), NeighborIndex.load(index_dir,
                                                       device="cpu"),
            vectors, stats)


# -------------------------------------------------------- the builder

def test_quantize_rows_int8_is_the_jax_quantizer():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((33, 12)).astype(np.float32)
    x[:, 4] = 0.0      # a zero-range channel: scale 1.0
    x[0, 7] = 0.5 * 127 / 127.0
    want_c, want_s = jquant.quantize_rows_int8(x)
    got_c, got_s = tquant.quantize_rows_int8(x)
    assert got_c.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_s, want_s)
    assert got_s[4] == 1.0
    np.testing.assert_array_equal(tquant.dequantize_rows_int8(got_c, got_s),
                                  jquant.dequantize_rows_int8(want_c,
                                                              want_s))
    with pytest.raises(ValueError, match="rows, channels"):
        tquant.quantize_rows_int8(x[0])


@pytest.mark.parametrize("duplicates", [0, 6])
def test_build_writes_the_jax_builders_bytes(tmp_path, duplicates):
    store = str(tmp_path / "store")
    make_store(store, n=44, duplicates=duplicates)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jbuild_index(store, jdir, **BUILD_KW)
    got = build_index(store, tdir, **BUILD_KW)
    assert got == want
    assert index_digests(tdir) == jindex_digests(jdir)
    assert index_identity(tdir) == index_identity(jdir)
    assert verify_index(tdir)["ok"]


def test_quarantined_records_keep_the_rows_aligned(tmp_path):
    """Store blocks that quarantined records hold fewer vectors than
    their corpus spans: the port's index rows stay the store's vectors in
    order and `verify_index` passes, where the JAX builder, which locates
    rows by the corpus spans, writes blocks its own `verify_index` calls
    `shape_mismatch` (the one place the port's builder departs from the
    JAX bytes)."""
    from proteinbert_tpu.index import verify_index as jverify_index

    store = str(tmp_path / "store")
    vectors = make_store(store, n=44, quarantine=True)
    assert len(vectors) == 44 - 4 and verify_store_ok(store)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    stats = build_index(store, tdir, **BUILD_KW)
    assert stats["vectors"] == len(vectors) and verify_index(tdir)["ok"]
    index = NeighborIndex.load(tdir, device="cpu")
    np.testing.assert_array_equal(index.ids, np.array(
        [i for i, _ in _store_records(store)], dtype="S"))
    assert evaluate_recall(index, vectors, vectors, k=5,
                           nprobe=4) >= 0.95
    jbuild_index(store, jdir, **BUILD_KW)
    assert {c["reason"] for c in jverify_index(jdir)["corrupt"]} \
        == {"shape_mismatch"}


def verify_store_ok(store):
    from proteinbert_tpu_torch.mapper import verify_store

    rep = verify_store(store)
    return rep["ok"] and rep["complete"] and rep["quarantined"] == 4


def _store_records(store):
    from proteinbert_tpu_torch.mapper import iter_embeddings

    return list(iter_embeddings(store))


def test_resumed_build_is_byte_identical(tmp_path):
    store = str(tmp_path / "store")
    make_store(store)
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    build_index(store, whole, **BUILD_KW)
    first = build_index(store, parts, max_blocks=2, **BUILD_KW)
    assert first["outcome"] == "preempted"
    assert build_index(store, parts, **BUILD_KW)["outcome"] == "completed"
    assert index_digests(parts) == index_digests(whole)


def test_unfinished_store_is_refused(tmp_path):
    store = str(tmp_path / "store")
    make_store(store, done=False)
    with pytest.raises(IndexBuildError):
        build_index(store, str(tmp_path / "index"), **BUILD_KW)


# ------------------------------------------------- lookups against JAX

def _same_ranking(want_s, want_r, got_s, got_r):
    """Scores within SCORE_TOL (the same -inf slots), and the same row
    wherever a finite score stands more than SCORE_TOL from the scores
    ranked next to it."""
    assert got_s.shape == want_s.shape and got_r.shape == want_r.shape
    assert got_r.dtype == want_r.dtype
    finite = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), finite)
    np.testing.assert_allclose(got_s[finite], want_s[finite], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(got_r[~finite], want_r[~finite])
    for q in range(want_s.shape[0]):
        s = want_s[q]
        for j in range(len(s)):
            if not np.isfinite(s[j]):
                continue
            gaps = [abs(s[j] - s[i]) for i in (j - 1, j + 1)
                    if 0 <= i < len(s) and np.isfinite(s[i])]
            if all(g > SCORE_TOL for g in gaps):
                assert got_r[q, j] == want_r[q, j], (q, j)


@pytest.mark.parametrize("Q,nprobe,k", [
    (1, 1, 5), (1, 2, 10), (7, 3, 10), (12, 4, 10),   # nprobe 4 = K
    (5, 4, 500),                                       # k clamped to N
    (6, 1, 28),                                        # -inf slots
    (9, 9, 3)])                                        # nprobe clamped
def test_lookup_rows_match_jax(built, Q, nprobe, k):
    jidx, tidx, vectors, _ = built
    rng = np.random.default_rng(Q * 100 + nprobe)
    queries = np.concatenate([vectors[rng.integers(0, 96, Q // 2)],
                              rng.standard_normal((Q - Q // 2, DIM))
                              .astype(np.float32)])
    want_s, want_r = jidx.lookup_rows(queries, k=k, nprobe=nprobe)
    got_s, got_r = tidx.lookup_rows(queries, k=k, nprobe=nprobe)
    assert got_s.shape == (Q, min(k, 96))
    if (nprobe, k) == (1, 28):
        assert not np.isfinite(got_s).all()
    _same_ranking(np.asarray(want_s), np.asarray(want_r), got_s, got_r)


def test_duplicates_tie_in_the_jax_order(tmp_path):
    """Rows 2i + 1 repeat rows 2i in the same index block, so they have
    the same codes and their scores tie exactly: the rows come back in
    the JAX order, the lower row first."""
    store = str(tmp_path / "store")
    vectors = make_store(store, n=48, duplicates=6)
    index_dir = str(tmp_path / "index")
    build_index(store, index_dir, **BUILD_KW)
    jidx = JIndex.load(index_dir)
    tidx = NeighborIndex.load(index_dir, device="cpu")
    queries = vectors[0:12:2]
    for nprobe in (1, 4):
        want_s, want_r = jidx.lookup_rows(queries, k=12, nprobe=nprobe)
        got_s, got_r = tidx.lookup_rows(queries, k=12, nprobe=nprobe)
        np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=0,
                                   atol=SCORE_TOL)
        np.testing.assert_array_equal(got_r, np.asarray(want_r))
        for q in range(6):
            row = list(got_r[q])
            a, b = row.index(2 * q), row.index(2 * q + 1)
            assert b == a + 1 and got_s[q, a] == got_s[q, b]


def test_lookup_one_matches_jax(built):
    jidx, tidx, vectors, _ = built
    for row in (0, 17, 41):
        want = jidx.lookup_one(vectors[row], k=5, nprobe=2)
        got = tidx.lookup_one(vectors[row], k=5, nprobe=2)
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], rtol=0,
                                   atol=SCORE_TOL)


# ---------------------------------------------- quality and refusals

def test_quantized_recall_bound_at_full_probe(built):
    _, tidx, vectors, _ = built
    recall = evaluate_recall(tidx, vectors, vectors[::5], k=10,
                             nprobe=tidx.centroids.shape[0])
    assert recall >= 0.95


def test_lookup_rows_matches_lookup_one(built):
    _, index, vectors, _ = built
    q = vectors[3]
    K = index.centroids.shape[0]
    scores, rows = index.lookup_rows(q[None, :], k=5, nprobe=K)
    pairs = index.lookup_one(q, k=5, nprobe=K)
    assert [p[0] for p in pairs] == [index.ids[r].decode() for r in rows[0]]
    np.testing.assert_allclose([p[1] for p in pairs], scores[0], rtol=1e-6)
    got = exact_topk(vectors, vectors[:8], k=1)[:, 0]
    np.testing.assert_array_equal(got, np.arange(8))
    assert index.lookup_one(vectors[17], k=1, nprobe=K)[0][0] \
        == index.ids[17].decode()
    assert index.executables() >= 2


def test_clamp_validation(built):
    _, index, _, _ = built
    q = np.zeros(index.dim, np.float32)
    with pytest.raises(ValueError, match="k"):
        index.lookup_one(q, k=0)
    with pytest.raises(ValueError, match="nprobe"):
        index.lookup_one(q, k=1, nprobe=0)


def test_bytes_ratio_accounting(built, tmp_path):
    _, index, _, stats = built
    assert stats["index_vector_bytes"] < stats["fp32_vector_bytes"]
    assert stats["bytes_ratio"] == pytest.approx(
        stats["index_vector_bytes"] / stats["fp32_vector_bytes"], abs=1e-4)
    assert index.resident_bytes() > index.codes.nbytes


def test_load_refuses_foreign_and_incomplete_directories(tmp_path):
    with pytest.raises(StoreError):
        NeighborIndex.load(str(tmp_path / "nothing_here"), device="cpu")
    store = str(tmp_path / "store")
    make_store(store)
    with pytest.raises(StoreConfigError, match="kind"):
        NeighborIndex.load(store, device="cpu")
    index_dir = str(tmp_path / "index")
    build_index(store, index_dir, max_blocks=1, **BUILD_KW)
    with pytest.raises(StoreConfigError, match="not done"):
        NeighborIndex.load(index_dir, device="cpu")


def test_store_vectors_in_index_order(tmp_path):
    store = str(tmp_path / "store")
    vectors = make_store(store)
    np.testing.assert_array_equal(store_vectors_in_index_order(store),
                                  vectors)


def test_load_device_none_means_cuda(built, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    store = str(tmp_path / "store")
    make_store(store)
    index_dir = str(tmp_path / "index")
    build_index(store, index_dir, **BUILD_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NeighborIndex.load(index_dir)
    assert NeighborIndex.load(index_dir, device="cpu").device.type == "cpu"
