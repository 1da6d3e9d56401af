"""The port's map run (`proteinbert_tpu_torch.mapper`) on the CPU against
the JAX package's, on the same weights (carried through the flat export
layout) and the same corpus: every sequence's `global` and `local_mean`
within 1e-5 of the JAX store's (the JAX tests' tolerance for the store
against the offline surface, tests/test_mapper.py:493-495; float32, the
same arithmetic in another summation order), identical manifests —
`model_fingerprint` and `corpus_digest` included — and the same blocks
per shard; each package's `verify_store` reports the other's store ok
and complete, the JAX `build_index` accepts the port's store, and the JAX
`diagnose` map report reads the port's `map_*` stream. Then the port
against itself, as tests/test_mapper.py holds the JAX engine: resume
after tearing byte for byte, pipeline on = off, `stop_flag` preemption,
typed poison, non-ASCII ids, truncation, the NaN halt, retries and their
exhaustion, the manifest's pins, and the device rule."""

import os

import jax
import numpy as np
import pytest
import torch

from proteinbert_tpu import mapper as jmapper
from proteinbert_tpu.configs import (
    DataConfig as JData, ModelConfig as JModel, PretrainConfig as JCfg,
)
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.index import build_index as jbuild_index
from proteinbert_tpu.mapper.engine import run_map as jrun_map
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.obs import read_events as jread_events
from proteinbert_tpu.obs.diagnose import summarize_map
from proteinbert_tpu_torch import inference as tinf
from proteinbert_tpu_torch import obs
from proteinbert_tpu_torch.configs import DataConfig, ModelConfig, PretrainConfig
from proteinbert_tpu_torch.mapper import (
    EmbeddingStore, MapFaults, ShardCursor, StoreConfigError,
    iter_embeddings, run_map, store_digests, verify_store,
)
from proteinbert_tpu_torch.weights import params_from_flat

TOL = 1e-5
SEQ_LEN = 48
BUCKETS = (16, 32, 48)
MODEL = dict(local_dim=16, global_dim=32, key_dim=8, num_heads=2,
             num_blocks=2, num_annotations=32, dtype="float32")
ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
MAP_KW = dict(num_shards=2, block_size=4, rows_per_batch=2, max_segments=4,
              buckets=BUCKETS, stop_flag=lambda: False)
PORT_KW = dict(MAP_KW, device="cpu")


@pytest.fixture(scope="module")
def trunk():
    jcfg = JCfg(model=JModel(**MODEL), data=JData(seq_len=SEQ_LEN,
                                                   batch_size=4))
    tcfg = PretrainConfig(model=ModelConfig(**MODEL),
                          data=DataConfig(seq_len=SEQ_LEN, batch_size=4))
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list(ALPHABET), size=int(n)))
            for n in rng.integers(5, 30, size=18)]
    # One longer than the window (truncated, not poison) and one poisoned.
    seqs[5] = "".join(rng.choice(list(ALPHABET), size=SEQ_LEN + 9))
    seqs[9] = "MKT\tAV"
    return [f"p{i}" for i in range(len(seqs))], seqs


@pytest.fixture(scope="module")
def stores(trunk, corpus, tmp_path_factory):
    """The same corpus mapped by each package: (JAX store, port store,
    the port's result, its events path)."""
    jcfg, tcfg, jparams, tparams = trunk
    ids, seqs = corpus
    root = tmp_path_factory.mktemp("stores")
    jstore, tstore = str(root / "jax"), str(root / "port")
    events = str(root / "events.jsonl")
    jrun_map(jparams, jcfg, ids, seqs, jstore, **MAP_KW)
    tele = obs.Telemetry(events_path=events)
    out = run_map(tparams, tcfg, ids, seqs, tstore, telemetry=tele,
                  **PORT_KW)
    tele.close()
    return jstore, tstore, out, events


# ------------------------------------------------- the port against JAX

def test_embeddings_match_the_jax_store(stores, corpus):
    jstore, tstore, out, _ = stores
    ids, _ = corpus
    assert out["outcome"] == "completed" and out["quarantined"] == 1
    want = dict(jmapper.iter_embeddings(jstore))
    got = dict(iter_embeddings(tstore))
    assert set(got) == set(want) == set(ids) - {"p9"}
    for rid, rec in want.items():
        for key in ("global", "local_mean"):
            np.testing.assert_allclose(got[rid][key], rec[key], rtol=TOL,
                                       atol=TOL, err_msg=f"{rid} {key}")
        assert got[rid]["length"] == rec["length"]


def test_manifests_and_blocks_are_the_jax_ones(stores, trunk):
    jstore, tstore, _, _ = stores
    want = EmbeddingStore(jstore).load_manifest()
    got = EmbeddingStore(tstore).load_manifest()
    assert got == want
    from proteinbert_tpu.heads import trunk_fingerprint as jfingerprint
    assert got["model_fingerprint"] == jfingerprint(trunk[2])
    for shard in range(2):
        (js, _), (ts, _) = (ShardCursor(d, shard).load()
                            for d in (jstore, tstore))
        assert js["done"] and ts["done"]
        strip = [{k: v for k, v in b.items() if k != "digest"}
                 for b in js["blocks"]]
        assert [{k: v for k, v in b.items() if k != "digest"}
                for b in ts["blocks"]] == strip


def test_each_package_verifies_the_others_store(stores, tmp_path):
    jstore, tstore, _, _ = stores
    for rep in (jmapper.verify_store(tstore), verify_store(jstore),
                verify_store(tstore)):
        assert rep["ok"] and rep["complete"] and rep["embedded"] == 17
        assert rep["quarantined"] == 1
    stats = jbuild_index(tstore, str(tmp_path / "index"), num_centroids=4,
                         block_size=8, kmeans_iters=4)
    assert stats["outcome"] == "completed" and stats["vectors"] == 17


def test_jax_diagnose_reads_the_port_map_stream(stores):
    _, _, out, events = stores
    recs = jread_events(events, strict=True)
    kinds = {r["event"] for r in recs}
    assert {"map_start", "map_shard", "map_block", "map_end"} <= kinds
    summary = summarize_map(recs)
    assert summary["outcome"] == "completed"
    assert summary["rework_blocks"] == 0
    assert obs.read_events(events, strict=True) == recs
    assert out["batches"] > 0


# ----------------------------------------------- the port against itself

def test_resume_after_tearing_is_byte_identical(trunk, corpus, stores,
                                                tmp_path):
    _, tcfg, _, tparams = trunk
    ids, seqs = corpus
    control = stores[1]
    chaos = str(tmp_path / "chaos")
    out = run_map(tparams, tcfg, ids, seqs, chaos,
                  **dict(PORT_KW, max_blocks=3))
    assert out["outcome"] == "preempted"
    with open(ShardCursor(chaos, 0).path, "r+b") as f:
        f.truncate(30)
    s1, _ = ShardCursor(chaos, 1).load()
    tail = s1["blocks"][-1]["digest"]
    with open(EmbeddingStore(chaos).object_path(tail), "r+b") as f:
        f.truncate(12)
    out = run_map(tparams, tcfg, ids, seqs, chaos, **PORT_KW)
    assert out["outcome"] == "completed" and out["rework"] == 2
    assert store_digests(chaos) == store_digests(control)
    rep = verify_store(chaos)
    assert rep["ok"] and rep["complete"]


def test_pipeline_on_equals_off_with_overlap(trunk, corpus, stores,
                                             tmp_path):
    _, tcfg, _, tparams = trunk
    ids, seqs = corpus
    on = stores[2]
    off = run_map(tparams, tcfg, ids, seqs, str(tmp_path / "off"),
                  pipeline=False, **PORT_KW)
    assert on["pipeline"] is True and off["pipeline"] is False
    assert on["overlap_ratio"] > 0.0 and off["overlap_ratio"] == 0.0
    assert off["overlap_s"] == 0.0 and on["overlap_s"] > 0.0
    assert off["batches"] == on["batches"]
    assert store_digests(str(tmp_path / "off")) == store_digests(stores[1])


@pytest.mark.parametrize("max_blocks", [None, 1])
def test_preemption_resumes_byte_identical(trunk, corpus, stores, tmp_path,
                                           max_blocks):
    """`stop_flag` after two blocks, or `max_blocks=1` with a block in
    flight: the run commits what it started and a second run completes
    the store as the uninterrupted run wrote it."""
    _, tcfg, _, tparams = trunk
    ids, seqs = corpus
    calls = [0]

    def stop():
        calls[0] += 1
        return calls[0] > 2

    store = str(tmp_path / "store")
    kw = (dict(PORT_KW, stop_flag=stop) if max_blocks is None
          else dict(PORT_KW, max_blocks=max_blocks))
    out = run_map(tparams, tcfg, ids, seqs, store, **kw)
    assert out["outcome"] == "preempted"
    assert out["blocks"] == (2 if max_blocks is None else 1)
    out = run_map(tparams, tcfg, ids, seqs, store, **PORT_KW)
    assert out["outcome"] == "completed"
    assert verify_store(store)["complete"]
    assert store_digests(store) == store_digests(stores[1])


def test_poison_quarantined_typed_not_fatal(trunk, tmp_path):
    _, tcfg, _, tparams = trunk
    seqs = ["ACDEFGH", "", "AC DEF", 12345, "MKLVWY"]
    ids = [f"p{i}" for i in range(len(seqs))]
    out = run_map(tparams, tcfg, ids, seqs, str(tmp_path / "store"),
                  **dict(PORT_KW, num_shards=1, block_size=8))
    assert out["outcome"] == "completed"
    assert out["quarantined"] == 3 and out["seqs"] == 2
    recs = ShardCursor(str(tmp_path / "store"), 0).read_quarantine()
    assert {r["id"]: r["reason"] for r in recs} == {
        "p1": "empty", "p2": "invalid_char", "p3": "non_string"}
    rep = verify_store(str(tmp_path / "store"))
    assert rep["ok"] and rep["complete"] and rep["quarantined"] == 3


def test_non_ascii_ids_round_trip(trunk, tmp_path):
    _, tcfg, _, tparams = trunk
    ids = ["prötein/1", "βeta_2"]
    out = run_map(tparams, tcfg, ids, ["ACDEFGH", "MKLVWY"],
                  str(tmp_path / "store"),
                  **dict(PORT_KW, num_shards=1))
    assert out["outcome"] == "completed" and out["seqs"] == 2
    assert set(dict(iter_embeddings(str(tmp_path / "store")))) == set(ids)


def test_overlong_sequence_truncates_not_poison(trunk, tmp_path):
    _, tcfg, _, tparams = trunk
    before = tinf.TRUNCATED_TOTAL[0]
    out = run_map(tparams, tcfg, ["long", "ok"],
                  ["A" * (SEQ_LEN * 3), "MKLVWY"], str(tmp_path / "store"),
                  **dict(PORT_KW, num_shards=1))
    assert out["outcome"] == "completed"
    assert out["quarantined"] == 0 and out["seqs"] == 2
    assert tinf.TRUNCATED_TOTAL[0] == before + 1
    got = dict(iter_embeddings(str(tmp_path / "store")))
    assert got["long"]["length"] == SEQ_LEN


def test_nan_halts_shard_with_flight_dump(trunk, corpus, tmp_path):
    _, tcfg, _, tparams = trunk
    ids, seqs = corpus
    ev = str(tmp_path / "events.jsonl")
    tele = obs.Telemetry(events_path=ev)
    out = run_map(tparams, tcfg, ids, seqs, str(tmp_path / "store"),
                  telemetry=tele, faults=MapFaults.parse("nan=0:0"),
                  **PORT_KW)
    tele.close()
    assert out["outcome"] == "halted" and out["halted_shards"] == [0]
    assert [s for s in out["shards"] if s["shard"] == 1][0]["done"]
    halts = [r for r in obs.read_events(ev, strict=True)
             if r["event"] == "map_shard" and r["state"] == "halted"]
    assert halts and halts[0]["reason"] == "non_finite_embeddings"
    assert halts[0]["flight"] and os.path.exists(halts[0]["flight"])


def test_retries_then_exhaustion_are_typed(trunk, corpus, stores, tmp_path):
    _, tcfg, _, tparams = trunk
    ids, seqs = corpus
    out = run_map(tparams, tcfg, ids, seqs, str(tmp_path / "retried"),
                  faults=MapFaults.parse("fail=0:1:2"),
                  backoff_base_s=0.001, **PORT_KW)
    assert out["outcome"] == "completed" and out["retries"] == 2
    assert store_digests(str(tmp_path / "retried")) \
        == store_digests(stores[1])
    out = run_map(tparams, tcfg, ids, seqs, str(tmp_path / "failed"),
                  faults=MapFaults.parse("fail=0:0:99"), retry_limit=2,
                  backoff_base_s=0.001, **PORT_KW)
    assert out["outcome"] == "error" and out["failed_shards"] == [0]
    assert [s for s in out["shards"] if s["shard"] == 1][0]["done"]


def test_manifest_pins_geometry(trunk, corpus, stores):
    _, tcfg, _, tparams = trunk
    ids, seqs = corpus
    store = stores[1]
    with pytest.raises(StoreConfigError, match="block_size"):
        run_map(tparams, tcfg, ids, seqs, store,
                **dict(PORT_KW, block_size=5))
    with pytest.raises(StoreConfigError, match="corpus"):
        run_map(tparams, tcfg, ids, list(reversed(seqs)), store, **PORT_KW)
    with pytest.raises(StoreConfigError, match="buckets"):
        run_map(tparams, tcfg, ids, seqs, store,
                **dict(PORT_KW, buckets=(24, 48)))


def test_device_none_means_cuda(trunk, corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    _, tcfg, _, tparams = trunk
    ids, seqs = corpus
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_map(tparams, tcfg, ids, seqs, str(tmp_path / "store"),
                **MAP_KW)
    assert not os.path.exists(str(tmp_path / "store"))
