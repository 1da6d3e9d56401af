"""The port's corpus feed on the CPU against the JAX package's on the same
files: `HDF5PretrainingDataset` (fixture files in the reference schema,
each over more than one 1024-row block, with rows longer than seq_len)
and `make_bucketed_iterator` yield exactly the JAX batches — tokens,
annotations, order and bucket lengths — across epochs, with crop_seed,
skip_batches and two hosts, with the same dropped-row count, pad gauge
and ValueErrors; `PrefetchIterator` gives the same stream, re-raises a
producer's error, counts its wait and batches and `close()` ends its
thread; and `pretrain(device="cpu")` on a bucketed, prefetched stream
logs `data_wait_s`."""

import threading
import time

import h5py
import numpy as np
import pytest
import torch

from proteinbert_tpu.data import dataset as jds
from proteinbert_tpu.data import prefetch as jprefetch
from proteinbert_tpu.obs.metrics import MetricsRegistry as JRegistry
from proteinbert_tpu_torch.configs import (
    DataConfig, ModelConfig, OptimizerConfig, PretrainConfig, TrainConfig,
)
from proteinbert_tpu_torch.data import dataset as tds
from proteinbert_tpu_torch.data.prefetch import PrefetchIterator, prefetch
from proteinbert_tpu_torch.data.vocab import ALPHABET
from proteinbert_tpu_torch.obs import Telemetry, read_events
from proteinbert_tpu_torch.obs.metrics import MetricsRegistry
from proteinbert_tpu_torch.train.trainer import pretrain

torch.set_num_threads(1)

SEQ_LEN = 64
BUCKETS = (16, 32, 64)
N_ROWS = 2300          # three 1024-row blocks, the last partial
A = 24


def write_corpus(path, n, seed):
    """An HDF5 corpus in the reference schema: `seqs` (strings),
    `seq_lengths`, `annotation_masks` (n, A) bool, `included_annotations`,
    `uniprot_ids`. Lengths 1-120, so some rows exceed seq_len - 2."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.geometric(1 / 25, n), 120)
    seqs = ["".join(rng.choice(list(ALPHABET), size=int(L)))
            for L in lengths]
    str_dt = h5py.string_dtype()
    with h5py.File(path, "w") as f:
        f.create_dataset("included_annotations", dtype=str_dt,
                         data=np.array([f"GO:{i:07d}".encode()
                                        for i in range(A)], dtype=object))
        f.create_dataset("uniprot_ids", dtype=str_dt,
                         data=np.array([f"P{i}".encode() for i in range(n)],
                                       dtype=object))
        f.create_dataset("seqs", dtype=str_dt, chunks=(512,),
                         data=np.array(seqs, dtype=object))
        f.create_dataset("seq_lengths", data=lengths.astype(np.int32))
        f.create_dataset("annotation_masks", data=rng.random((n, A)) < 0.1)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("h5") / "c.h5"),
                        N_ROWS, 0)


def _pair(path, crop_seed=None, cache_blocks=8):
    return (jds.HDF5PretrainingDataset(path, SEQ_LEN, cache_blocks,
                                       crop_seed),
            tds.HDF5PretrainingDataset(path, SEQ_LEN, cache_blocks,
                                       crop_seed))


def _same_stream(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes(), k
    return len(a)


@pytest.mark.parametrize("crop_seed", [None, 11])
def test_hdf5_dataset_rows_match_jax(corpus, crop_seed):
    jd, td = _pair(corpus, crop_seed, cache_blocks=2)
    try:
        assert len(td) == len(jd) == N_ROWS
        assert td.num_annotations == jd.num_annotations == A
        assert td.shuffle_block == jd.shuffle_block == 1024
        np.testing.assert_array_equal(td.row_lengths(), jd.row_lengths())
        assert td.row_lengths().max() == SEQ_LEN
        rng = np.random.default_rng(4)
        for epoch in (0, 1, 2):
            # Rows across all three blocks, more than the two cached.
            idx = rng.choice(N_ROWS, 40, replace=False)
            _same_stream([jd.get_batch(idx, epoch=epoch)],
                         [td.get_batch(idx, epoch=epoch)])
        for i in (0, 1023, 1024, N_ROWS - 1):
            _same_stream([jd[i], jd.get_row(i, epoch=1)],
                         [td[i], td.get_row(i, epoch=1)])
        with pytest.raises(IndexError):
            td[N_ROWS]
    finally:
        jd.close()
        td.close()


@pytest.mark.parametrize("case", [
    dict(),
    dict(crop_seed=3),
    dict(skip_batches=7),
    dict(process_count=2, process_index=0),
    dict(process_count=2, process_index=1, crop_seed=3, skip_batches=2),
    dict(shuffle=False),
], ids=["plain", "crop", "skip", "host0", "host1", "no-shuffle"])
def test_bucketed_iterator_matches_jax(corpus, case):
    """Three epochs (the remainders carried across them), batch 8."""
    case = dict(case)
    jd, td = _pair(corpus, case.pop("crop_seed", None))
    kw = dict(batch_size=8, buckets=BUCKETS, seed=5, num_epochs=3, **case)
    try:
        n = _same_stream(jds.make_bucketed_iterator(jd, **kw),
                         tds.make_bucketed_iterator(td, **kw))
        lens = {b["tokens"].shape[1]
                for b in tds.make_bucketed_iterator(td, **kw)}
        assert lens == set(BUCKETS) and n > 100
    finally:
        jd.close()
        td.close()


def test_in_memory_subset_and_bucketed_metrics_match_jax(corpus):
    """An in-memory dataset (and a Subset of it) through the bucketed
    iterator, with the metrics registries: the dropped-row counter and the
    last pad gauge equal JAX's."""
    with h5py.File(corpus, "r") as f:
        seqs = [s.decode() for s in f["seqs"][:600]]
        ann = f["annotation_masks"][:600]
    jmem = jds.InMemoryPretrainingDataset(seqs, ann, SEQ_LEN, crop_seed=2)
    tmem = tds.InMemoryPretrainingDataset(seqs, ann, SEQ_LEN, crop_seed=2)
    _same_stream([jmem[5], jmem.get_row(7, epoch=3)],
                 [tmem[5], tmem.get_row(7, epoch=3)])
    jsub, _ = jds.train_eval_split(jmem, 0.25, seed=1)
    tsub, _ = tds.train_eval_split(tmem, 0.25, seed=1)
    _same_stream([jsub[3], jsub.get_row(4, epoch=2)],
                 [tsub[3], tsub.get_row(4, epoch=2)])
    for jset, tset in ((jmem, tmem), (jsub, tsub)):
        jreg, treg = JRegistry(), MetricsRegistry()
        kw = dict(batch_size=8, buckets=BUCKETS, seed=1, num_epochs=2)
        _same_stream(jds.make_bucketed_iterator(jset, metrics=jreg, **kw),
                     tds.make_bucketed_iterator(tset, metrics=treg, **kw))
        js, ts = jreg.snapshot(), treg.snapshot()
        drop = 'data_dropped_rows_total{strategy="bucketed"}'
        pad = 'data_pad_fraction{strategy="bucketed"}'
        assert ts["counters"][drop] == js["counters"][drop] > 0
        assert ts["gauges"][pad] == js["gauges"][pad]


@pytest.mark.parametrize("buckets,kw", [
    ("512,1024", {}),
    ((16, 32), {}),
    ((16, "x", 64), {}),
    (BUCKETS, {"batch_size": 4000}),
])
def test_bucketed_iterator_errors_match_jax(corpus, buckets, kw):
    jd, td = _pair(corpus)
    args = {"batch_size": 8, "buckets": buckets, **kw}
    try:
        with pytest.raises(ValueError) as jerr:
            next(jds.make_bucketed_iterator(jd, **args))
        with pytest.raises(ValueError) as terr:
            next(tds.make_bucketed_iterator(td, **args))
        assert str(terr.value) == str(jerr.value)
    finally:
        jd.close()
        td.close()


# ------------------------------------------------------------- prefetch

def test_prefetch_gives_the_same_stream_and_counts(corpus):
    jd, td = _pair(corpus, crop_seed=1)
    kw = dict(batch_size=8, buckets=BUCKETS, seed=2, num_epochs=1)
    try:
        it = prefetch(tds.make_bucketed_iterator(td, **kw), depth=2)
        n = _same_stream(jds.make_bucketed_iterator(jd, **kw), it)
        assert it.batches == n and it.wait_s >= 0.0
        with pytest.raises(StopIteration):
            next(it)
    finally:
        jd.close()
        td.close()


def _slow(n, delay):
    for i in range(n):
        time.sleep(delay)
        yield i


def test_prefetch_wait_is_the_consumers_blocked_time():
    it = PrefetchIterator(_slow(3, 0.05), depth=1)
    assert list(it) == [0, 1, 2]
    assert it.batches == 3 and it.wait_s >= 0.1
    jit = jprefetch.PrefetchIterator(_slow(3, 0.05), depth=1)
    assert list(jit) == [0, 1, 2] and jit.wait_s >= 0.1
    with pytest.raises(ValueError, match="depth must be >= 1"):
        PrefetchIterator(iter(()), depth=0)


def test_prefetch_reraises_the_producers_error():
    def broken():
        yield 1
        raise KeyError("corrupt block")

    it = PrefetchIterator(broken(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="corrupt block") as err:
        next(it)
    # The producer's own frame is on the traceback.
    assert "broken" in [tb.name for tb in err.traceback]
    with pytest.raises(StopIteration):
        next(it)


def test_close_ends_the_producer_thread():
    before = set(threading.enumerate())
    it = PrefetchIterator(_slow(10_000, 0.0), depth=2)
    assert next(it) == 0
    (thread,) = set(threading.enumerate()) - before
    it.close()
    thread.join(5)
    assert not thread.is_alive()
    # What was queued before close() (at most `depth` batches) still
    # comes out, in order; then the stream ends.
    rest = list(it)
    assert len(rest) <= 2 and rest == list(range(1, 1 + len(rest)))


# ----------------------------------------------------------- pretrain

def test_pretrain_on_a_bucketed_prefetched_corpus_logs_data_wait(
        tmp_path, corpus):
    cfg = PretrainConfig(
        model=ModelConfig(local_dim=16, global_dim=32, key_dim=8,
                          num_heads=4, num_blocks=2, num_annotations=A,
                          dtype="float32"),
        data=DataConfig(seq_len=SEQ_LEN, batch_size=4, buckets=BUCKETS,
                        prefetch_depth=2),
        optimizer=OptimizerConfig(warmup_steps=2, schedule="constant"),
        train=TrainConfig(max_steps=8, log_every=2))
    ds = tds.HDF5PretrainingDataset(corpus, SEQ_LEN, crop_seed=0)
    seen = []
    stream = tds.make_bucketed_iterator(ds, 4, BUCKETS, seed=3)

    def batches():
        for b in stream:
            seen.append(b["tokens"].shape[1])
            yield b

    events = str(tmp_path / "events.jsonl")
    tele = Telemetry(events_path=events)
    try:
        out = pretrain(cfg, batches(), telemetry=tele, device="cpu")
    finally:
        tele.close()
        ds.close()
    assert len(set(seen[:8])) > 1          # the length changes by batch
    assert np.isfinite(out["history"][-1]["loss"])
    steps = [r for r in read_events(events, strict=True)
             if r["event"] == "step"]
    assert len(steps) == 4 and all("data_wait_s" in r for r in steps)
    gauges = tele.metrics.snapshot()["gauges"]
    assert gauges["data_batches_total"] >= 8
    assert gauges["data_wait_seconds"] >= 0.0
