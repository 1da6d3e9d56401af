"""The port's ragged (packed) serving path on the CPU against the JAX
package with the same weights (carried through the flat export layout):
the packed trunk (`encode` / `apply` with segment_ids), the `_packed_*`
inference entries, `RaggedDispatcher.run_packed`, `PackedBatchScheduler`
formation under a fake clock (stub dispatchers, compared batch for batch),
and the ragged `Server` against the port's own bucketed one.

Tolerances: 1e-5 on float32 trunk outputs and probabilities (same
arithmetic, another summation order), 1e-4 on logits (the head products
sum over the whole trunk width on top of the trunk's error); formation is
integer bookkeeping and must be identical."""

import dataclasses
import threading
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu import inference as jinf
from proteinbert_tpu.configs import get_preset as jax_preset
from proteinbert_tpu.data.packing import OnlinePacker
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.serve import dispatch as jdispatch
from proteinbert_tpu.serve import queue as jqueue
from proteinbert_tpu.serve import scheduler as jsched
from proteinbert_tpu_torch import inference as tinf
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.serve import dispatch as tdispatch
from proteinbert_tpu_torch.serve import queue as tqueue
from proteinbert_tpu_torch.serve import scheduler as tsched
from proteinbert_tpu_torch.serve.server import Server
from proteinbert_tpu_torch.weights import params_from_flat

torch.set_num_threads(1)

TOL = 1e-5
LOGIT_TOL = 1e-4
BUCKETS = (32, 64, 128)
S = 4
SEQS = ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWY", "GG",
        "ACDEFGHIKLMNPQRSTVWY" * 3, "MK?AYIA?QR" + "A" * 40, "WWW" * 30,
        "MKTAYIAKQRMKTAYIAKQRAC"]

WIDE = dict(local_dim=128, global_dim=128, key_dim=32, num_heads=4,
            num_blocks=2, num_annotations=64, dtype="float32",
            use_pallas=True)


@pytest.fixture(scope="module", params=["tiny", "c128_pallas"])
def pair(request):
    jcfg, tcfg = jax_preset("tiny"), get_preset("tiny")
    if request.param == "c128_pallas":
        jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **WIDE))
        tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **WIDE))
    jparams = jmodel.init(jax.random.PRNGKey(6), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


def _packed_batch(cfg, L=64, rows=3, seed=0):
    """A packed (rows, L) batch through the port's own packer: spans are
    bucket-quantized with <pad> tails (the ragged serving layout), one row
    holds a single short segment, annotations per segment."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((rows, L), np.int32)
    seg = np.zeros((rows, L), np.int32)
    ann = np.zeros((rows, S, cfg.num_annotations), np.float32)
    layout = [[(14, 16), (20, 32), (6, 16)], [(30, 32), (9, 16), (2, 16)],
              [(5, 16)]]
    for r, spans in enumerate(layout[:rows]):
        pos = 0
        for s, (n, span) in enumerate(spans):
            tokens[r, pos] = 1
            tokens[r, pos + 1:pos + 1 + n] = rng.integers(4, 26, n)
            tokens[r, pos + 1 + n] = 2
            seg[r, pos:pos + span] = s + 1
            ann[r, s] = rng.random(cfg.num_annotations) < 0.05
            pos += span
    return tokens, seg, ann


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(want), np.asarray(got), rtol=tol,
                               atol=tol)


# ----------------------------------------------------------- packed trunk

def test_packed_encode_and_apply_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tokens, seg, ann = _packed_batch(tcfg.model)
    pad = tokens != 0
    jl, jg = jmodel.encode(jparams, jnp.asarray(tokens), jnp.asarray(ann),
                           jcfg.model, jnp.asarray(pad), jnp.asarray(seg))
    tl, tg = tmodel.encode(tparams, torch.from_numpy(tokens),
                           torch.from_numpy(ann), tcfg.model,
                           torch.from_numpy(pad), torch.from_numpy(seg))
    assert tg.shape == (3, S, tcfg.model.global_dim)
    _close(jl, tl.numpy())
    _close(jg, tg.numpy())
    jlog = jmodel.apply(jparams, jnp.asarray(tokens), jnp.asarray(ann),
                        jcfg.model, segment_ids=jnp.asarray(seg))
    tlog = tmodel.apply(tparams, torch.from_numpy(tokens),
                        torch.from_numpy(ann), tcfg.model,
                        segment_ids=torch.from_numpy(seg))
    for j, t in zip(jlog, tlog):
        assert t.dtype == torch.float32
        _close(j, t.numpy(), LOGIT_TOL)


def test_packed_inference_entries_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tokens, seg, ann = _packed_batch(tcfg.model, seed=1)
    jarr = [jnp.asarray(a) for a in (tokens, seg, ann)]
    tarr = [torch.from_numpy(a) for a in (tokens, seg, ann)]
    want = jinf._packed_encode_batch(jparams, *jarr, jcfg.model)
    got = tinf._packed_encode_batch(tparams, *tarr, tcfg.model)
    for k in ("global", "local_mean"):
        _close(want[k], got[k].numpy())
    _close(jinf._packed_go_probs_batch(jparams, *jarr, jcfg.model),
           tinf._packed_go_probs_batch(tparams, *tarr, tcfg.model).numpy())
    _close(jinf._packed_residue_probs_batch(jparams, *jarr, jcfg.model),
           tinf._packed_residue_probs_batch(tparams, *tarr,
                                            tcfg.model).numpy())
    m = tinf._segment_real_mask(*tarr[:2], S)
    np.testing.assert_array_equal(
        np.asarray(jinf._segment_real_mask(*jarr[:2], S)), m.numpy())


# ------------------------------------------------------------ dispatcher

def _rider_batch(cfg, dispatcher, seqs):
    """Pack tokenized `seqs` with the JAX OnlinePacker into one
    (rows, seq_len) batch: (tokens, segment_ids, annotations, riders)."""
    toks = tinf._tokenize_masked(seqs, cfg.data.seq_len)
    packer = OnlinePacker(cfg.data.seq_len, S)
    for i, s in enumerate(seqs):
        packer.place(i, dispatcher.bucket_len(len(s)))
    R = dispatcher.rows_per_batch
    tokens = np.zeros((R, cfg.data.seq_len), np.int32)
    seg = np.zeros_like(tokens)
    ann = np.zeros((R, S, cfg.model.num_annotations), np.float32)
    riders = []
    for r, row in enumerate(packer.pop_rows(R)):
        for s, (i, start, span) in enumerate(row):
            tokens[r, start:start + span] = toks[i, :span]
            seg[r, start:start + span] = s + 1
            riders.append((r, s, start, span))
    return tokens, seg, ann, riders


def test_ragged_dispatcher_run_packed_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    jd = jdispatch.RaggedDispatcher(jparams, jcfg, buckets=BUCKETS,
                                    rows_per_batch=3, max_segments=S)
    td = tdispatch.RaggedDispatcher(tparams, tcfg, buckets=BUCKETS,
                                    rows_per_batch=3, max_segments=S,
                                    device="cpu")
    batch = _rider_batch(tcfg, td, SEQS[:6])
    assert len(batch[3]) == 6
    for kind in tdispatch.KINDS:
        want = jd.run_packed(kind, *batch)
        got, timings = td.run_packed_timed(kind, *batch)
        assert timings["segments"] == 6
        assert len(got) == len(want) == 6
        for w, g in zip(want, got):
            if kind == "embed":
                for k in ("global", "local_mean"):
                    _close(w[k], g[k])
            else:
                assert np.asarray(w).shape == g.shape
                _close(w, g)
    with pytest.raises(NotImplementedError):
        td.run("embed", batch[0][:, :32])
    with pytest.raises(ValueError, match="fixed"):
        td.run_packed("embed", batch[0][:1], *batch[1:])
    assert td.warmup(tdispatch.KINDS) == 3


# ------------------------------------------------------ scheduler formation

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _Stub:
    """Records every packed batch; one token of proof per rider."""

    def __init__(self, seq_len, num_ann=3):
        self.cfg = SimpleNamespace(
            data=SimpleNamespace(seq_len=seq_len),
            model=SimpleNamespace(num_annotations=num_ann))
        self.calls = []

    def run_packed(self, kind, tokens, segment_ids, annotations, riders,
                   heads=None):
        self.calls.append((kind, tokens.copy(), segment_ids.copy(),
                           annotations.copy(), [tuple(r) for r in riders]))
        return [(kind,) + tuple(r) for r in riders]

    def run_packed_timed(self, kind, tokens, segment_ids, annotations,
                         riders, heads=None, timed=True):
        return self.run_packed(kind, tokens, segment_ids, annotations,
                               riders), {}


def _formation(make_req, make_sched, stream, seq_len):
    """Drive one scheduler through `stream` with a fake clock; returns
    (batches, done order, expired ids)."""
    clock = FakeClock()
    stub = _Stub(seq_len)
    done = []

    def finalize(req, row):
        done.append((req.seq, row))
        req.future.set_result(row)

    q, sched = make_sched(stub, finalize, clock)
    reqs = []
    for i, (kind, span, dt, deadline, ann) in enumerate(stream):
        clock.advance(dt)
        req = make_req(kind, span, i, clock(),
                       None if deadline is None else clock() + deadline, ann)
        reqs.append(req)
        q.push(req)
        sched.poll()
    clock.advance(1.0)
    while sched.poll():
        pass
    q.close()
    while sched.poll():
        pass
    # Each package raises its own DeadlineExceededError class.
    expired = [req.seq for req in reqs
               if type(req.future.exception(timeout=0)).__name__
               == "DeadlineExceededError"]
    return stub.calls, done, expired


def _stream(seed, n=60):
    rng = np.random.default_rng(seed)
    spans = (16, 32, 64, 128)
    out = []
    for _ in range(n):
        kind = ("embed", "predict_go", "predict_residues")[
            int(rng.integers(0, 3))]
        deadline = float(rng.choice([0.002, 0.05])) if rng.random() < 0.15 \
            else None
        ann = (rng.random(3) < 0.5).astype(np.float32) \
            if rng.random() < 0.3 else None
        out.append((kind, int(rng.choice(spans)),
                    float(rng.choice([0.0, 0.001, 0.004])), deadline, ann))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_scheduler_formation_equals_jax(seed):
    seq_len, rows, wait = 128, 2, 0.005

    def req_factory(mod):
        def make(kind, span, i, t, deadline, ann):
            return mod.Request(kind=kind, seq=f"r{i}",
                               tokens=np.full(span, 4 + i % 20, np.int32),
                               bucket_len=span, future=Future(),
                               enqueued_at=t, deadline=deadline,
                               annotations=ann)
        return make

    def jax_sched(stub, finalize, clock):
        q = jqueue.RequestQueue(256)
        return q, jsched.PackedBatchScheduler(
            q, stub, finalize, rows_per_batch=rows, max_wait_s=wait,
            clock=clock, max_segments=S, pipeline_depth=1)

    def port_sched(stub, finalize, clock):
        q = tqueue.RequestQueue(256)
        return q, tsched.PackedBatchScheduler(
            q, stub, finalize, rows_per_batch=rows, max_wait_s=wait,
            clock=clock, max_segments=S)

    stream = _stream(seed)
    want = _formation(req_factory(jqueue), jax_sched, stream, seq_len)
    got = _formation(req_factory(tqueue), port_sched, stream, seq_len)
    assert len(got[0]) == len(want[0]) > 5
    for (wk, wt, ws, wa, wr), (gk, gt, gs, ga, gr) in zip(want[0], got[0]):
        assert (gk, gr) == (wk, wr)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(ga, wa)
    assert got[1] == want[1]
    assert got[2] == want[2] and got[2]  # some deadlines do expire


def test_packed_scheduler_dispatch_failure_and_abort():
    clock = FakeClock()
    stub = _Stub(128)
    stub.run_packed = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("device fell over"))
    q = tqueue.RequestQueue(16)
    sched = tsched.PackedBatchScheduler(q, stub, lambda r, row: None,
                                        rows_per_batch=2, max_wait_s=1.0,
                                        clock=clock, max_segments=S)
    a = tqueue.Request(kind="embed", seq="a", tokens=np.ones(16, np.int32),
                       bucket_len=16, future=Future(), enqueued_at=clock())
    q.push(a)
    clock.advance(2.0)
    assert sched.poll() == 1
    with pytest.raises(RuntimeError, match="fell over"):
        a.future.result(timeout=0)
    b = tqueue.Request(kind="embed", seq="b", tokens=np.ones(16, np.int32),
                       bucket_len=16, future=Future(), enqueued_at=clock())
    q.push(b)
    sched._ingest(clock())
    assert sched.pending_rows() == 1
    assert sched.fail_pending(RuntimeError("abort")) == [b]


# ----------------------------------------------------------------- Server

@pytest.fixture(scope="module")
def tiny():
    cfg = get_preset("tiny")
    return tmodel.init(cfg.model, torch.Generator().manual_seed(4),
                       device="cpu"), cfg


def _requests():
    kinds = ("embed", "predict_go", "predict_residues")
    return [(kinds[i % 3], SEQS[i % len(SEQS)]) for i in range(15)]


def _serve(tiny, mode, reqs, **kw):
    params, cfg = tiny
    results = {}
    with Server(params, cfg, device="cpu", buckets=BUCKETS, max_batch=2,
                max_wait_s=0.002, cache_size=0, serve_mode=mode,
                warm_kinds=(), **kw) as srv:
        def client(idx):
            futures = {i: srv.submit(*reqs[i]) for i in idx}
            for i, f in futures.items():
                results[i] = f.result(timeout=60)

        threads = [threading.Thread(target=client, args=(range(j, 15, 3),))
                   for j in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    return results, srv


def test_ragged_server_matches_bucketed(tiny):
    reqs = _requests()
    bucketed, _ = _serve(tiny, "bucketed", reqs)
    ragged, srv = _serve(tiny, "ragged", reqs, pack_max_segments=S)
    stats = srv.stats()
    assert stats["mode"] == "ragged" and stats["completed"] == 15
    assert stats["batched_rows"] == 15
    for i, (kind, seq) in enumerate(reqs):
        want, got = bucketed[i], ragged[i]
        if kind == "embed":
            for k in ("global", "local_mean"):
                _close(want[k], got[k])
        elif kind == "predict_go":
            _close(want, got)
        else:
            assert got[0] == want[0] and "?" not in got[0]
            assert got[1].shape == (srv.dispatcher.bucket_len(len(seq)),
                                    tiny[1].model.vocab_size)
            _close(want[1], got[1])


def test_ragged_server_argument_checks(tiny):
    params, cfg = tiny
    with pytest.raises(ValueError, match="serve_mode"):
        Server(params, cfg, device="cpu", serve_mode="paged")
    with pytest.raises(ValueError, match="batch_classes"):
        Server(params, cfg, device="cpu", serve_mode="ragged",
               batch_classes=(1, 2))
    with pytest.raises(ValueError, match="max_segments"):
        Server(params, cfg, device="cpu", serve_mode="ragged",
               pack_max_segments=0)


def test_ragged_entry_points_without_device_raise(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    params, cfg = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdispatch.RaggedDispatcher(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(params, cfg, serve_mode="ragged")
