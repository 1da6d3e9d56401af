"""The port's task heads on the CPU beside the JAX package's on the same
weights (carried through the flat export layout): the trunk fingerprint
is the JAX digest for both block layouts; a head saved by either
registry loads in the other; split apply (`apply_heads`,
`apply_heads_packed`, `predict_task_rows`) matches the JAX functions; the
port's `Server` answers `predict_task` bucketed, ragged and on the int8
arm as the JAX `Server` does; hot add and remove, the typed
`unknown_head` rejection and `TrunkMismatchError` come where the JAX
package raises them; the HTTP routes answer as in process; the eval
numerics are the JAX ones.

Tolerances: the port against the JAX package rtol = atol = 1e-5 (float32
trunks, the same arithmetic in another summation order, as in
test_torch_ragged.py and test_torch_http.py; the servers' task answers
differ by up to ~1.6e-6 here); the port's bucketed server against its own
offline split apply at the served batch shape: bit for bit."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.configs import (
    DataConfig as JData, ModelConfig as JModel, PretrainConfig as JCfg,
    TaskConfig as JTask,
)
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.heads import apply as japply
from proteinbert_tpu.heads import eval as jeval
from proteinbert_tpu.heads.registry import (
    HeadRegistry as JRegistry, trunk_fingerprint as jfingerprint,
)
from proteinbert_tpu.models import finetune as jft
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.serve import Server as JServer
from proteinbert_tpu.serve import TASK_KIND
from proteinbert_tpu_torch import inference as tinf
from proteinbert_tpu_torch.configs import (
    DataConfig, ModelConfig, PretrainConfig, TaskConfig,
)
from proteinbert_tpu_torch.heads import (
    CorruptHeadError, HeadRegistry, TrunkMismatchError, UnknownHeadError,
    trunk_fingerprint,
)
from proteinbert_tpu_torch.heads import apply as tapply
from proteinbert_tpu_torch.heads import eval as teval
from proteinbert_tpu_torch.models import finetune as tft
from proteinbert_tpu_torch.serve.http import make_http_server
from proteinbert_tpu_torch.serve.server import Server
from proteinbert_tpu_torch.weights import params_from_flat

TOL = 1e-5
SELF_TOL = 1e-6
MODEL = dict(local_dim=32, global_dim=64, key_dim=16, num_heads=4,
             num_blocks=2, num_annotations=64, dtype="float32")
BUCKETS = (32, 64)
TASKS = [dict(kind="token_classification", num_outputs=4),
         dict(kind="sequence_classification", num_outputs=3),
         dict(kind="sequence_regression", num_outputs=1,
              freeze_trunk=True)]
SEQS = ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWYACDEFGHIK", "GGA",
        "WYACDEFGHIKLMNPQRSTVWYACDEFGHIKLMNPQRSTV", "MKTAYIAKQRACD",
        "PQRSTVWY"]


def _cfgs(scan_blocks=True):
    jcfg = JCfg(model=JModel(**MODEL, scan_blocks=scan_blocks),
                data=JData(seq_len=64, batch_size=4, buckets=BUCKETS))
    tcfg = PretrainConfig(model=ModelConfig(**MODEL,
                                            scan_blocks=scan_blocks),
                          data=DataConfig(seq_len=64, batch_size=4,
                                          buckets=BUCKETS))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def registries(tmp_path_factory, weights):
    """One head per task kind (the second with a hidden layer), saved by
    the JAX registry and loaded by both: (jax registry, port registry,
    head ids, JAX LoadedHeads, port LoadedHeads)."""
    jcfg, _, jparams, _ = weights
    root = str(tmp_path_factory.mktemp("heads"))
    jreg, treg = JRegistry(root), HeadRegistry(root)
    fp = jfingerprint(jparams)
    hids = []
    for i, t in enumerate(TASKS):
        task = JTask(**t, head_hidden_dim=16 if i == 1 else 0)
        hp = jft.head_init(jax.random.PRNGKey(i + 1), jcfg.model, task)
        hids.append(jreg.save(jax.tree.map(np.asarray, hp), task, fp,
                              name=f"t{i}"))
    return (jreg, treg, hids, [jreg.load(h, trunk_fp=fp) for h in hids],
            [treg.load(h, trunk_fp=fp) for h in hids])


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tokens(seqs, L, seq_len=64):
    return tinf._tokenize_masked(seqs, seq_len)[:, :L]


# ---------------------------------------------------------- fingerprint

@pytest.mark.parametrize("scan_blocks", [True, False])
def test_trunk_fingerprint_is_the_jax_digest(scan_blocks):
    jcfg, tcfg = _cfgs(scan_blocks)
    jparams = jmodel.init(jax.random.PRNGKey(3), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    want = jfingerprint(jparams)
    assert trunk_fingerprint(tparams, scan_blocks) == want
    # A stripped fine-tune trunk hashes like the pretrain params.
    trunk = tft.init(torch.Generator().manual_seed(0), tcfg.model,
                     TaskConfig(**TASKS[0]), tparams, device="cpu")["trunk"]
    assert trunk_fingerprint(trunk, scan_blocks) == want
    assert trunk_fingerprint(tparams, not scan_blocks) != want


# ------------------------------------------------------------- registry

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_head_saved_by_either_registry_loads_in_the_other(
        tmp_path, weights, writer):
    jcfg, tcfg, jparams, tparams = weights
    fp = trunk_fingerprint(tparams)
    task = TaskConfig(kind="sequence_classification", num_outputs=3,
                      head_hidden_dim=8)
    head = tft.head_init(torch.Generator().manual_seed(5), tcfg.model, task,
                         device="cpu")
    jreg, treg = JRegistry(str(tmp_path)), HeadRegistry(str(tmp_path))
    if writer == "port":
        hid = treg.save(head, task, fp, name="p", metrics={"acc": 0.5})
    else:
        hid = jreg.save({k: {n: v.numpy() for n, v in d.items()}
                         for k, d in head.items()},
                        JTask(**dataclasses.asdict(task)), fp, name="p",
                        metrics={"acc": 0.5})
    jh, th = jreg.load(hid, trunk_fp=fp), treg.load(hid, trunk_fp=fp)
    assert jh.meta["head_digest"] == th.meta["head_digest"]
    assert th.task == task and jh.meta["trunk_fingerprint"] == fp
    tokens = _tokens(SEQS[:4], 64)
    want = japply.predict_task_rows(jparams, jcfg.model, jh, tokens)
    got = tapply.predict_task_rows(tparams, tcfg.model, th, tokens)
    _close(want, got)


def test_registry_errors_are_typed(tmp_path, weights):
    _, tcfg, _, tparams = weights
    reg = HeadRegistry(str(tmp_path))
    task = TaskConfig(**TASKS[1])
    hid = reg.save(tft.head_init(torch.Generator().manual_seed(1),
                                 tcfg.model, task, device="cpu"),
                   task, "some-other-trunk")
    with pytest.raises(TrunkMismatchError):
        reg.load(hid, trunk_fp=trunk_fingerprint(tparams))
    with pytest.raises(UnknownHeadError):
        reg.load("0123456789abcdef")
    with np.load(f"{tmp_path}/{hid}/head.npz") as z:
        flat = {k: z[k].copy() for k in z.files}
    flat["out/bias"][0] += 1.0
    np.savez(f"{tmp_path}/{hid}/head.npz", **flat)
    with pytest.raises(CorruptHeadError):
        reg.load(hid)


# ---------------------------------------------------------- split apply

@pytest.mark.parametrize("which", [0, 1, 2])
def test_split_apply_matches_jax_and_the_monolithic_apply(weights,
                                                          registries, which):
    jcfg, tcfg, jparams, tparams = weights
    _, _, _, jheads, theads = registries
    tokens = _tokens(SEQS, 32)
    want = japply.predict_task_rows(jparams, jcfg.model, jheads[which],
                                    tokens)
    got = tapply.predict_task_rows(tparams, tcfg.model, theads[which],
                                   tokens)
    _close(want, got)
    head = tapply.head_params_on(theads[which].params, torch.device("cpu"))
    with torch.no_grad():
        mono = tft.apply({"trunk": tparams, "head": head},
                         torch.from_numpy(tokens), tcfg.model,
                         theads[which].task).numpy()
    np.testing.assert_array_equal(got, mono)


def test_apply_heads_and_packed_match_jax(weights, registries):
    """A mixed batch (three heads) bucketed, and packed riders of the
    three heads in two rows (two segments and one), against the JAX split
    apply."""
    jcfg, tcfg, jparams, tparams = weights
    _, _, _, jheads, theads = registries
    tokens = _tokens(SEQS, 32)
    ann = np.zeros((len(SEQS), 64), np.float32)
    ann[2, 5] = 1.0
    pick = [i % 3 for i in range(len(SEQS))]
    jout = japply.apply_heads(
        japply.trunk_batch(jparams, jnp.asarray(tokens), jnp.asarray(ann),
                           jcfg.model), [jheads[i] for i in pick])
    tout = tapply.apply_heads(
        tapply.trunk_batch(tparams, torch.from_numpy(tokens),
                           torch.from_numpy(ann), tcfg.model),
        [theads[i] for i in pick])
    for w, g in zip(jout, tout):
        _close(w, g)
    ptok = np.zeros((2, 64), np.int32)
    pseg = np.zeros((2, 64), np.int32)
    pann = np.zeros((2, 3, 64), np.float32)
    geom = []
    for r, row in enumerate(([0, 2], [3])):
        pos = 0
        for s, i in enumerate(row):
            t = _tokens([SEQS[i]], 32 if len(SEQS[i]) < 30 else 64)[0]
            ptok[r, pos:pos + len(t)] = t
            pseg[r, pos:pos + len(t)] = s + 1
            geom.append((r, s, pos, len(t)))
            pos += len(t)
    jtr = japply.packed_trunk_batch(jparams, jnp.asarray(ptok),
                                    jnp.asarray(pseg), jnp.asarray(pann),
                                    jcfg.model)
    ttr = tapply.packed_trunk_batch(tparams, torch.from_numpy(ptok),
                                    torch.from_numpy(pseg),
                                    torch.from_numpy(pann), tcfg.model)
    pick = [0, 1, 2]
    jout = japply.apply_heads_packed(
        jtr, [(jheads[i],) + g for i, g in zip(pick, geom)])
    tout = tapply.apply_heads_packed(
        ttr, [(theads[i],) + g for i, g in zip(pick, geom)])
    for w, g in zip(jout, tout):
        assert w.shape == g.shape
        _close(w, g)


# --------------------------------------------------------------- server

def _server_kw(mode):
    if mode == "ragged":
        return dict(serve_mode="ragged", pack_max_segments=4, max_batch=2)
    return dict(max_batch=4, batch_classes=(4,))


@pytest.mark.parametrize("mode,quant", [("bucketed", "fp32"),
                                        ("ragged", "fp32"),
                                        ("bucketed", "int8"),
                                        ("ragged", "int8")])
def test_server_predict_task_matches_the_jax_server(weights, registries,
                                                    mode, quant):
    """Mixed-head traffic through both servers on the same weights and
    heads; the port's bucketed fp32 answers also equal its own offline
    split apply on the row alone in a batch of the served shape."""
    jcfg, tcfg, jparams, tparams = weights
    jreg, treg, hids, _, theads = registries
    kw = dict(buckets=BUCKETS, max_wait_s=0.005, cache_size=0,
              warm_kinds=(), quant=quant, **_server_kw(mode))
    reqs = [(hids[i % 3], seq) for i, seq in enumerate(SEQS)]
    answers = {}
    for name, cls, params, cfg, reg, extra in (
            ("jax", JServer, jparams, jcfg, jreg, {}),
            ("port", Server, tparams, tcfg, treg, {"device": "cpu"})):
        with cls(params, cfg, registry=reg, heads=hids, **kw,
                 **extra) as srv:
            futs = [srv.submit(TASK_KIND, seq, head_id=h) for h, seq in reqs]
            answers[name] = [f.result(60) for f in futs]
            if name == "port":
                stats = srv.stats()
    assert stats["heads"] == 3 and stats["completed"] == len(reqs)
    by_id = dict(zip(hids, theads))
    for (hid, seq), want, got in zip(reqs, answers["jax"], answers["port"]):
        assert want.shape == got.shape
        _close(want, got)
        if quant == "fp32" and mode == "bucketed":
            # The same row alone in a batch of the served shape (the
            # dispatcher pads with zero rows).
            L = 32 if len(seq) + 2 <= 32 else 64
            tokens = np.zeros((4, L), np.int32)
            tokens[0] = _tokens([seq], L)[0]
            offline = tapply.predict_task_rows(tparams, tcfg.model,
                                               by_id[hid], tokens)[0]
            np.testing.assert_array_equal(offline, got)


def test_hot_add_remove_and_unknown_head_as_jax(weights, registries):
    """Add a head to a live server (no new trunk shape), remove it
    (submits for it raise UnknownHeadError, counted under
    rejected["unknown_head"]), where the JAX server does the same."""
    jcfg, tcfg, jparams, tparams = weights
    jreg, treg, hids, _, _ = registries
    kw = dict(buckets=BUCKETS, max_batch=4, batch_classes=(4,),
              max_wait_s=0.002, cache_size=0, warm_kinds=())
    for cls, params, cfg, reg, extra in (
            (JServer, jparams, jcfg, jreg, {}),
            (Server, tparams, tcfg, treg, {"device": "cpu"})):
        srv = cls(params, cfg, registry=reg, heads=hids[:2], **kw, **extra)
        srv.start()
        try:
            n_trunk = srv.dispatcher.trunk_executable_count
            assert set(srv.dispatcher.warmup_report["heads"]) == set(
                hids[:2])
            srv.add_head(hids[2])
            assert srv.predict_task(hids[2], "ACDEFGHIKL",
                                    timeout=60).shape == (1,)
            assert srv.dispatcher.trunk_executable_count == n_trunk
            assert {h["head_id"] for h in srv.list_heads()} == set(hids)
            srv.remove_head(hids[2])
            with pytest.raises(UnknownHeadError if cls is Server
                               else LookupError):
                srv.predict_task(hids[2], "ACDEF", timeout=10)
            with pytest.raises(LookupError):
                srv.remove_head(hids[2])
            with pytest.raises(ValueError, match="head_id is required"):
                srv.submit(TASK_KIND, "ACDEF")
            with pytest.raises(ValueError, match="head_id is required"):
                srv.submit("embed", "ACDEF", head_id=hids[0])
            assert srv.stats()["rejected"]["unknown_head"] == 1
            assert srv.predict_task(hids[1], "ACDEFGH",
                                    timeout=60).shape == (3,)
        finally:
            srv.drain(timeout=60)


def test_a_head_of_another_trunk_is_refused_as_in_jax(tmp_path, weights):
    jcfg, tcfg, jparams, tparams = weights
    other = jmodel.init(jax.random.PRNGKey(99), jcfg.model)
    task = JTask(**TASKS[1])
    hid = JRegistry(str(tmp_path)).save(
        jax.tree.map(np.asarray, jft.head_init(jax.random.PRNGKey(1),
                                               jcfg.model, task)),
        task, jfingerprint(other))
    with pytest.raises(ValueError) as jerr:
        JServer(jparams, jcfg, warm_kinds=(), registry=str(tmp_path),
                heads=[hid])
    assert type(jerr.value).__name__ == "TrunkMismatchError"
    with pytest.raises(TrunkMismatchError):
        Server(tparams, tcfg, device="cpu", warm_kinds=(),
               registry=str(tmp_path), heads=[hid])
    srv = Server(tparams, tcfg, device="cpu", warm_kinds=(),
                 registry=str(tmp_path))
    with pytest.raises(TrunkMismatchError):
        srv.add_head(hid)
    assert srv.list_heads() == []
    srv.abort()


# ----------------------------------------------------------------- HTTP

def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_routes_answer_as_in_process(weights, registries):
    _, tcfg, jparams, tparams = weights
    _, treg, hids, _, _ = registries
    srv = Server(tparams, tcfg, device="cpu", buckets=BUCKETS, max_batch=2,
                 batch_classes=(2,), max_wait_s=0.002, cache_size=0,
                 warm_kinds=(), registry=treg, heads=hids[:2])
    srv.start()
    httpd = make_http_server(srv, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for hid, seq in ((hids[0], SEQS[1]), (hids[1], SEQS[0])):
            status, body = _post(base, "/v1/predict_task",
                                 {"head_id": hid, "seq": seq})
            assert status == 200 and body["head_id"] == hid
            want = srv.predict_task(hid, seq, timeout=60)
            np.testing.assert_array_equal(
                np.asarray(body["outputs"], np.float32), want)
        status, body = _post(base, "/v1/predict_task",
                             {"head_id": "nope", "seq": "ACDEF"})
        assert status == 404 and body["type"] == "unknown_head"
        with urllib.request.urlopen(base + "/v1/heads", timeout=30) as r:
            listed = json.loads(r.read())["heads"]
        assert listed == srv.list_heads()
        assert {h["head_id"] for h in listed} == set(hids[:2])
        status, body = _post(base, "/v1/heads/add", {"head_id": hids[2]})
        assert status == 200 and len(body["heads"]) == 3
        status, body = _post(base, "/v1/heads/remove", {"head_id": hids[2]})
        assert status == 200 and len(body["heads"]) == 2
        status, body = _post(base, "/v1/heads/remove", {"head_id": "nope"})
        assert status == 404 and body["type"] == "unknown_head"
        status, body = _post(base, "/v1/heads/add", {"head_id": 7})
        assert status == 400 and body["type"] == "bad_request"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["trunk_fingerprint"] == jfingerprint(jparams)
        assert health["stats"]["heads"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)
        srv.drain(timeout=60)


# ----------------------------------------------------------------- eval

def test_eval_numerics_and_evaluate_head_match_jax(tmp_path, weights,
                                                  registries):
    jcfg, tcfg, jparams, tparams = weights
    _, _, _, jheads, theads = registries
    rng = np.random.default_rng(2)
    x = rng.integers(0, 5, 40).astype(np.float64)
    y = x + rng.normal(0, 1, 40)
    np.testing.assert_array_equal(teval._ranks(x), jeval._ranks(x))
    assert teval.spearman(x, y) == jeval.spearman(x, y)
    scores, labels = rng.normal(size=(40, 3)), rng.integers(0, 3, 40)
    assert teval.auc_proxy(scores, labels) == jeval.auc_proxy(scores, labels)
    from proteinbert_tpu.data.synthetic import make_task_batches

    from proteinbert_tpu_torch.obs import Telemetry, read_events

    def batches_for(head):
        return make_task_batches(8, np.random.default_rng(len(head.name)),
                                 head.task.kind, head.task.num_outputs, 64, 4)

    events = str(tmp_path / "events.jsonl")
    tele = Telemetry(events_path=events)
    got_all = teval.evaluate_heads(tparams, tcfg.model, theads, batches_for,
                                   telemetry=tele)
    tele.close()
    recs = [r for r in read_events(events, strict=True)
            if r["event"] == "head_eval"]
    assert [r["head_id"] for r in recs] == [h.head_id for h in theads]
    for jh, th in zip(jheads, theads):
        want = jeval.evaluate_head(jparams, jcfg.model, jh, batches_for(jh))
        got = got_all[th.head_id]
        assert set(got) == set(want) and got["kind"] == want["kind"]
        for k, v in want.items():
            if isinstance(v, float):
                assert abs(got[k] - v) <= 1e-5, (k, got[k], v)


@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_int8_parity_shadow_covers_task_batches(weights, registries, mode):
    """On the int8 arm with quant_parity_every=1 a predict_task batch runs
    the fp32 shadow (the fp32 trunk and the same tails) and records how
    far the int8 answers lie from it."""
    _, tcfg, _, tparams = weights
    _, treg, hids, _, _ = registries
    with Server(tparams, tcfg, device="cpu", buckets=BUCKETS,
                max_wait_s=0.002, cache_size=0, warm_kinds=(), quant="int8",
                quant_parity_every=1, registry=treg, heads=hids[:2],
                **_server_kw(mode)) as srv:
        out = srv.predict_task(hids[1], SEQS[1], timeout=60)
        report = srv.stats()["quant"]
    assert out.shape == (3,)
    assert report["parity_samples"] == 1 and report["parity_max"] > 0
