"""The port's blue-green trunk rollout on the CPU, beside the JAX package's
on the same weights (carried through the flat export layout): the
candidate arm of both dispatchers (`load_candidate`, `shadow_submit`,
`flip`, `rollback_trunk`), its refusals, the in-place flip that keeps
every tensor a CUDA graph reads at its address, a flip under concurrent
submits, the cache flush, the `RolloutController` over two port replicas
behind the port's `FleetRouter` (its window verdicts against the JAX
controller's over JAX replicas on the same traffic) and the
`HeadsEvalGate`.

Tolerances: the port against the JAX package rtol = atol = 1e-5 (float32
trunks, the same arithmetic in another summation order, as in
test_torch_http.py); the port against itself (rollback, the flip under
load): bit for bit."""

import json
import math
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from proteinbert_tpu.configs import (
    DataConfig as JData, ModelConfig as JModel, PretrainConfig as JCfg,
    TaskConfig as JTask,
)
from proteinbert_tpu.data.synthetic import make_task_batches as jbatches
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.heads import HeadRegistry as JRegistry
from proteinbert_tpu.heads import trunk_fingerprint as jfingerprint
from proteinbert_tpu.models import finetune as jft
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.rollout import HeadsEvalGate as JGate
from proteinbert_tpu.rollout import RolloutController as JController
from proteinbert_tpu.serve import Server as JServer
from proteinbert_tpu.serve.fleet import FleetRouter as JRouter
from proteinbert_tpu.serve.http import make_http_server as jax_http
from proteinbert_tpu_torch.configs import (
    DataConfig, ModelConfig, PretrainConfig,
)
from proteinbert_tpu_torch.data.synthetic import make_task_batches
from proteinbert_tpu_torch.heads import HeadRegistry, trunk_fingerprint
from proteinbert_tpu_torch.obs import Telemetry, read_events
from proteinbert_tpu_torch.rollout import HeadsEvalGate, RolloutController
from proteinbert_tpu_torch.serve.dispatch import _tensors
from proteinbert_tpu_torch.serve.errors import (
    CandidateUnfitError, NoCandidateError,
)
from proteinbert_tpu_torch.serve.fleet import FleetRouter
from proteinbert_tpu_torch.serve.http import make_http_server
from proteinbert_tpu_torch.serve.server import Server
from proteinbert_tpu_torch.weights import params_from_flat

torch.set_num_threads(1)

TOL = 1e-5
MODEL = dict(local_dim=16, global_dim=32, key_dim=8, num_heads=2,
             num_blocks=2, num_annotations=32, dtype="float32")
BUCKETS = (24, 48)
JCFG = JCfg(model=JModel(**MODEL),
            data=JData(seq_len=48, batch_size=4, buckets=BUCKETS))
TCFG = PretrainConfig(model=ModelConfig(**MODEL),
                      data=DataConfig(seq_len=48, batch_size=4,
                                      buckets=BUCKETS))
PROBE = "MKTAYIAKQRQISFVKSH"
KW = dict(buckets=BUCKETS, max_wait_s=0.002, warm_kinds=())
AA = "ACDEFGHIKLMNPQRSTVWY"


def _perturbed(tree, scale, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(a) + (scale * rng.standard_normal(np.shape(a)))
        .astype(np.asarray(a).dtype) for a in leaves])


@pytest.fixture(scope="module")
def trunks():
    """JAX params of the resident trunk and two candidates: `near` (1e-5
    noise: the parity gate passes) and `far` (0.5: it fails)."""
    resident = jmodel.init(jax.random.PRNGKey(0), JCFG.model)
    return {"resident": resident, "near": _perturbed(resident, 1e-5, 1),
            "far": _perturbed(resident, 0.5, 2)}


def _port(jparams):
    """A port params tree of its own (a flip writes into the resident
    tensors, so no two servers share one)."""
    return params_from_flat(flatten_params(jparams), TCFG.model,
                            device="cpu")


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _same(kind, a, b):
    """Two answers of one kind bit for bit."""
    if kind == "embed":
        return all(np.array_equal(a[k], b[k]) for k in a)
    if kind == "predict_residues":
        return a[0] == b[0] and np.array_equal(a[1], b[1])
    return np.array_equal(a, b)


def _near(kind, want, got):
    if kind == "embed":
        for k in want:
            _close(want[k], got[k])
    elif kind == "predict_residues":
        assert want[0] == got[0]
        _close(want[1], got[1])
    else:
        _close(want, got)


REQUESTS = [("embed", PROBE), ("predict_go", PROBE),
            ("predict_residues", "MKT?YIAKQR?ISFVKSHACDEFGHIK")]


def _ask(srv, kind, seq):
    return srv.submit(kind, seq).result(timeout=60)


# --------------------------------------------------- the candidate arm

@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_shadow_flip_rollback_match_jax(trunks, mode):
    """Shadows answer as the JAX shadows do for every kind; after the flip
    the live answers are the JAX post-flip ones (and the port's own
    shadows); after the rollback the port's answers are its pre-flip ones
    bit for bit."""
    kw = dict(KW, max_batch=4, cache_size=8, serve_mode=mode,
              pack_max_segments=4)
    with JServer(trunks["resident"], JCFG, **kw) as js, \
            Server(_port(trunks["resident"]), TCFG, device="cpu",
                   **kw) as ts:
        pre = [_ask(ts, k, s) for k, s in REQUESTS]
        js.load_candidate(params=trunks["near"])
        report = ts.load_candidate(params=_port(trunks["near"]))
        assert report["fingerprint"] == jfingerprint(trunks["near"])
        shadows = []
        for kind, seq in REQUESTS:
            want = js.shadow_submit(kind, seq)
            shadows.append(ts.shadow_submit(kind, seq))
            _near(kind, want, shadows[-1])
        assert ts.rollout_status()["shadow_requests"] == len(REQUESTS)
        jflip, tflip = js.flip(), ts.flip()
        assert tflip["fingerprint"] == jflip["fingerprint"]
        assert tflip["parked_fingerprint"] == jflip["parked_fingerprint"]
        for (kind, seq), shadow in zip(REQUESTS, shadows):
            got = _ask(ts, kind, seq)
            _near(kind, _ask(js, kind, seq), got)
            _near(kind, shadow, got)
        assert not _same("embed", pre[0], _ask(ts, *REQUESTS[0]))
        ts.rollback_trunk()
        for (kind, seq), want in zip(REQUESTS, pre):
            assert _same(kind, want, _ask(ts, kind, seq)), kind
        assert ts.trunk_fp() == jfingerprint(trunks["resident"])
        status = ts.rollout_status()
        assert status["candidate_fingerprint"] == jfingerprint(
            trunks["near"])
        assert status["parked_fingerprint"] is None


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_flip_and_rollback_keep_every_graph_read_address(trunks, quant):
    """The tensors the graphs read (the fp32 arm's params, the int8 arm's
    quantized tree) keep their addresses across flip and rollback and
    take the candidate's values, then the resident's back; the park
    waits on the host."""
    srv = Server(_port(trunks["resident"]), TCFG, device="cpu", quant=quant,
                 **KW)
    disp = srv.dispatcher

    def serving():
        return _tensors(disp.qparams if quant == "int8" else disp.params)

    before = [t.clone() for t in serving()]
    ptrs = [t.data_ptr() for t in serving()]
    srv.load_candidate(params=_port(trunks["far"]))
    cand = [t.clone() for t in _tensors(
        disp.cand_qparams if quant == "int8" else disp.cand_params)]
    srv.flip()
    assert [t.data_ptr() for t in serving()] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(serving(), cand))
    parked = disp.parked_qparams if quant == "int8" else disp.parked_params
    assert all(t.device.type == "cpu" for t in _tensors(parked))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(parked), before))
    srv.rollback_trunk()
    assert [t.data_ptr() for t in serving()] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(serving(), before))
    demoted = disp.cand_qparams if quant == "int8" else disp.cand_params
    assert all(torch.equal(a, b) for a, b in zip(_tensors(demoted), cand))
    assert not {t.data_ptr() for t in _tensors(demoted)} & set(ptrs)


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_status_keys_and_weight_bytes_match_jax(trunks, quant):
    js = JServer(trunks["resident"], JCFG, quant=quant, **KW)
    ts = Server(_port(trunks["resident"]), TCFG, device="cpu", quant=quant,
                **KW)
    jrep = js.load_candidate(params=trunks["near"])
    trep = ts.load_candidate(params=_port(trunks["near"]))
    for key in ("weight_bytes_resident", "weight_bytes_candidate", "quant",
                "fingerprint"):
        assert trep[key] == jrep[key], key
    assert set(ts.dispatcher.candidate_status()) >= set(
        js.dispatcher.candidate_status())
    assert set(ts.rollout_status()) == set(js.rollout_status())
    assert ts.stats()["rollout"]["candidate"]["loaded"]
    assert ts.dispatcher.candidate_status()["graph_pool_bytes"] == 0
    assert ts.unload_candidate() and not ts.unload_candidate()
    assert ts.rollout_status()["candidate_fingerprint"] is None


def _wrong_shape(trunks):
    tree = _port(trunks["near"])
    tree["blocks"][0]["global_dense1"]["bias"] = torch.zeros(3)
    return tree


def _missing_leaf(trunks):
    tree = _port(trunks["near"])
    del tree["global_head"]
    return tree


@pytest.mark.parametrize("case", [
    "wrong shape", "missing leaf", "over budget", "flip empty",
    "rollback empty", "shadow empty", "neighbors shadow",
    "neither params nor source", "source without loader"])
def test_refusals_are_typed(trunks, case):
    srv = Server(_port(trunks["resident"]), TCFG, device="cpu", **KW)
    fp = srv.trunk_fp()
    calls = {
        "wrong shape": (ValueError, lambda: srv.load_candidate(
            params=_wrong_shape(trunks))),
        "missing leaf": (ValueError, lambda: srv.load_candidate(
            params=_missing_leaf(trunks))),
        "over budget": (CandidateUnfitError, lambda: srv.load_candidate(
            params=_port(trunks["near"]), hbm_budget_bytes=2 * sum(
                t.numel() * 4 for t in _tensors(srv.dispatcher.params))
            - 1)),
        "flip empty": (NoCandidateError, srv.flip),
        "rollback empty": (NoCandidateError, srv.rollback_trunk),
        "shadow empty": (NoCandidateError,
                         lambda: srv.shadow_submit("embed", PROBE)),
        "neighbors shadow": (ValueError,
                             lambda: srv.shadow_submit("neighbors", PROBE)),
        "neither params nor source": (ValueError, srv.load_candidate),
        "source without loader": (ValueError,
                                  lambda: srv.load_candidate(source="x")),
    }
    exc, call = calls[case]
    with pytest.raises(exc):
        call()
    # A refusal leaves no residue on either arm.
    status = srv.rollout_status()
    assert status["candidate_fingerprint"] is None
    assert not status["candidate"]["loaded"] and srv.trunk_fp() == fp


def test_a_budget_that_fits_loads(trunks):
    srv = Server(_port(trunks["resident"]), TCFG, device="cpu", **KW)
    need = 2 * sum(t.numel() * 4 for t in _tensors(srv.dispatcher.params))
    report = srv.load_candidate(params=_port(trunks["near"]),
                                hbm_budget_bytes=need)
    assert report["hbm_budget_bytes"] == need
    assert report["weight_bytes_resident"] == need // 2


def test_flip_under_concurrent_submits_tears_no_request(trunks):
    """Submits from several threads across a flip each see exactly one
    trunk, bit for bit; afterwards only the candidate; a rollback gives
    the resident's numerics back bit for bit. max_batch 1 keeps every
    request on the one (1, L) shape."""
    srv = Server(_port(trunks["resident"]), TCFG, device="cpu",
                 **dict(KW, max_batch=1, cache_size=0))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with srv:
            res_ref = srv.embed(PROBE, timeout=60)
            srv.load_candidate(params=_port(trunks["far"]))
            cand_ref = srv.shadow_submit("embed", PROBE)
            assert not np.array_equal(res_ref["global"], cand_ref["global"])
            results = [None] * 48
            start = threading.Barrier(7)

            def client(w):
                start.wait()
                for i in range(w, len(results), 6):
                    results[i] = srv.embed(PROBE, timeout=60)

            threads = [threading.Thread(target=client, args=(w,))
                       for w in range(6)]
            for t in threads:
                t.start()
            start.wait()
            srv.flip()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            for out in results:
                is_res = _same("embed", out, res_ref)
                is_cand = _same("embed", out, cand_ref)
                assert is_res != is_cand, "a request saw a torn trunk"
            assert _same("embed", srv.embed(PROBE, timeout=60), cand_ref)
            srv.rollback_trunk()
            assert _same("embed", srv.embed(PROBE, timeout=60), res_ref)
    finally:
        sys.setswitchinterval(interval)


def test_flip_flushes_the_cache_and_no_old_answer_refills_it(trunks):
    """The flip drops every cached answer; a sequence asked before it is
    computed again after it; a request admitted before the flip and
    answered after it keys under its own epoch, out of later requests'
    reach."""
    srv = Server(_port(trunks["resident"]), TCFG, device="cpu",
                 **dict(KW, max_batch=4, cache_size=8))
    with srv:
        old = srv.embed(PROBE, timeout=60)
        assert _same("embed", srv.embed(PROBE, timeout=60), old)
        assert srv.stats()["cache_hit_returns"] == 1
        srv.load_candidate(params=_port(trunks["far"]))
        new = srv.shadow_submit("embed", PROBE)
        assert srv.flip()["cache_dropped"] == 1
        assert _same("embed", srv.embed(PROBE, timeout=60), new)
        assert srv.stats()["cache_hit_returns"] == 1
        srv.rollback_trunk()
    # Admitted in epoch 2, answered in epoch 3: its answer (the far
    # trunk's) must not be what a later request gets from the cache.
    late = Server(_port(trunks["resident"]), TCFG, device="cpu",
                  **dict(KW, max_batch=4, cache_size=8))
    late.load_candidate(params=_port(trunks["far"]))
    pending = late.submit("embed", PROBE)
    late.flip()
    with late:
        assert _same("embed", pending.result(timeout=60), new)
        late.rollback_trunk()
        assert _same("embed", late.embed(PROBE, timeout=60), old)
        assert late.stats()["cache_hit_returns"] == 0


# ------------------------------------------------ controller and fleet

class _Fleet:
    """Two replicas of one package behind its FleetRouter over loopback
    HTTP; the candidates resolve by name."""

    def __init__(self, package, trunks, tmp_path):
        self.package = package
        self.httpds, self.servers = [], []
        if package == "port":
            def loader(src):
                return _port(trunks[src])
        else:
            loader = trunks.__getitem__
        for i in range(2):
            if package == "port":
                srv = Server(_port(trunks["resident"]), TCFG, device="cpu",
                             candidate_loader=loader, replica_id=f"r{i}",
                             **dict(KW, max_batch=4, cache_size=0))
                httpd = make_http_server(srv, port=0)
            else:
                srv = JServer(trunks["resident"], JCFG,
                              candidate_loader=loader, replica_id=f"r{i}",
                              **dict(KW, max_batch=4, cache_size=0))
                httpd = jax_http(srv, port=0)
            srv.start()
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            self.servers.append(srv)
            self.httpds.append(httpd)
        self.events = str(tmp_path / f"{package}-router.jsonl")
        self.tele = Telemetry(events_path=self.events)
        router_cls = FleetRouter if package == "port" else JRouter
        self.router = router_cls(
            [(f"r{i}", f"http://127.0.0.1:{h.server_address[1]}")
             for i, h in enumerate(self.httpds)],
            telemetry=self.tele, health_interval_s=0, cache_size=0,
            request_timeout_s=60.0).start()

    def run(self, source, seqs):
        """A controller (sample_every 2, windows of 4, 2 required) under
        one client's traffic, each request's shadow scored before the
        next is sent, until it settles; returns (controller, its window
        verdicts)."""
        spy = _Spy(self.tele)
        cls = RolloutController if self.package == "port" else JController
        ctl = cls(self.router, telemetry=spy, source=source,
                  sample_every=2, window_requests=4, windows_required=2,
                  shadow_parity_max=1e-3)
        self.router.attach_rollout(ctl)
        ctl.start()
        for seq in seqs:
            if ctl.terminal():
                break
            status, _, _ = self.router.route(
                "/v1/embed", json.dumps({"seq": seq}).encode())
            assert status == 200
            _settle(ctl)
        ctl._worker.join(30)
        assert ctl.terminal() and not ctl._worker.is_alive()
        return ctl, spy.verdicts

    def close(self):
        self.router.drain()
        for h in self.httpds:
            h.shutdown()
            h.server_close()
        for s in self.servers:
            s.close(drain=True, timeout=60)
        self.tele.close()


class _Spy:
    """A telemetry facade that records the window verdicts it passes
    on."""

    def __init__(self, inner):
        self.inner, self.metrics, self.verdicts = inner, inner.metrics, []

    def emit(self, event, **fields):
        if event == "rollout_window":
            self.verdicts.append(fields["verdict"])
        return self.inner.emit(event, **fields)


def _settle(ctl, timeout=60.0):
    """Wait until every sampled shadow has been replayed and scored."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        st = ctl.status()
        if st["shadow_ok"] + st["shadow_failed"] == st["sampled"]:
            return
        time.sleep(0.002)
    raise AssertionError(f"shadows not scored: {ctl.status()}")


@pytest.fixture(scope="module")
def fleets(trunks, tmp_path_factory):
    path = tmp_path_factory.mktemp("fleets")
    out = {p: _Fleet(p, trunks, path) for p in ("port", "jax")}
    yield out
    for f in out.values():
        f.close()


def _traffic(n, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(AA), size=int(rng.integers(6, 40))))
            for _ in range(n)]


def test_controller_green_promotes_and_breach_rolls_back(fleets, trunks):
    seqs = _traffic(80, seed=5)
    before = [s.embed(PROBE, timeout=60) for s in fleets["port"].servers]
    got = {p: f.run("near", seqs) for p, f in fleets.items()}
    ctl, verdicts = got["port"]
    assert ctl.state == "promoted"
    assert verdicts == got["jax"][1] == ["pass", "pass"]
    fp = trunk_fingerprint(_port(trunks["near"]))
    assert [s.trunk_fp() for s in fleets["port"].servers] == [fp, fp]
    fleets["port"].router.health_tick()
    health = {r["name"]: r["trunk_fingerprint"]
              for r in fleets["port"].router.replica_status()}
    assert health == {"r0": fp, "r1": fp}
    for name, f in fleets.items():
        got[name][0].breach()
        assert got[name][0].state == "rolled_back"
        for i in range(2):
            f.router.control_forward(f"r{i}", "/v1/rollout/unload")
    for srv, want in zip(fleets["port"].servers, before):
        assert _same("embed", srv.embed(PROBE, timeout=60), want)
        assert srv.trunk_fp() == jfingerprint(trunks["resident"])
    recs = read_events(fleets["port"].events, strict=False)
    states = [r["state"] for r in recs if r["event"] == "rollout_state"]
    assert states[:3] == ["shadowing", "promoting", "promoted"]
    assert "rolled_back" in states


def test_controller_red_refuses_and_unloads(fleets, trunks):
    seqs = _traffic(80, seed=7)
    before = [s.embed(PROBE, timeout=60) for s in fleets["port"].servers]
    got = {p: f.run("far", seqs) for p, f in fleets.items()}
    ctl, verdicts = got["port"]
    assert ctl.state == got["jax"][0].state == "refused"
    assert verdicts == got["jax"][1] == ["fail", "fail"]
    for srv, want in zip(fleets["port"].servers, before):
        assert not srv.dispatcher.candidate_status()["loaded"]
        assert srv.rollout_status()["candidate_fingerprint"] is None
        assert _same("embed", srv.embed(PROBE, timeout=60), want)


# -------------------------------------------------------- heads gate

def test_heads_eval_gate_repins_frozen_and_refuses_unfrozen(tmp_path,
                                                            trunks):
    """The port's gate scores both trunks as the JAX gate does, re-pins
    the frozen head on commit, records the unfrozen head's refusal, and
    restore() puts the pin back."""
    res_fp = jfingerprint(trunks["resident"])
    cand_fp = jfingerprint(trunks["near"])
    tasks = {"frozen": JTask(kind="sequence_classification", num_outputs=3,
                             freeze_trunk=True),
             "unfrozen": JTask(kind="sequence_regression", num_outputs=1,
                               freeze_trunk=False)}
    ids = {}
    for i, (name, task) in enumerate(tasks.items()):
        hp = jft.head_init(jax.random.PRNGKey(i + 1), JCFG.model, task)
        ids[name] = JRegistry(str(tmp_path / "jax")).save(
            jax.tree.map(np.asarray, hp), task, res_fp, name=name)
        JRegistry(str(tmp_path / "port")).save(
            jax.tree.map(np.asarray, hp), task, res_fp, name=name)

    def jfor(head):
        return jbatches(8, np.random.default_rng(5), head.task.kind,
                        head.task.num_outputs, 48, 4)

    def tfor(head):
        return make_task_batches(8, np.random.default_rng(5),
                                 head.task.kind, head.task.num_outputs, 48,
                                 4)

    jgate = JGate(JRegistry(str(tmp_path / "jax")), JCFG.model, jfor,
                  trunks["resident"], trunks["near"], res_fp, cand_fp)
    treg = HeadRegistry(str(tmp_path / "port"))
    tgate = HeadsEvalGate(treg, TCFG.model, tfor,
                          _port(trunks["resident"]), _port(trunks["near"]),
                          res_fp, cand_fp)
    assert math.isclose(tgate(), jgate(), abs_tol=TOL)
    for hid, scores in jgate.scores.items():
        for arm in ("resident", "candidate"):
            assert math.isclose(tgate.scores[hid][arm], scores[arm],
                                abs_tol=TOL)
    refused = tgate.commit()
    assert [r["head_id"] for r in refused] == [ids["unfrozen"]]
    assert tgate.migrated == [ids["frozen"]]
    pins = {m["head_id"]: m["trunk_fingerprint"] for m in treg.list_heads()}
    assert pins == {ids["frozen"]: cand_fp, ids["unfrozen"]: res_fp}
    assert tgate.restore() == [ids["frozen"]]
    pins = {m["head_id"]: m["trunk_fingerprint"] for m in treg.list_heads()}
    assert pins == {ids["frozen"]: res_fp, ids["unfrozen"]: res_fp}


def test_launch_counts_from_many_threads_are_exact():
    """Replays credited from several threads at once (several servers'
    dispatch threads, a rollout's shadows) each count exactly once."""
    from proteinbert_tpu_torch.kernels import LOCAL_TRACK
    from proteinbert_tpu_torch.kernels.build import credit

    before = LOCAL_TRACK.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            credit({LOCAL_TRACK: 3}) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert LOCAL_TRACK.launches - before == 16 * 2000 * 3
    LOCAL_TRACK.launches = before
