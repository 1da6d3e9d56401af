"""The port's request traces, SLOs and serve telemetry on the CPU, against
the JAX package: `serve/trace.py` and `obs/slo.py` are the JAX modules
but for docstrings, imports and the profiler hook (syntax trees
compared); the SLO evaluator and the trace decomposition give the JAX
numbers under a fake clock; the torch profile trigger writes a trace; and
one scripted request sequence on a fake clock makes the port `Server`
emit the JAX `Server`'s event kinds, in the same order, with the same
field sets, on the same weights — both streams valid under both
packages' readers."""

import ast
import dataclasses
import json
import pathlib
import time

import jax
import pytest
import torch

from proteinbert_tpu.configs import get_preset as jax_preset
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu import obs as jobs
from proteinbert_tpu.obs import slo as jslo
from proteinbert_tpu.serve import trace as jtrace
from proteinbert_tpu.serve.server import Server as JServer
from proteinbert_tpu_torch import obs
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.obs import slo
from proteinbert_tpu_torch.serve import trace
from proteinbert_tpu_torch.serve.errors import SequenceTooLongError
from proteinbert_tpu_torch.serve.server import Server
from proteinbert_tpu_torch.weights import params_from_flat

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUCKETS = (32, 64, 128)


def _body(source: str, drop=()):
    """The module's AST dump without docstrings, imports and the named
    top-level classes and functions (and methods, as Class.method)."""
    tree = ast.parse(source)
    tree.body = [n for n in tree.body
                 if not (isinstance(n, (ast.FunctionDef, ast.ClassDef))
                         and n.name in drop)]
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef):
            cls.body = [n for n in cls.body if not (
                isinstance(n, ast.FunctionDef)
                and f"{cls.name}.{n.name}" in drop)]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:]
        node.body = [n for n in body if not isinstance(
            n, (ast.Import, ast.ImportFrom))] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module,drop,swap", [
    ("serve/trace.py", (), ()),
    ("obs/slo.py", ("_TorchTrace", "ProfileTrigger._profiler"),
     (("torch is not live", "jax is not live"),)),
    ("mapper/store.py", (), ()),
    ("mapper/faults.py", (), ()),
    ("index/store.py", ("_read_shard_rows",), ()),
])
def test_copies_differ_from_jax_only_in_docstrings_imports_and_hook(
        module, drop, swap):
    """trace.py, mapper/store.py and mapper/faults.py are copies; slo.py
    swaps its profiler hook (`ProfileTrigger._profiler` and the
    `_TorchTrace` it returns, left out of the comparison; the log line
    names torch); index/store.py locates a shard's vectors by their
    running count (`_read_shard_rows`, left out; test_torch_index.py holds
    its rows to the store's)."""
    want = (ROOT / "proteinbert_tpu" / module).read_text()
    got = (ROOT / "proteinbert_tpu_torch" / module).read_text()
    for a, b in swap:
        got = got.replace(a, b)
    assert _body(got, drop) == _body(want, drop)
    jax_only = ast.parse(want)
    assert {n.name for n in jax_only.body if isinstance(n, ast.ClassDef)} \
        <= {n.name for n in ast.parse(got).body
            if isinstance(n, ast.ClassDef)}


@pytest.mark.parametrize("name", ["quantize_rows_int8",
                                  "dequantize_rows_int8"])
def test_row_quantizers_are_the_jax_functions(name):
    """The index builder's row quantizers in the port's parallel/quant.py
    are the JAX functions but for docstrings and imports."""
    def pick(module):
        tree = ast.parse((ROOT / module).read_text())
        (fn,) = [n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == name]
        return _body(ast.unparse(ast.Module(body=[fn], type_ignores=[])))

    assert pick("proteinbert_tpu_torch/parallel/quant.py") == pick(
        "proteinbert_tpu/parallel/quant.py")


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


@pytest.mark.parametrize("pkg", [jslo, slo], ids=["jax", "port"])
def test_slo_burn_rates_and_breach(pkg):
    """The same objectives and completions give the same status, under a
    fake clock, in both packages."""
    clock = FakeClock()
    breaches = []
    ev = pkg.SLOEvaluator(
        pkg.parse_slos(["kind=latency,threshold_ms=100,target=0.9,"
                        "window_s=60",
                        "kind=error_rate,target=0.95,window_s=60"]),
        clock=clock, on_breach=lambda name, st: breaches.append(name),
        breach_cooldown_s=0.0)
    for i in range(20):
        clock.advance(1.0)
        ev.observe("ok" if i % 4 else "error", 0.05 if i % 3 else 0.2,
                   stages={"queue": 0.01, "execute": 0.04})
    status = ev.status()
    if pkg is slo:
        jev = jslo.SLOEvaluator(
            jslo.parse_slos(["kind=latency,threshold_ms=100,target=0.9,"
                             "window_s=60",
                             "kind=error_rate,target=0.95,window_s=60"]),
            clock=FakeClock(), breach_cooldown_s=0.0)
        jclock = jev.clock
        for i in range(20):
            jclock.advance(1.0)
            jev.observe("ok" if i % 4 else "error",
                        0.05 if i % 3 else 0.2,
                        stages={"queue": 0.01, "execute": 0.04})
        assert json.dumps(status, sort_keys=True) == json.dumps(
            jev.status(), sort_keys=True)
    assert set(status) == {o.name for o in ev.objectives}
    assert all(st["burn_rate"] > 1.0 for st in status.values())
    assert breaches  # both objectives burn past 1


def test_trace_stages_tile_the_request_as_in_jax():
    def run(mod):
        t = mod.RequestTrace("r-1", "embed", 10.0, sampled=True)
        t.mark_enqueued(10.001)
        t.mark_ingested(10.002)
        t.mark_popped(10.010)
        t.mark_run(10.011, 10.020)
        t.mark_batch(32, 4, 3, pad_fraction=0.25, prep_s=0.001,
                     device_s=0.008)
        assert t.finish("ok", 10.021, None)
        assert not t.finish("error", 10.5, None)   # sealed once
        return t.stages(), t.event_fields(stages=t.stages())

    (stages, fields), (jstages, jfields) = run(trace), run(jtrace)
    assert stages == jstages and fields == jfields
    assert abs(sum(stages.values()) - 0.021) < 1e-9
    assert [trace.stride_sampled(n, 0.25) for n in range(1, 9)] == [
        jtrace.stride_sampled(n, 0.25) for n in range(1, 9)]


def test_profile_trigger_records_with_the_torch_profiler(tmp_path):
    """On a breach the port's trigger starts a torch.profiler capture
    (CPU activity here) and its stop writes a Chrome trace into the
    directory; a second breach inside the cooldown captures nothing."""
    import torch

    clock = FakeClock()
    trig = slo.ProfileTrigger(str(tmp_path / "prof"), duration_s=0.0,
                              cooldown_s=300.0, clock=clock)
    prof = trig._profiler()
    assert isinstance(prof, slo._TorchTrace)
    prof.start_trace(str(tmp_path / "direct"))
    torch.ones(4).sum()
    prof.stop_trace()
    written = list((tmp_path / "direct").glob("slo_profile_*.json"))
    assert len(written) == 1
    assert "traceEvents" in json.loads(written[0].read_text())
    trig("p99", {"burn_rate": 3.0})
    trig("p99", {"burn_rate": 3.0})          # cooldown: ignored
    assert len(trig.captures) == 1
    for _ in range(500):                     # the timer thread stops it
        if not trig._active:
            break
        time.sleep(0.01)
    assert not trig._active
    assert list((tmp_path / "prof").glob("slo_profile_*.json"))


def test_slo_names_and_server_slo_status(tmp_path):
    """The SLO half is exported; a Server with objectives reports them in
    stats()["slo"] and times every batch."""
    for name in ("SLObjective", "SLOEvaluator", "ExemplarHistogram",
                 "ProfileTrigger", "parse_slo", "parse_slos"):
        assert getattr(obs, name) is getattr(slo, name)
    cfg = get_preset("tiny")
    import torch

    from proteinbert_tpu_torch.models.proteinbert import init

    params = init(cfg.model, torch.Generator().manual_seed(0), device="cpu")
    tele = obs.Telemetry()
    srv = Server(params, cfg, device="cpu", buckets=BUCKETS, warm_kinds=(),
                 telemetry=tele, cache_size=0, max_wait_s=0.001,
                 slos=["kind=latency,threshold_ms=60000,target=0.5",
                       "kind=latency,stage=execute,threshold_ms=60000,"
                       "target=0.5"])
    assert srv.scheduler.time_batches
    with srv:
        srv.embed("MKTAYIAKQR", timeout=60)
    status = srv.stats()["slo"]
    assert set(status) == {o.name for o in srv.slo.objectives}
    with pytest.raises(ValueError, match="tracing"):
        Server(params, cfg, device="cpu", warm_kinds=(),
               slos=["kind=latency,stage=execute,threshold_ms=5,"
                     "target=0.5"])    # NULL telemetry: no traces


# ------------------------------------------- event parity with JAX

@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jax_preset("tiny"), get_preset("tiny")
    jparams = jmodel.init(jax.random.PRNGKey(6), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


def _script(srv, clock, window):
    """One request sequence, driven by hand on the fake clock: three kinds,
    a deadline that expires, a too-long rejection, a cache hit, a queue
    overflow, drain."""
    srv.scheduler.start = lambda: None   # poll() by hand
    srv.start()
    srv.submit("embed", "MKTAYIAKQR")
    srv.submit("predict_go", "ACDEFGHIKLMNPQRSTVWY", top_k=3)
    srv.submit("predict_residues", "MK?AYIA?QR")
    srv.submit("embed", "GGGG", deadline_s=0.5)
    with pytest.raises(Exception, match="exceeds the model window") as e:
        srv.submit("predict_residues", "A" * window + "?")
    assert type(e.value).__name__ == SequenceTooLongError.__name__
    clock.advance(1.0)
    while srv.scheduler.poll():
        pass
    srv.submit("embed", "MKTAYIAKQR")    # cache hit
    for seq in ("AAAA", "CCCCC", "DDDDDD", "EEEEEEE", "FFFFFFFF"):
        srv.submit("embed", seq)         # depth 4: the first is evicted
    clock.advance(1.0)
    while srv.scheduler.poll():
        pass
    assert srv.drain(timeout=30)


def _events(server_cls, params, cfg, path, **kw):
    tele = (obs if server_cls is Server else jobs).Telemetry(
        events_path=str(path))
    clock = FakeClock()
    srv = server_cls(params, cfg, buckets=BUCKETS, max_batch=4,
                     max_wait_s=0.01, queue_depth=4, cache_size=8,
                     warm_kinds=(), telemetry=tele, clock=clock,
                     pipeline_depth=1, **kw)
    _script(srv, clock, cfg.data.seq_len - 2)
    tele.close()
    return srv


def test_server_events_match_jax_kinds_order_and_fields(weights, tmp_path):
    jcfg, tcfg, jparams, tparams = weights
    _events(JServer, jparams, jcfg, tmp_path / "jax.jsonl")
    srv = _events(Server, tparams, tcfg, tmp_path / "port.jsonl",
                  device="cpu")
    streams = {}
    for name in ("jax", "port"):
        path = str(tmp_path / f"{name}.jsonl")
        recs = obs.read_events(path, strict=True)
        assert len(jobs.read_events(path, strict=True)) == len(recs)
        for rec in recs:
            obs.validate_record(rec)
            jobs.validate_record(rec)
        streams[name] = recs
    jrecs, precs = streams["jax"], streams["port"]
    assert [r["event"] for r in precs] == [r["event"] for r in jrecs]
    assert [set(r) for r in precs] == [set(r) for r in jrecs]
    kinds = [r["event"] for r in precs]
    assert kinds[0] == "serve_start" and kinds[-1] == "serve_end"
    for event in ("serve_batch", "serve_reject", "serve_request"):
        assert event in kinds

    def values(recs, event, keys):
        return [tuple(r.get(k) for k in keys) for r in recs
                if r["event"] == event]

    for event, keys in (
            ("serve_request", ("kind", "outcome", "request_id",
                               "bucket_len", "batch_class", "rows",
                               "cache", "sampled")),
            ("serve_reject", ("reason", "kind", "queue_depth")),
            ("serve_batch", ("kind", "bucket_len", "rows", "batch_class",
                             "pad_fraction"))):
        assert values(precs, event, keys) == values(jrecs, event, keys)
    outcomes = [r["outcome"] for r in precs if r["event"] == "serve_request"]
    assert sorted(set(outcomes)) == ["cache_hit", "evicted", "expired",
                                     "ok", "rejected"]
    end = precs[-1]
    assert end["outcome"] == "drained"
    assert end["stats"]["pipeline"]["depth"] == 1
    assert end["stats"]["rejected"] == jrecs[-1]["stats"]["rejected"]
    assert srv.stats()["queue_wait"]["count"] == jrecs[-1]["stats"][
        "queue_wait"]["count"]


def test_server_metrics_carry_the_serve_instruments(weights, tmp_path):
    """The registry holds the JAX Server's instruments with the JAX
    values for the scripted sequence."""
    jcfg, tcfg, jparams, tparams = weights
    # The port's blocks take the routes JAX takes under use_pallas, and
    # count them as JAX does there (the kernel route counters).
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model,
                                                  use_pallas=True))
    got = {}
    for name, cls, params, cfg, kw in (
            ("jax", JServer, jparams, jcfg, {}),
            ("port", Server, tparams, tcfg, {"device": "cpu"})):
        srv = _events(cls, params, cfg, tmp_path / f"{name}.jsonl", **kw)
        got[name] = srv.tele.metrics.snapshot()
    # Every JAX counter (the neighbours' funnel included) is a port
    # counter, equal, but for one label: K2 covers the attention JAX's
    # gate sends to XLA at this width (C=32), so the port counts those
    # decisions pallas/dense where JAX counts reference/unsupported_shape.
    port_c, jax_c = got["port"]["counters"], dict(got["jax"]["counters"])
    metric = "attention_kernel_path_total"
    jax_c[f'{metric}{{path="pallas",reason="dense"}}'] = jax_c.pop(
        f'{metric}{{path="reference",reason="unsupported_shape"}}')
    assert port_c and port_c == jax_c
    assert any("neighbors_requests_total" in k for k in port_c)
    for h in ("serve_latency_seconds", "serve_queue_wait_seconds",
              "serve_batch_rows", "serve_batch_seconds",
              "serve_finalize_seconds"):
        assert (got["port"]["histograms"][h]["count"]
                == got["jax"]["histograms"][h]["count"]), h
    for g in ("serve_queue_depth", "serve_batch_occupancy",
              "serve_cache_hit_rate", "serve_inflight_batches",
              "serve_overlap_ratio"):
        assert g in got["port"]["gauges"], g
    assert set(got["port"]["gauges"]) <= set(got["jax"]["gauges"]) | {
        "serve_executable_count"}
