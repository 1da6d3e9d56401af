"""The port's telemetry (`proteinbert_tpu_torch.obs`) on the CPU — the
counterparts of the JAX package's tests/test_obs.py for the copied
modules (event schema round trip, metrics registry, span tracing, flight
recorder) — and its parity with the JAX package: each copy (the obs
modules, train/resilience.py, serve/cache.py, serve/fleet.py,
rollout/controller.py) is its JAX module but for docstrings, imports and
the profiler hook; the port's streams validate under both packages'
validators; a short `pretrain` emits a stream whose `step` metrics have
the JAX stream's keys; the packed iterator fills the registry with the
JAX iterator's names and values."""

import ast
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from proteinbert_tpu import obs as jobs
from proteinbert_tpu_torch import obs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ the copies

def _body(source: str, drop=()):
    """The module's AST dump without docstrings, imports and the named
    top-level functions."""
    tree = ast.parse(source)
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.FunctionDef) and n.name in drop)]
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


@pytest.mark.parametrize("module", [
    "obs/events.py", "obs/flight.py", "obs/metrics.py", "obs/tracing.py",
    "train/resilience.py", "serve/cache.py", "serve/fleet.py",
    "rollout/controller.py", "obs/diagnose.py"])
def test_copies_differ_from_jax_only_in_docstrings_imports_and_hook(module):
    """A copy is its JAX module but for docstrings and imports; tracing
    also swaps its profiler hook (`_jax_annotation` → `_torch_annotation`,
    the one function left out of the comparison)."""
    want = (ROOT / "proteinbert_tpu" / module).read_text()
    got = (ROOT / "proteinbert_tpu_torch" / module).read_text()
    got = got.replace("_torch_annotation", "_jax_annotation")
    assert _body(got, {"_jax_annotation"}) == _body(want,
                                                    {"_jax_annotation"})


def test_obs_facade_is_the_jax_facade():
    """Telemetry, _NullTelemetry, NULL and as_telemetry as in the JAX
    `obs/__init__.py`, and the same exported names (the SLO half
    included)."""
    def pick(path):
        tree = ast.parse(path.read_text())
        keep = [n for n in tree.body
                if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                or (isinstance(n, ast.Assign)
                    and n.targets[0].id in ("NULL", "_NULL_CTX"))]
        return _body(ast.unparse(ast.Module(body=keep, type_ignores=[])))

    assert pick(ROOT / "proteinbert_tpu_torch/obs/__init__.py") == pick(
        ROOT / "proteinbert_tpu/obs/__init__.py")
    assert set(obs.__all__) == set(jobs.__all__)
    assert obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION == 1
    assert obs.EVENT_FIELDS == jobs.EVENT_FIELDS


# ------------------------------------------------------------- events

def test_every_event_type_roundtrips_both_validators(tmp_path):
    """Each event type → the port's EventLog → JSONL → read back, valid
    under the port's and the JAX package's validate_record and through
    the JAX validator tool."""
    path = tmp_path / "ev.jsonl"
    log = obs.EventLog(str(path))
    for event in sorted(obs.EVENT_FIELDS):
        example = obs.make_example(event)
        payload = {k: v for k, v in example.items()
                   if k not in ("v", "event", "seq", "t")}
        assert log.emit(event, **payload) is not None
    log.close()
    recs = obs.read_events(str(path), strict=True)
    assert [r["event"] for r in recs] == sorted(obs.EVENT_FIELDS)
    assert [r["seq"] for r in recs] == list(range(len(recs)))
    for r in recs:
        jobs.validate_record(r)
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "validate_events.py"),
         str(path)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 errors" in out.stdout


def test_validator_rejects_a_record_missing_a_field():
    bad = {"v": 1, "event": "step", "seq": 0, "t": 0.0}
    for validate in (obs.validate_record, jobs.validate_record):
        with pytest.raises(ValueError, match="missing required field"):
            validate(bad)
    with pytest.raises(ValueError, match="schema version"):
        obs.validate_record({**obs.make_example("note"), "v": 2})


def test_torn_tail_is_skipped_not_fatal(tmp_path):
    path = tmp_path / "ev.jsonl"
    log = obs.EventLog(str(path))
    log.emit("note", source="t")
    log.emit("note", source="t")
    log.close()
    with open(path, "a") as f:
        f.write('{"v": 1, "event": "note", "se')
    assert len(obs.read_events(str(path), strict=True)) == 2
    with open(path, "a") as f:
        f.write("\n" + json.dumps(obs.make_example("note")) + "\n")
    with pytest.raises(ValueError):
        obs.read_events(str(path), strict=True)
    assert len(obs.read_events(str(path))) == 3


def test_emit_survives_record_key_collision(tmp_path):
    log = obs.EventLog(str(tmp_path / "ev.jsonl"))
    assert log.emit("note", source="x", t=123.0) is None
    assert log.emit("note", source="x", seq=7) is None
    assert log.emit("note", source="x") is not None
    log.close()
    t = obs.Telemetry()
    assert t.emit("note", source="x", t=123.0) is None
    assert t.emit("note", source="x") is not None


def test_sanitize_makes_nan_numpy_and_torch_json_safe():
    rec = obs.sanitize({"loss": float("nan"), "inf": float("inf"),
                        "np": np.float32(1.5), "arr": (1, 2),
                        "t": torch.tensor(2.5),
                        "nested": {"x": float("-inf")}})
    assert rec == {"loss": None, "inf": None, "np": 1.5, "arr": [1, 2],
                   "t": 2.5, "nested": {"x": None}}
    json.dumps(rec)


def test_emit_never_raises_on_bad_payload(tmp_path):
    log = obs.EventLog(str(tmp_path / "ev.jsonl"))
    assert log.emit("step", step=1) is None
    assert log.emit("no_such_event") is None
    assert log.emit("step", step=1, metrics={"a": 1}) is not None
    log.close()
    assert len(obs.read_events(str(tmp_path / "ev.jsonl"),
                               strict=True)) == 1


# ------------------------------------------------------------ metrics

def test_metrics_registry_instruments_and_exports(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("steps_total").inc(5)
    reg.gauge("mfu", window="cum").set(0.5)
    h = reg.histogram("stage_s")
    for v in (1.0, 3.0, 2.0):
        h.observe(v)
    with reg.timer("phase"):
        pass
    snap = reg.snapshot()
    assert snap["counters"]["steps_total"] == 5
    assert snap["gauges"]['mfu{window="cum"}'] == 0.5
    assert snap["histograms"]["stage_s"]["count"] == 3
    assert snap["histograms"]["stage_s"]["max"] == 3.0
    assert snap["histograms"]["phase"]["count"] == 1
    text = reg.prometheus_text()
    assert "# TYPE pbt_steps_total counter" in text
    assert 'pbt_mfu{window="cum"} 0.5' in text
    assert "pbt_stage_s_sum 6" in text
    prom = tmp_path / "metrics.prom"
    reg.write_prometheus(str(prom))
    assert prom.read_text() == text
    reg.write_snapshot(str(tmp_path / "snap.jsonl"))
    line = json.loads((tmp_path / "snap.jsonl").read_text())
    assert line["counters"]["steps_total"] == 5


def test_disabled_registry_and_null_facade_are_inert():
    reg = obs.MetricsRegistry(enabled=False)
    reg.counter("c").inc()
    reg.gauge("g").set(1)
    reg.histogram("h").observe(1)
    with reg.timer("t"):
        pass
    reg.set_many({"a": 1.0})
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}
    assert obs.as_telemetry(None) is obs.NULL
    assert obs.NULL.enabled is False
    assert obs.NULL.emit("step", step=1, metrics={}) is None
    with obs.NULL.span("anything"):
        pass
    assert obs.NULL.dump_flight("reason") is None
    tele = obs.Telemetry(metrics=False)
    assert obs.as_telemetry(tele) is tele


# ------------------------------------------------------------ tracing

def test_span_collector_dump_feeds_trace_attribution(tmp_path):
    col = obs.SpanCollector()
    with obs.span("outer", collector=col):
        with obs.span("inner", collector=col, step=3):
            pass
    assert len(col) == 2
    names = {s["name"]: s for s in col.to_perfetto()["traceEvents"]
             if s["ph"] == "X"}
    assert names["inner"]["args"]["depth"] == 1
    assert names["inner"]["args"]["step"] == 3
    path = col.dump(str(tmp_path / "spans.trace.json"))
    spec = importlib.util.spec_from_file_location(
        "trace_attribution", ROOT / "tools" / "trace_attribution.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(mod.parse_trace(path)) == {"outer", "inner"}


def test_spans_reach_a_live_torch_profiler_only():
    from proteinbert_tpu_torch.obs import tracing

    assert isinstance(tracing._torch_annotation("x"),
                      type(tracing.contextlib.nullcontext()))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("pbt_span_probe", step=4):
            torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "pbt_span_probe" in names


# ------------------------------------------------------------- flight

def test_flight_recorder_ring_and_dump(tmp_path):
    fr = obs.FlightRecorder(capacity=3, directory=str(tmp_path))
    for i in range(5):
        fr.record(obs.make_record("note", seq=i, t=float(i), source="t"))
    assert [r["seq"] for r in fr.snapshot()] == [2, 3, 4]
    path = fr.dump("unit_test")
    assert path == obs.flight_path(str(tmp_path))
    payload = json.load(open(path))
    obs.validate_flight_dump(payload)
    jobs.validate_flight_dump(payload)
    assert payload["reason"] == "unit_test"


def test_flight_excepthook_dumps_then_defers(tmp_path):
    fr = obs.FlightRecorder(capacity=8, directory=str(tmp_path))
    fr.record(obs.make_record("note", seq=0, t=0.0, source="t"))
    seen = []
    prev = sys.excepthook
    sys.excepthook = lambda *a: seen.append(a)
    try:
        fr.install_excepthook()
        sys.excepthook(RuntimeError, RuntimeError("boom"), None)
        assert seen, "previous hook was not chained"
        payload = json.load(open(obs.flight_path(str(tmp_path))))
        obs.validate_flight_dump(payload)
        assert payload["reason"] == "unhandled_RuntimeError"
    finally:
        fr.uninstall_excepthook()
        sys.excepthook = prev


# ------------------------------------------------- trainer end to end

def _configs(mod, tmp_path):
    return mod.PretrainConfig(
        model=mod.ModelConfig(local_dim=16, global_dim=32, key_dim=8,
                              num_heads=4, num_blocks=1, num_annotations=64,
                              dtype="float32"),
        data=mod.DataConfig(seq_len=64, batch_size=8),
        optimizer=mod.OptimizerConfig(warmup_steps=4),
        checkpoint=mod.CheckpointConfig(directory=str(tmp_path / "ck"),
                                        every_steps=4, overlap=False),
        train=mod.TrainConfig(max_steps=8, log_every=2, eval_every=4))


def test_pretrain_emits_a_stream_with_the_jax_stream_keys(tmp_path):
    """A short port run with a checkpointer and an eval stream emits one
    JSONL that both validators accept, holds every lifecycle record, and
    whose `step` metrics carry exactly the JAX trainer's keys on the same
    config (the port reports no MFU on the CPU, so `mfu` / `window_mfu`
    are the JAX stream's only extra keys); the JAX diagnose summary of the
    port's stream reads its StepTimer's rate."""
    from proteinbert_tpu import configs as jconfigs
    from proteinbert_tpu.data import dataset as jds
    from proteinbert_tpu.data.synthetic import make_random_proteins as jmrp
    from proteinbert_tpu.obs.diagnose import summarize
    from proteinbert_tpu.train import Checkpointer as JCheckpointer
    from proteinbert_tpu.train.trainer import pretrain as jpretrain
    from proteinbert_tpu_torch import configs as tconfigs
    from proteinbert_tpu_torch.data.dataset import (
        InMemoryPretrainingDataset, make_pretrain_iterator,
    )
    from proteinbert_tpu_torch.data.synthetic import make_random_proteins
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.trainer import pretrain

    steps = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        cfg = _configs(tconfigs if name == "port" else jconfigs, d)
        tele = (obs if name == "port" else jobs).Telemetry(
            events_path=str(d / "ev.jsonl"))
        if name == "port":
            seqs, ann = make_random_proteins(64, np.random.default_rng(0),
                                             num_annotations=64)
            ds = InMemoryPretrainingDataset(seqs, ann, 64)
            ck = Checkpointer(cfg.checkpoint.directory, async_save=False)
            out = pretrain(
                cfg, lambda skip: make_pretrain_iterator(ds, 8, seed=0),
                checkpointer=ck,
                eval_batches=lambda: make_pretrain_iterator(
                    ds, 8, seed=1, num_epochs=1),
                telemetry=tele, device="cpu")
        else:
            seqs, ann = jmrp(64, np.random.default_rng(0),
                             num_annotations=64)
            ds = jds.InMemoryPretrainingDataset(seqs, ann, 64)
            ck = JCheckpointer(cfg.checkpoint.directory, async_save=False)
            jpretrain(cfg, lambda skip: jds.make_pretrain_iterator(
                ds, 8, seed=0), checkpointer=ck,
                eval_batches=lambda: jds.make_pretrain_iterator(
                    ds, 8, seed=1, num_epochs=1), telemetry=tele)
        ck.close()
        tele.close()
        recs = obs.read_events(str(d / "ev.jsonl"), strict=True)
        steps[name] = [r for r in recs if r["event"] == "step"]
        if name == "port":
            port_recs, port_out, port_tele = recs, out, tele
    for r in port_recs:
        jobs.validate_record(r)
    kinds = {r["event"] for r in port_recs}
    assert {"run_start", "step", "ckpt_stage", "eval", "run_end"} <= kinds
    start = port_recs[0]
    assert start["event"] == "run_start"
    assert start["jax_version"] == "none"
    assert start["torch_version"] == torch.__version__
    assert start["mesh"] is None and start["n_chips"] == 1
    assert start["config"]["train"]["max_steps"] == 8
    assert port_recs[-1]["event"] == "run_end"
    assert port_recs[-1]["outcome"] == "completed"
    phases = [r["phase"] for r in port_recs if r["event"] == "ckpt_stage"]
    assert phases == ["save", "save"]   # steps 4 and 8
    assert len(steps["port"]) == len(steps["jax"]) == 4
    for p, j in zip(steps["port"], steps["jax"]):
        assert set(p["metrics"]) == set(j["metrics"]) - {"mfu",
                                                         "window_mfu"}
        assert "host_max_rss_bytes" in p
    s = summarize(port_recs)
    assert s["step_rate"]["steps_per_sec"] == pytest.approx(
        port_out["perf"]["steps_per_sec"], rel=0.01)
    snap = port_tele.metrics.snapshot()
    assert snap["counters"]["steps_total"] == 8
    assert "steps_per_sec" in snap["gauges"]


def test_packed_iterator_registry_matches_jax():
    """The packed iterator reports the JAX iterator's metric names and,
    on the same dataset and seed, its values (the dropped remainder
    included)."""
    from proteinbert_tpu.data import dataset as jds
    from proteinbert_tpu.data import packing as jpack
    from proteinbert_tpu.data.synthetic import make_random_proteins as jmrp
    from proteinbert_tpu_torch.data import dataset as tds
    from proteinbert_tpu_torch.data import packing as tpack
    from proteinbert_tpu_torch.data.synthetic import make_random_proteins

    snaps = []
    for mod_ds, mod_pack, make, reg in (
            (tds, tpack, make_random_proteins, obs.MetricsRegistry()),
            (jds, jpack, jmrp, jobs.MetricsRegistry())):
        seqs, ann = make(50, np.random.default_rng(4), num_annotations=8,
                         max_len=40)
        ds = mod_ds.InMemoryPretrainingDataset(seqs, ann, 64)
        n = sum(1 for _ in mod_pack.make_packed_iterator(
            ds, 4, seed=2, num_epochs=1, max_segments=4, metrics=reg))
        snaps.append((n, reg.snapshot()))
    assert snaps[0] == snaps[1]
    counters = snaps[0][1]["counters"]
    assert counters["data_packed_rows_total"] == 4 * snaps[0][0]
    assert set(counters) >= {"data_packed_segments_total",
                             "data_packed_rows_total"}
    assert 'data_pad_fraction{strategy="packed"}' in snaps[0][1]["gauges"]
