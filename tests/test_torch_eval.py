"""The port's eval bracket and metric sums against the JAX package
(`train/metrics.DeviceMetricAccumulator`, `train/trainer.dispatch_eval` /
`resolve_eval`, the overlapped bracket, the `PBT_FAULT_*` drill knobs), on
the CPU at small sizes:

- the accumulator: the same 200 seeded float32 values with weights
  through JAX's and the port's, at drain_every 0, 1 and 8 — the sums bit
  for bit; the float32 sums the port's fine-tune means used before differ
  on those values (the fault this file holds repaired);
- fine-tune: `evaluate` and the epoch records are the JAX accumulator's
  means of the port's own per-batch values bit for bit, and JAX's records
  on carried weights within 1e-5;
- pretraining with `eval_every=3`, `checkpoint.every_steps=3` and an
  eval at the last step: the overlapped and the synchronous bracket give
  the same history, `eval` events and checkpointed `eval_stream`, on
  either checkpoint route, and a resume from step 3 repeats the rest;
- one `eval_bracket` span a boundary on either bracket;
- the legality gate (an eval-keyed plateau or early stopping takes the
  synchronous bracket), the CLI `evaluate --like-step` on an overlapped
  run's checkpoint, the three knob parsers against JAX's, and an
  in-process drill (a 1.0 s stall lands in its step's window; a 1.0 s
  eval stall moves no window).
"""

import copy
import dataclasses
import importlib
import json
import logging
import shutil
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.configs import FinetuneConfig as JFtCfg
from proteinbert_tpu.configs import ModelConfig as JModel
from proteinbert_tpu.configs import OptimizerConfig as JOpt
from proteinbert_tpu.configs import TaskConfig as JTask
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.heads.registry import _flatten
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.train import metrics as jmetrics
from proteinbert_tpu.train import trainer as jtrainer
from proteinbert_tpu_torch.cli.main import (
    _save_run_config, _synthetic_dataset, main as port_main,
)
from proteinbert_tpu_torch.configs import (
    FinetuneConfig, ModelConfig, OptimizerConfig, TaskConfig, get_preset,
)
from proteinbert_tpu_torch.data.dataset import make_pretrain_iterator
from proteinbert_tpu_torch.data.synthetic import make_task_batches
from proteinbert_tpu_torch.obs import Telemetry, read_events
from proteinbert_tpu_torch.train import Checkpointer
from proteinbert_tpu_torch.train import finetune as tft
from proteinbert_tpu_torch.train import metrics as tmetrics
from proteinbert_tpu_torch.train import trainer as ttrainer
from proteinbert_tpu_torch.weights import params_from_flat

torch.set_num_threads(1)

jft = importlib.import_module("proteinbert_tpu.train.finetune")

FT_TOL = 1e-5   # fine-tune records, port against JAX on carried weights
FT_MODEL = dict(local_dim=32, global_dim=64, key_dim=16, num_heads=4,
                num_blocks=2, num_annotations=64, dtype="float32")
TIMING = ("steps_per_sec", "step_ms", "residues_per_sec_per_chip", "mfu",
          "overlap_s", "ckpt_in_flight")


# ---------------------------------------------------------- accumulator

def _values(seed=0, batches=50, keys=("loss", "acc", "auroc", "p_at_k")):
    """200 seeded float32 values in [0.5, 3): one dict a batch, and each
    batch's row weight."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.5, 3.0, (batches, len(keys))).astype(np.float32)
    weights = rng.integers(1, 9, batches)
    return [dict(zip(keys, row)) for row in vals], [int(w) for w in weights]


@pytest.mark.parametrize("drain_every", [0, 1, 8])
def test_accumulator_sums_equal_jax(drain_every):
    dicts, weights = _values()
    key_fn = lambda k: f"{k}_w"   # noqa: E731
    want = jmetrics.DeviceMetricAccumulator(drain_every=drain_every)
    got = tmetrics.DeviceMetricAccumulator(drain_every=drain_every)
    for d, w in zip(dicts, weights):
        want.add({k: jnp.asarray(v) for k, v in d.items()}, weight=w,
                 key_fn=key_fn)
        got.add({k: torch.tensor(v) for k, v in d.items()}, weight=w,
                key_fn=key_fn)
    assert got.count == want.count == len(dicts)
    w_sums, g_sums = want.sums(), got.sums()
    assert list(g_sums) == list(w_sums)
    for k in w_sums:
        assert g_sums[k] == w_sums[k], k


def test_float32_means_differ_from_jax_on_those_values():
    """The fault: float32 running sums (the port's fine-tune means before
    this file) part from JAX's float64 ones on these values; the
    accumulator's means and the fine-tune `_means` do not."""
    dicts, _ = _values()
    want = jmetrics.DeviceMetricAccumulator()
    got = tmetrics.DeviceMetricAccumulator()
    for d in dicts:
        want.add({k: jnp.asarray(v) for k, v in d.items()})
        got.add({k: torch.tensor(v) for k, v in d.items()})
    j_means = {k: v / want.count for k, v in want.sums().items()}
    f32 = {k: float(sum((np.float32(d[k]) for d in dicts), np.float32(0)))
           / len(dicts) for k in dicts[0]}
    assert any(f32[k] != j_means[k] for k in j_means)
    assert tft._means(got) == j_means


def test_prefetch_then_drain_is_the_plain_drain():
    dicts, weights = _values(seed=1, batches=12)
    a = tmetrics.DeviceMetricAccumulator(drain_every=0)
    b = tmetrics.DeviceMetricAccumulator(drain_every=0)
    for d, w in zip(dicts, weights):
        a.add({k: torch.tensor(v) for k, v in d.items()}, weight=w)
        b.add({k: torch.tensor(v) for k, v in d.items()}, weight=w)
    a.prefetch()
    a.add({"loss": torch.tensor(np.float32(1.25))})   # after the prefetch
    b.add({"loss": torch.tensor(np.float32(1.25))})
    assert a.sums() == b.sums()


# ------------------------------------------------------------ fine-tune

def _ft_cfgs(kind="sequence_classification", n_out=3, epochs=2):
    opt = dict(learning_rate=1e-3, warmup_steps=0, schedule="constant")
    task = dict(kind=kind, num_outputs=n_out, epochs=epochs)
    return (JFtCfg(model=JModel(**FT_MODEL), task=JTask(**task),
                   optimizer=JOpt(**opt)),
            FinetuneConfig(model=ModelConfig(**FT_MODEL),
                           task=TaskConfig(**task),
                           optimizer=OptimizerConfig(**opt)))


@pytest.fixture(scope="module")
def ft_runs():
    """JAX's and the port's `finetune` on carried weights: 2 epochs of 6
    batches, an eval of 5 batches after each."""
    jcfg, tcfg = _ft_cfgs()
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    train = make_task_batches(6, np.random.default_rng(3),
                              tcfg.task.kind, tcfg.task.num_outputs, 48, 4)
    evals = make_task_batches(5, np.random.default_rng(4),
                              tcfg.task.kind, tcfg.task.num_outputs, 48, 4)
    jstate = jft.create_finetune_state(jax.random.PRNGKey(1), jcfg,
                                       jax.tree.map(np.asarray, jparams))
    tstate = tft.create_finetune_state(torch.Generator().manual_seed(1),
                                       tcfg, tparams, device="cpu")
    for name in _flatten(tstate.params["head"]):
        a, b = name.split("/")
        tstate.params["head"][a][b].copy_(torch.from_numpy(
            np.asarray(jstate.params["head"][a][b]).copy()))
    start = tft.create_finetune_state(torch.Generator(), tcfg,
                                      tparams, device="cpu")
    start.params = copy.deepcopy(tstate.params)
    want = jft.finetune(jcfg, lambda e: iter(train), lambda: iter(evals),
                        state=jstate)
    got = tft.finetune(tcfg, lambda e: iter(train), lambda: iter(evals),
                       state=tstate, device="cpu")
    return want, got, tcfg, train, evals, start


def test_finetune_records_match_jax(ft_runs):
    want, got, *_ = ft_runs
    assert len(got["history"]) == len(want["history"]) == 2
    for w, g in zip(want["history"], got["history"]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=FT_TOL, atol=FT_TOL,
                                       err_msg=k)
    assert got["best"]["epoch"] == want["best"]["epoch"]


def test_finetune_means_are_the_jax_accumulators(ft_runs):
    """Given the port's own per-batch values, its eval and epoch records
    are the JAX accumulator's means bit for bit: the last eval replayed
    on the final state, the first epoch's train record replayed from the
    carried start."""
    _, got, tcfg, train, evals, start = ft_runs

    def jax_means(per_batch):
        acc = jmetrics.DeviceMetricAccumulator()
        for m in per_batch:
            acc.add({k: np.float32(float(v)) for k, v in m.items()})
        return {k: v / acc.count for k, v in acc.sums().items()}

    state = got["state"]
    want = jax_means([tft.finetune_eval_step(state, b, tcfg) for b in evals])
    assert tft.evaluate(state, iter(evals), tcfg) == want
    assert {k[len("eval_"):]: v for k, v in got["history"][-1].items()
            if k.startswith("eval_")} == want
    per_step = []
    for b in train:
        start, m = tft.finetune_step(start, b, tcfg)
        per_step.append(m)
    assert {k[len("train_"):]: v for k, v in got["history"][0].items()
            if k.startswith("train_")} == jax_means(per_step)


# ---------------------------------------------------------- pretraining

def _pt_cfg(max_steps=6, overlap_eval=True, ckpt_overlap=True, **train):
    cfg = get_preset("tiny")
    train = {"log_every": 1, "eval_every": 3, **train}
    return cfg.replace(
        data=dataclasses.replace(cfg.data, seq_len=64, batch_size=4,
                                 prefetch_depth=0),
        train=dataclasses.replace(cfg.train, max_steps=max_steps,
                                  overlap_eval=overlap_eval, **train),
        checkpoint=dataclasses.replace(cfg.checkpoint, every_steps=3,
                                       overlap=ckpt_overlap,
                                       async_save=False))


@pytest.fixture(scope="module")
def pt_data():
    cfg = _pt_cfg()
    ds = _synthetic_dataset(cfg, n_min=128)   # the CLI evaluate's rows
    evals = [ds.get_batch(np.arange(s, s + 4)) for s in (0, 4)]
    return ds, evals


def _records(history):
    return [{k: v for k, v in h.items()
             if not k.startswith("window_") and k not in TIMING}
            for h in history]


def _run(cfg, pt_data, directory, events):
    ds, evals = pt_data
    ck = Checkpointer(str(directory), async_save=False)
    tele = Telemetry(events_path=str(events))
    try:
        out = ttrainer.pretrain(
            cfg, lambda skip: make_pretrain_iterator(ds, 4, seed=1,
                                                     skip_batches=skip),
            checkpointer=ck, eval_batches=lambda: iter(evals),
            telemetry=tele, device="cpu")
    finally:
        ck.close()
        tele.close()
    evs = [e for e in read_events(str(events), strict=True)
           if e["event"] == "eval"]
    return out, evs


def _eval_stream(directory, step):
    with open(directory / str(step) / "data.json") as f:
        return json.load(f).get("eval_stream")


@pytest.mark.parametrize("ckpt_overlap", [True, False])
def test_overlapped_bracket_equals_the_synchronous_one(pt_data, tmp_path,
                                                       ckpt_overlap):
    runs = {}
    for ov in (False, True):
        d = tmp_path / f"ov{int(ov)}"
        runs[ov] = (*_run(_pt_cfg(overlap_eval=ov, ckpt_overlap=ckpt_overlap),
                          pt_data, d, tmp_path / f"ev{int(ov)}.jsonl"), d)
    (sync, s_evs, s_dir), (over, o_evs, o_dir) = runs[False], runs[True]
    assert _records(over["history"]) == _records(sync["history"])
    assert [h["step"] for h in over["history"] if "eval_loss" in h] == [3, 6]
    assert [(e["step"], e["metrics"]) for e in o_evs] \
        == [(e["step"], e["metrics"]) for e in s_evs]
    assert all(e.get("overlapped") is True for e in o_evs)
    assert not any("overlapped" in e for e in s_evs)
    for step in (3, 6):
        assert _eval_stream(o_dir, step) == _eval_stream(s_dir, step)
        assert _eval_stream(o_dir, step)["last"] is not None


def test_overlapped_run_resumes_identically(pt_data, tmp_path):
    full, _ = _run(_pt_cfg(), pt_data, tmp_path / "full",
                   tmp_path / "full.jsonl")
    part = tmp_path / "part"
    part.mkdir()
    shutil.copytree(tmp_path / "full" / "3", part / "3")
    resumed, _ = _run(_pt_cfg(), pt_data, part, tmp_path / "part.jsonl")
    tail = [h for h in _records(full["history"]) if h["step"] > 3]
    assert _records(resumed["history"]) == tail
    assert _eval_stream(part, 6) == _eval_stream(tmp_path / "full", 6)


@pytest.mark.parametrize("overlap", [False, True])
def test_both_brackets_emit_the_eval_bracket_span(pt_data, overlap):
    """The documented span set on either route: one `eval_bracket` a
    boundary, keyed by its step (on the overlapped route it times the
    dispatch, the bracket's host time there)."""
    ds, evals = pt_data
    tele = Telemetry(spans=True)
    ttrainer.pretrain(
        _pt_cfg(overlap_eval=overlap),
        lambda skip: make_pretrain_iterator(ds, 4, seed=1,
                                            skip_batches=skip),
        eval_batches=lambda: iter(evals), telemetry=tele, device="cpu")
    spans = [e for e in tele.spans.to_perfetto()["traceEvents"]
             if e["ph"] == "X"]
    assert [e["args"]["step"] for e in spans
            if e["name"] == "eval_bracket"] == [3, 6]
    assert not any(e["name"].startswith("eval_") and e["name"]
                   != "eval_bracket" for e in spans)


@pytest.mark.parametrize("gate", ["plateau", "early_stop"])
def test_legality_gate_takes_the_synchronous_bracket(pt_data, tmp_path,
                                                     gate):
    cfg = _pt_cfg()
    if gate == "plateau":
        cfg = cfg.replace(optimizer=dataclasses.replace(
            cfg.optimizer, plateau_metric="eval_loss"))
    else:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, early_stop_patience=10))
    assert cfg.train.overlap_eval
    out, evs = _run(cfg, pt_data, tmp_path / "run", tmp_path / "ev.jsonl")
    assert [e["step"] for e in evs if not e.get("seed")] == [3, 6]
    assert not any("overlapped" in e for e in evs)


def test_cli_evaluate_like_step_reproduces_an_overlapped_record(
        pt_data, tmp_path, capsys):
    """`evaluate --like-step 6 --max-batches 2` on the overlapped run's
    directory gives its step-6 eval record (the CLI rounds to 6
    places)."""
    cfg = _pt_cfg()
    run = tmp_path / "run"
    out, _ = _run(cfg, pt_data, run, tmp_path / "ev.jsonl")
    _save_run_config(cfg, str(run))
    capsys.readouterr()
    # The verb attaches its log handler to this test's stdout: restore
    # the package logger after it.
    pkg = logging.getLogger("proteinbert_tpu_torch")
    saved = (list(pkg.handlers), pkg.propagate, pkg.level)
    try:
        assert port_main(["--device", "cpu", "evaluate", "--pretrained",
                          str(run), "--like-step", "6",
                          "--max-batches", "2"]) == 0
    finally:
        pkg.handlers[:], pkg.propagate = saved[0], saved[1]
        pkg.setLevel(saved[2])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    (rec,) = [h for h in out["history"] if h["step"] == 6 and
              "eval_loss" in h]
    assert (got["step"], got["batches"], got["rows"]) == (6, 2, 8)
    for k, v in rec.items():
        if k.startswith("eval_"):
            assert got[k[len("eval_"):]] == round(v, 6), k


# ------------------------------------------------------------ the knobs

SPECS = ["27:8.5", "garbage", "0:1", "3:-1", "3:nan", "3:inf", "5", None]


@pytest.mark.parametrize("spec", SPECS)
def test_knob_parsers_match_jax(spec, monkeypatch, caplog):
    for name in ("PBT_FAULT_STALL_AT", "PBT_FAULT_EVAL_STALL"):
        if spec is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, spec)
    pairs = (("_fault_stall_spec", "PBT_FAULT_STALL_AT"),
             ("_fault_eval_stall_secs", "PBT_FAULT_EVAL_STALL"))
    for fn, name in pairs:
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            want = getattr(jtrainer, fn)()
            j_warn = [r.getMessage() for r in caplog.records]
            caplog.clear()
            got = getattr(ttrainer, fn)()
            t_warn = [r.getMessage() for r in caplog.records]
        assert got == want, (fn, spec)
        assert t_warn == j_warn
        assert bool(t_warn) == (spec is not None and want is None), t_warn
        if t_warn:
            assert t_warn == [f"ignoring malformed {name}={spec!r}"]
    parse = (ttrainer._fault_stall_spec(), ttrainer._fault_eval_stall_secs())
    if spec == "27:8.5":
        assert parse == ((27, 8.5), None)
    elif spec == "5":
        assert parse == (None, 5.0)


def _drill(cfg, pt_data, tmp_path, monkeypatch, caplog, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ds, evals = pt_data
    with caplog.at_level(logging.WARNING):
        out = ttrainer.pretrain(
            cfg, make_pretrain_iterator(ds, 4, seed=1),
            eval_batches=lambda: iter(evals), device="cpu")
    assert "FAULT INJECTION ACTIVE" in caplog.text
    # Each logged window's wall: its step ms times the steps it spans.
    walls = [h["window_step_ms"] * cfg.train.log_every / 1e3
             for h in out["history"] if "window_step_ms" in h]
    return walls


def test_drill_stall_lands_in_its_window(pt_data, tmp_path, monkeypatch,
                                         caplog):
    """A 1.0 s stall at the top of step 8 is the 7-9 window's, and makes
    it the slowest window by more than 0.5 s."""
    cfg = _pt_cfg(max_steps=15, log_every=3, eval_every=0)
    walls = _drill(cfg, pt_data, tmp_path, monkeypatch, caplog,
                   PBT_FAULT_STALL_AT="8:1.0")
    assert len(walls) == 5   # windows ending at 3, 6, 9, 12, 15
    slow = int(np.argmax(walls))
    assert slow == 2, walls
    others = walls[:2] + walls[3:]
    assert walls[2] - max(others) > 0.5, walls


@pytest.mark.parametrize("overlap_eval", [False, True])
def test_drill_eval_stall_moves_no_window(pt_data, tmp_path, monkeypatch,
                                          caplog, overlap_eval):
    """A 1.0 s stall inside every eval bracket (evals at 6 and 12) is
    discounted on either route: no window stands out by 0.5 s."""
    cfg = _pt_cfg(max_steps=15, log_every=3, eval_every=6,
                  overlap_eval=overlap_eval)
    walls = _drill(cfg, pt_data, tmp_path, monkeypatch, caplog,
                   PBT_FAULT_EVAL_STALL="1.0")
    assert len(walls) == 5
    med = statistics.median(walls)
    assert max(walls) - med < 0.5, walls
