"""Fine-tuning in the port on the CPU against the JAX package on the same
inputs: the TSV loader and batcher (errors and their line numbers
included), the synthetic task batches, `models/finetune.apply` for the
three task kinds with and without a hidden layer (trunk within 1e-5,
outputs within 1e-4: the tolerances of test_torch_model.py), `task_loss`,
one float32 `finetune_step` (loss and params within 1e-5; under
`freeze_trunk` the trunk unchanged bit for bit and the clip norm the
head's alone), a resumed `finetune` equal to an uninterrupted one, and a
registered head that the JAX registry loads against the JAX trunk."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.configs import (
    FinetuneConfig as JFtCfg, ModelConfig as JModel,
    OptimizerConfig as JOpt, TaskConfig as JTask,
)
from proteinbert_tpu.data import finetune_data as jdata
from proteinbert_tpu.data.synthetic import (
    make_task_batches as jmake_task_batches,
)
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.heads.registry import (
    HeadRegistry as JRegistry, trunk_fingerprint as jfingerprint,
)
from proteinbert_tpu.models import finetune as jft
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu_torch.configs import (
    FinetuneConfig, ModelConfig, OptimizerConfig, TaskConfig,
)
from proteinbert_tpu_torch.data import finetune_data as tdata
from proteinbert_tpu_torch.data.synthetic import make_task_batches
from proteinbert_tpu_torch.heads.registry import HeadRegistry, _flatten
from proteinbert_tpu_torch.models import finetune as tft
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.obs import Telemetry, read_events
from proteinbert_tpu_torch.train import finetune as ttrain
from proteinbert_tpu_torch.train.checkpoint import Checkpointer
from proteinbert_tpu_torch.weights import params_from_flat, params_to_flat

# The JAX train package exports the function `finetune` under the module's
# name.
jtrain = importlib.import_module("proteinbert_tpu.train.finetune")

TRUNK_TOL = 1e-5
LOGIT_TOL = 1e-4
STEP_TOL = 1e-5
MODEL = dict(local_dim=32, global_dim=64, key_dim=16, num_heads=4,
             num_blocks=2, num_annotations=64, dtype="float32")
KINDS = [("token_classification", 5), ("sequence_classification", 3),
         ("sequence_regression", 1)]
SEQ_LEN = 48


@pytest.fixture(scope="module")
def trunks():
    jm, tm = JModel(**MODEL), ModelConfig(**MODEL)
    jparams = jmodel.init(jax.random.PRNGKey(0), jm)
    tparams = params_from_flat(flatten_params(jparams), tm, device="cpu")
    return jm, tm, jparams, tparams


def _close(want, got, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- data

TSV = {
    "token_classification": "# a comment\nMKTA\t0123\n\nACDE\t1,0,2,3\n"
                            + "G" * 60 + "\t" + "1" * 60 + "\n",
    "sequence_classification": "MKTA\t2\nACDEFG\t0\n",
    "sequence_regression": "MKTA\t0.25\nACDEFG\t-1.5\n",
}


@pytest.mark.parametrize("kind", sorted(TSV))
def test_load_task_tsv_and_batches_match_jax(tmp_path, kind):
    path = tmp_path / "t.tsv"
    path.write_text(TSV[kind])
    jt, jl = jdata.load_task_tsv(str(path), kind, SEQ_LEN)
    tt, tl = tdata.load_task_tsv(str(path), kind, SEQ_LEN)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    assert tl.dtype == jl.dtype and tt.dtype == jt.dtype
    for rng in (None, 3):
        jb = jdata.batch_task_data(
            jt, jl, 2, None if rng is None else np.random.default_rng(rng))
        tb = tdata.batch_task_data(
            tt, tl, 2, None if rng is None else np.random.default_rng(rng))
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    jb = jmake_task_batches(9, np.random.default_rng(1), kind, 4, SEQ_LEN, 4)
    tb = make_task_batches(9, np.random.default_rng(1), kind, 4, SEQ_LEN, 4)
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("text,kind", [
    ("MKTA\t0\t1\n", "sequence_classification"),
    ("MKTA\t0\nACDE\t012\n", "token_classification"),
    ("MKTA\tx\n", "sequence_classification"),
    ("MKTA\t1\n", "secondary_structure"),
])
def test_load_task_tsv_errors_match_jax(tmp_path, text, kind):
    path = tmp_path / "bad.tsv"
    path.write_text(text)
    with pytest.raises(ValueError) as jerr:
        jdata.load_task_tsv(str(path), kind, SEQ_LEN)
    with pytest.raises(ValueError) as terr:
        tdata.load_task_tsv(str(path), kind, SEQ_LEN)
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------- model

def _heads(jm, tm, kind, n_out, hidden):
    """A JAX head and the same weights as port tensors."""
    jtask = JTask(kind=kind, num_outputs=n_out, head_hidden_dim=hidden)
    jhead = jax.tree.map(np.asarray, jft.head_init(jax.random.PRNGKey(4),
                                                   jm, jtask))
    thead = {k: {n: torch.from_numpy(v.copy()) for n, v in d.items()}
             for k, d in jhead.items()}
    return jtask, TaskConfig(**dataclasses.asdict(jtask)), jhead, thead


def _batch(kind, n_out, seed=0, n=4):
    (b,) = jmake_task_batches(n, np.random.default_rng(seed), kind, n_out,
                              SEQ_LEN, n)
    return b


@pytest.mark.parametrize("hidden", [0, 16])
@pytest.mark.parametrize("kind,n_out", KINDS)
def test_apply_matches_jax(trunks, kind, n_out, hidden):
    jm, tm, jparams, tparams = trunks
    jtask, ttask, jhead, thead = _heads(jm, tm, kind, n_out, hidden)
    tokens = _batch(kind, n_out)["tokens"]
    jtrunk = jmodel.encode_trunk(jparams, jnp.asarray(tokens), jm)
    with torch.no_grad():
        ttrunk = tmodel.encode_trunk(tparams, torch.from_numpy(tokens), tm)
        got = tft.apply({"trunk": tparams, "head": thead},
                        torch.from_numpy(tokens), tm, ttask)
    for k in ("local", "global"):
        _close(jtrunk[k], ttrunk[k], TRUNK_TOL)
    want = jft.apply({"trunk": jparams, "head": jhead}, jnp.asarray(tokens),
                     jm, jtask)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(want, got, LOGIT_TOL)
    assert tft.head_in_dim(tm, ttask) == jft.head_in_dim(jm, jtask)


@pytest.mark.parametrize("kind,n_out", KINDS)
def test_task_loss_matches_jax(kind, n_out):
    rng = np.random.default_rng(2)
    batch = _batch(kind, n_out)
    batch["labels"] = batch["labels"].copy()
    if kind == "token_classification":
        batch["labels"][:, 5:9] = -1   # unlabeled residues
        shape = batch["tokens"].shape + (n_out,)
    else:
        shape = (len(batch["tokens"]), n_out)
    out = rng.normal(size=shape).astype(np.float32)
    jl, jm = jtrain.task_loss(jnp.asarray(out),
                              jax.tree.map(jnp.asarray, batch), kind)
    tl, tm = ttrain.task_loss(torch.from_numpy(out),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()}, kind)
    _close(jl, tl, 1e-6)
    assert set(tm) == set(jm)
    for k in jm:
        _close(jm[k], tm[k], 1e-6)


# ---------------------------------------------------------------- step

def _cfgs(kind, n_out, freeze, epochs=1):
    # Adam's first update is lr·g/(|g| + 1e-8): where a gradient is near 0
    # it moves the parameter by up to ±lr on a last-bit difference in g, so
    # the LR is kept at 1e-3 for a 1e-5 comparison.
    opt = dict(learning_rate=1e-3, warmup_steps=0, schedule="constant",
               grad_clip_norm=0.05, weight_decay=0.01)
    task = dict(kind=kind, num_outputs=n_out, freeze_trunk=freeze,
                epochs=epochs)
    return (JFtCfg(model=JModel(**MODEL), task=JTask(**task),
                   optimizer=JOpt(**opt)),
            FinetuneConfig(model=ModelConfig(**MODEL),
                           task=TaskConfig(**task),
                           optimizer=OptimizerConfig(**opt)))


def _flat_state(params, jax_tree: bool):
    """{"trunk/<path>", "head/<path>": host copy} of a fine-tune tree (a
    copy: the port's step updates its tensors in place)."""
    if jax_tree:
        return {**{f"trunk/{k}": v for k, v in
                   flatten_params(params["trunk"]).items()},
                **{f"head/{k}": np.asarray(v)
                   for k, v in _flatten(params["head"]).items()}}
    return {**{f"trunk/{k}": v.copy() for k, v in
               params_to_flat(params["trunk"]).items()},
            **{f"head/{k}": v.copy()
               for k, v in _flatten(params["head"]).items()}}


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("kind,n_out", [KINDS[0], KINDS[2]])
def test_finetune_step_matches_jax(trunks, kind, n_out, freeze):
    jm, tm, jparams, tparams = trunks
    jcfg, tcfg = _cfgs(kind, n_out, freeze)
    jstate = jtrain.create_finetune_state(jax.random.PRNGKey(1), jcfg,
                                          jax.tree.map(np.asarray, jparams))
    tstate = ttrain.create_finetune_state(torch.Generator().manual_seed(1),
                                          tcfg, tparams, device="cpu")
    for name, leaf in _flatten(tstate.params["head"]).items():
        path = name.split("/")
        src = jstate.params["head"][path[0]][path[1]]
        tstate.params["head"][path[0]][path[1]].copy_(
            torch.from_numpy(np.asarray(src).copy()))
    before = _flat_state(tstate.params, False)
    _close_all = _flat_state(jstate.params, True)
    assert set(before) == set(_close_all)
    batch = _batch(kind, n_out, seed=5)
    jstate, jmetrics = jtrain.finetune_step(jstate, batch, jcfg)
    tstate, tmetrics = ttrain.finetune_step(tstate, batch, tcfg)
    assert tstate.step == int(jstate.step) == 1
    _close(jmetrics["loss"], tmetrics["loss"], STEP_TOL)
    want, got = _flat_state(jstate.params, True), _flat_state(tstate.params,
                                                                False)
    for k in want:
        _close(want[k], got[k], STEP_TOL)
    moved = [k for k in got if not np.array_equal(got[k], before[k])]
    if freeze:
        # The trunk bit for bit; only the head moved, its Adam moments are
        # all the optimizer holds (no trunk moments, no trunk decay).
        assert moved and all(k.startswith("head/") for k in moved)
        assert len(tstate.opt_state.mu) == len(_flatten(
            tstate.params["head"]))
    else:
        assert any(k.startswith("trunk/") for k in moved)


# ---------------------------------------------------------------- loop

def _train_batches(kind, n_out):
    batches = make_task_batches(8, np.random.default_rng(3), kind, n_out,
                                SEQ_LEN, 4)
    return lambda epoch: iter(batches[epoch % 2:] + batches[:epoch % 2])


def test_finetune_resumes_to_the_uninterrupted_history(tmp_path, trunks):
    _, _, _, tparams = trunks
    kind, n_out = KINDS[1]
    evals = make_task_batches(4, np.random.default_rng(9), kind, n_out,
                              SEQ_LEN, 4)
    _, cfg2 = _cfgs(kind, n_out, False, epochs=2)
    _, cfg1 = _cfgs(kind, n_out, False, epochs=1)
    ck = Checkpointer(str(tmp_path / "a"), async_save=False)
    full = ttrain.finetune(cfg2, _train_batches(kind, n_out),
                           lambda: iter(evals), pretrained_trunk=tparams,
                           checkpointer=ck, device="cpu")
    ck.close()
    assert [r["epoch"] for r in full["history"]] == [0, 1]
    assert sorted(Checkpointer(str(tmp_path / "a")).all_steps()) == [1, 2]
    ck = Checkpointer(str(tmp_path / "b"), async_save=False)
    ttrain.finetune(cfg1, _train_batches(kind, n_out), lambda: iter(evals),
                    pretrained_trunk=tparams, checkpointer=ck, device="cpu")
    ck.close()
    ck = Checkpointer(str(tmp_path / "b"), async_save=False)
    resumed = ttrain.finetune(cfg2, _train_batches(kind, n_out),
                              lambda: iter(evals), pretrained_trunk=tparams,
                              checkpointer=ck, device="cpu")
    ck.close()
    assert resumed["history"] == full["history"]
    assert resumed["best"] == full["best"]
    for k, v in _flat_state(full["state"].params, False).items():
        np.testing.assert_array_equal(
            _flat_state(resumed["state"].params, False)[k], v)
    ck = Checkpointer(str(tmp_path / "b"), async_save=False)
    with pytest.raises(ValueError, match="already holds 2 completed"):
        ttrain.finetune(cfg2, _train_batches(kind, n_out),
                        pretrained_trunk=tparams, checkpointer=ck,
                        device="cpu")
    ck.close()
    # The caller's pretrained trunk is not the one the run updated.
    assert not np.array_equal(
        params_to_flat(full["state"].params["trunk"])["blocks/0/local_dense/"
                                                      "kernel"],
        params_to_flat(tparams)["blocks/0/local_dense/kernel"])


def test_finetune_registers_a_head_the_jax_registry_serves(tmp_path, trunks):
    jm, tm, jparams, tparams = trunks
    kind, n_out = KINDS[2]
    _, cfg = _cfgs(kind, n_out, True)
    events = str(tmp_path / "events.jsonl")
    tele = Telemetry(events_path=events)
    out = ttrain.finetune(cfg, _train_batches(kind, n_out),
                          pretrained_trunk=tparams, telemetry=tele,
                          registry=HeadRegistry(str(tmp_path / "reg")),
                          register_name="stability", device="cpu")
    tele.close()
    fp = jfingerprint(jparams)
    head = JRegistry(str(tmp_path / "reg")).load(out["head_id"], trunk_fp=fp)
    assert head.name == "stability" and head.task.freeze_trunk
    recs = [r for r in read_events(events, strict=True)
            if r["event"] == "head_registered"]
    assert len(recs) == 1 and recs[0]["trunk_fingerprint"] == fp
    assert recs[0]["head_id"] == out["head_id"]
