"""The port's checkpoints and resume (`proteinbert_tpu_torch.train.
checkpoint.Checkpointer`, `pretrain(checkpointer=...)`), early stopping,
the eval-keyed plateau, the staged (overlapped) boundary and StepTimer's
overlap accounting on the CPU — the counterparts of the JAX package's
tests/test_train.py checkpoint and trainer cases — and their parity with
the JAX trainer where both can be fed the same numbers.

Tolerances: a resumed run against an uninterrupted one is byte-identical
on the CPU (params, Adam moments and count, plateau state, generator
state, losses); the plateau's LR-scale trajectory against optax's on the
same eval losses 1e-6 relative (float32 on both sides, the bias
corrections' powers may differ by one ulp, tests/test_torch_train.py);
the early-stop step and the data item exactly; embeddings from a loaded
trunk exactly.
"""

import dataclasses
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from proteinbert_tpu import configs as jconfigs
from proteinbert_tpu.data import dataset as jds
from proteinbert_tpu.train import Checkpointer as JCheckpointer
from proteinbert_tpu.train import train_state as jts
from proteinbert_tpu.train import trainer as jtrainer
from proteinbert_tpu_torch import configs as tconfigs
from proteinbert_tpu_torch import inference
from proteinbert_tpu_torch.data.dataset import (
    InMemoryPretrainingDataset, make_pretrain_iterator, train_eval_split,
)
from proteinbert_tpu_torch.data.packing import make_packed_iterator
from proteinbert_tpu_torch.data.synthetic import make_random_proteins
from proteinbert_tpu_torch.train import Checkpointer
from proteinbert_tpu_torch.train import schedule as tsched
from proteinbert_tpu_torch.train import train_state as tts
from proteinbert_tpu_torch.train import trainer as ttrainer
from proteinbert_tpu_torch.train.checkpoint import STATE_FILE
from proteinbert_tpu_torch.train.metrics import StepTimer
from proteinbert_tpu_torch.train.schedule import tree_leaves
from proteinbert_tpu_torch.train.trainer import pretrain

torch.set_num_threads(1)

MODEL = dict(local_dim=16, global_dim=32, key_dim=8, num_heads=4,
             num_blocks=2, num_annotations=32, dtype="float32")


def smoke_cfg(max_steps=20, schedule="warmup_cosine", mod=tconfigs,
              log_every=10, **model_kw):
    model = dict(MODEL, **model_kw)
    return mod.PretrainConfig(
        model=mod.ModelConfig(**model),
        data=mod.DataConfig(seq_len=32, batch_size=8),
        optimizer=mod.OptimizerConfig(
            learning_rate=1e-3, warmup_steps=10, schedule=schedule,
            total_steps=max_steps),
        train=mod.TrainConfig(max_steps=max_steps, log_every=log_every))


def _ds(n=64, seed=0, A=32, seq_len=32):
    seqs, ann = make_random_proteins(n, np.random.default_rng(seed),
                                     num_annotations=A, max_len=40)
    return InMemoryPretrainingDataset(seqs, ann, seq_len)


def factory(cfg, seed=0):
    ds = _ds(A=cfg.model.num_annotations, seq_len=cfg.data.seq_len)
    return lambda skip: make_pretrain_iterator(
        ds, cfg.data.batch_size, seed=seed, skip_batches=skip)


def _skip(it, n):
    for _ in range(n):
        next(it)
    return it


def assert_states_equal(a, b):
    """Every leaf of two TrainStates byte for byte: step, params, Adam
    count and moments, plateau state, generator state."""
    assert a.step == b.step
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params),
                    strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.opt_state.count == b.opt_state.count
    for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu, strict=True):
        assert torch.equal(x, y)
    pa, pb = a.opt_state.plateau, b.opt_state.plateau
    assert (pa is None) == (pb is None)
    for k in pa or {}:
        assert torch.equal(pa[k], pb[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _losses(hist, after=0, key="loss"):
    return {h["step"]: h[key] for h in hist if key in h and h["step"] > after}


# --------------------------------------------------------------- resume

def test_checkpoint_resume(tmp_path):
    """Stop at 10, restore, resume to 20: the same state and losses as an
    uninterrupted 20-step run, byte for byte."""
    cfg = smoke_cfg(log_every=1)
    cfg_a = cfg.replace(
        checkpoint=tconfigs.CheckpointConfig(every_steps=10,
                                             async_save=False),
        train=dataclasses.replace(cfg.train, max_steps=10))
    full = pretrain(cfg, factory(cfg)(0), device="cpu")

    ck1 = Checkpointer(str(tmp_path / "ck"), async_save=False)
    pretrain(cfg_a, factory(cfg)(0), checkpointer=ck1, device="cpu")
    ck1.close()

    ck2 = Checkpointer(str(tmp_path / "ck"), async_save=False)
    state = tts.create_train_state(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    state, data_state = ck2.restore(state)
    ck2.close()
    assert state.step == 10 and data_state == {"batches_consumed": 10}
    resumed = pretrain(cfg, _skip(factory(cfg)(0), 10), state=state,
                       device="cpu")
    assert resumed["state"].step == 20
    assert _losses(resumed["history"]) == _losses(full["history"], 10)
    assert_states_equal(resumed["state"], full["state"])


def test_warm_start_checkpoint(tmp_path):
    """checkpoint.warm_start saves at the start step before training,
    leaves the numerics alone, and is skipped on resume."""
    cfg = smoke_cfg(max_steps=20)
    cfg_w = cfg.replace(checkpoint=tconfigs.CheckpointConfig(
        every_steps=10, async_save=False, warm_start=True))
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    out = pretrain(cfg_w, factory(cfg)(0), checkpointer=ck, device="cpu")
    assert ck.all_steps() == [0, 10, 20]
    plain = pretrain(cfg, factory(cfg)(0), device="cpu")
    assert out["history"][-1]["loss"] == plain["history"][-1]["loss"]
    ck.close()

    ck2 = Checkpointer(str(tmp_path / "ck"), async_save=False)
    cfg_more = cfg_w.replace(train=dataclasses.replace(cfg_w.train,
                                                       max_steps=30))
    out2 = pretrain(cfg_more, factory(cfg), checkpointer=ck2, device="cpu")
    assert out2["state"].step == 30
    assert ck2.all_steps() == [10, 20, 30]   # max_to_keep 3
    ck2.close()


@pytest.mark.parametrize("schedule", ["warmup_cosine", "warmup_plateau"])
def test_checkpoint_resume_is_exact_with_cropping(tmp_path, schedule):
    """Long sequences re-cropped per epoch (crop_seed): a run resumed
    through the checkpointer reproduces the uninterrupted run exactly,
    every leaf of the restored state equal to the saved one."""
    cfg = smoke_cfg(max_steps=20, schedule=schedule, log_every=1)
    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=80))
            for _ in range(32)]
    ann = (rng.random((32, 32)) < 0.05).astype(np.float32)

    def fresh_iter(skip=0):
        ds = InMemoryPretrainingDataset(seqs, ann, 32, crop_seed=7)
        return make_pretrain_iterator(ds, 8, seed=1, skip_batches=skip)

    full = pretrain(cfg, fresh_iter(), device="cpu")
    cfg_a = cfg.replace(
        train=dataclasses.replace(cfg.train, max_steps=12),
        checkpoint=tconfigs.CheckpointConfig(every_steps=12,
                                             async_save=False))
    ck1 = Checkpointer(str(tmp_path / "ck"), async_save=False)
    partial = pretrain(cfg_a, fresh_iter(), checkpointer=ck1, device="cpu")
    ck1.close()

    ck2 = Checkpointer(str(tmp_path / "ck"), async_save=False)
    state = tts.create_train_state(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    state, data_state = ck2.restore(state)
    ck2.close()
    assert_states_equal(state, partial["state"])
    resumed = pretrain(cfg, fresh_iter(data_state["batches_consumed"]),
                       state=state, device="cpu")
    assert _losses(resumed["history"]) == _losses(full["history"], 12)
    assert_states_equal(resumed["state"], full["state"])


def test_auto_resume_uses_data_position(tmp_path):
    """`pretrain(checkpointer=...)` with an iterator factory restores the
    state and skips the consumed batches; a plain iterator is drained."""
    cfg = smoke_cfg(max_steps=20, log_every=1)
    ck_cfg = tconfigs.CheckpointConfig(every_steps=10, async_save=False)
    cfg_a = cfg.replace(checkpoint=ck_cfg,
                        train=dataclasses.replace(cfg.train, max_steps=10))
    full = pretrain(cfg, factory(cfg)(0), device="cpu")
    ck1 = Checkpointer(str(tmp_path / "ck"), async_save=False)
    pretrain(cfg_a, factory(cfg), checkpointer=ck1, device="cpu")
    ck1.close()
    for it in (factory(cfg), factory(cfg)(0)):   # factory, plain iterator
        ck2 = Checkpointer(str(tmp_path / "ck"), async_save=False)
        cfg_b = cfg.replace(checkpoint=dataclasses.replace(ck_cfg,
                                                           every_steps=0))
        resumed = pretrain(cfg_b, it, checkpointer=ck2, device="cpu")
        assert resumed["state"].step == 20
        assert _losses(resumed["history"]) == _losses(full["history"], 10)
        assert_states_equal(resumed["state"], full["state"])
        ck2.close()
        # The final save of the first resume is step 20: drop it so the
        # second resume starts from 10 again.
        ck3 = Checkpointer(str(tmp_path / "ck"), async_save=False)
        assert ck3.latest_step() == 20
        import shutil

        shutil.rmtree(tmp_path / "ck" / "20")


def test_checkpoint_restore_without_data_item(tmp_path):
    cfg = smoke_cfg()
    state = tts.create_train_state(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    assert ck.save(5, state)
    restored, data_state = ck.restore(state)
    ck.close()
    assert data_state is None
    assert_states_equal(restored, state)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_sigterm_after_step_k_resumes_byte_identical(tmp_path, packed):
    """Kill after step k (SIGTERM from log_fn), resume with a fresh
    state and a new Checkpointer: params, moments, plateau, generator
    state and every later loss equal the uninterrupted run's, for dense
    and packed rows (the packed iterator's skip_batches replay)."""
    cfg = smoke_cfg(max_steps=12, schedule="warmup_plateau", log_every=1)
    cfg = cfg.replace(checkpoint=tconfigs.CheckpointConfig(every_steps=4))
    ds = _ds(n=96)
    if packed:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, packing=True, pack_max_segments=4))

        def fac(skip):
            return make_packed_iterator(ds, 8, seed=0, max_segments=4,
                                        skip_batches=skip)
    else:
        def fac(skip):
            return make_pretrain_iterator(ds, 8, seed=0, skip_batches=skip)

    full = pretrain(cfg, fac, device="cpu")
    fired = []

    def kill(step, m):
        if step == 6 and not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)

    ck = Checkpointer(str(tmp_path / "ck"))
    out = pretrain(cfg, fac, checkpointer=ck, log_fn=kill, device="cpu")
    ck.close()
    assert out["preempted"] and not out["early_stopped"]
    assert out["state"].step == 6 and ck.all_steps() == [4, 6]
    ck2 = Checkpointer(str(tmp_path / "ck"))
    template = tts.create_train_state(torch.Generator().manual_seed(0),
                                      cfg, "cpu")
    restored, data_state = ck2.restore(template)
    assert_states_equal(restored, out["state"])
    assert data_state == {"batches_consumed": 6}
    resumed = pretrain(cfg, fac, checkpointer=ck2, device="cpu")
    ck2.close()
    assert resumed["state"].step == 12 and not resumed["preempted"]
    assert _losses(resumed["history"]) == _losses(full["history"], 6)
    assert_states_equal(resumed["state"], full["state"])


# ----------------------------------------------------- the checkpointer

def test_save_skips_old_steps_and_keeps_the_newest(tmp_path):
    cfg = smoke_cfg()
    state = tts.create_train_state(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    events = []
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2,
                      async_save=False)
    ck.on_event = lambda phase, step, **info: events.append(
        (phase, step, info["saved"]))
    assert [ck.save(s, state) for s in (1, 2, 2, 1, 3)] == [
        True, True, False, False, True]
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3"]
    assert events[2] == ("save", 2, False)
    ck.on_event = lambda *a, **k: 1 / 0     # a broken hook is logged
    assert ck.save(4, state)
    ck.close()
    # A new Checkpointer finds the steps and a torn temporary write goes.
    os.makedirs(tmp_path / "ck" / ".tmp-5-123")
    ck2 = Checkpointer(str(tmp_path / "ck"))
    assert ck2.all_steps() == [3, 4]
    assert not (tmp_path / "ck" / ".tmp-5-123").exists()
    ck2.close()
    assert not (tmp_path / "nothing").exists()
    assert Checkpointer(str(tmp_path / "nothing")).restore(state) == (
        None, None)
    assert not (tmp_path / "nothing").exists()   # reading creates nothing


def test_async_save_copies_before_returning(tmp_path):
    """async_save returns before the write lands, but the saved state is
    the one at the call: a later in-place update does not reach it."""
    cfg = smoke_cfg()
    state = tts.create_train_state(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    want = [t.clone() for t in tree_leaves(state.params)]
    ck = Checkpointer(str(tmp_path / "ck"), async_save=True)
    assert ck.save(1, state)
    with torch.no_grad():
        for t in tree_leaves(state.params):
            t.add_(1.0)
    ck.wait()
    restored, _ = ck.restore(state)
    ck.close()
    for a, b in zip(tree_leaves(restored.params), want):
        assert torch.equal(a, b)


def test_restore_refuses_a_wrong_template(tmp_path):
    cfg = smoke_cfg()
    state = tts.create_train_state(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ck.save(1, state)
    ck.save(2, state)
    wide = tts.create_train_state(torch.Generator().manual_seed(0),
                                  smoke_cfg(local_dim=24), "cpu")
    with pytest.raises(ValueError, match="!= template"):
        ck.restore(wide)                 # never taken for a torn step
    bf16 = tts.create_train_state(torch.Generator().manual_seed(0),
                                  smoke_cfg(dtype="bfloat16"), "cpu")
    leaves = [t for t in tree_leaves(bf16.params)
              if t.dtype != tree_leaves(state.params)[0].dtype]
    if leaves:
        with pytest.raises(ValueError, match="!= template"):
            ck.restore(bf16)
    plateau = tts.create_train_state(
        torch.Generator().manual_seed(0),
        smoke_cfg(schedule="warmup_plateau"), "cpu")
    with pytest.raises(ValueError, match="plateau"):
        ck.restore(plateau)
    ck.close()


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


@pytest.mark.parametrize("damage", ["truncated", "missing"])
def test_torn_final_checkpoint_falls_back_one_step(tmp_path, damage):
    """A torn (truncated) or missing newest state.pt: restore lands on the
    previous step and reports a note; a second torn step raises, and so
    do an explicit step and a single-step directory."""
    cfg = smoke_cfg()
    state = tts.create_train_state(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    for s in (1, 2, 3):
        with torch.no_grad():
            tree_leaves(state.params)[0].fill_(float(s))
        state = dataclasses.replace(state, step=s)
        ck.save(s, state)
    ck.close()

    def tear(step):
        path = tmp_path / "ck" / str(step) / STATE_FILE
        _truncate(path) if damage == "truncated" else os.remove(path)

    tear(3)
    notes = []
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.on_note = lambda **f: notes.append(f)
    restored, _ = ck.restore(state)
    assert restored.step == 2
    assert float(tree_leaves(restored.params)[0].flatten()[0]) == 2.0
    assert len(notes) == 1 and notes[0]["kind"] == "restore_fallback"
    assert (notes[0]["bad_step"], notes[0]["landed_step"]) == (3, 2)
    from proteinbert_tpu_torch.obs.events import make_record, validate_record

    validate_record(make_record("note", 0, 0.0, **notes[0]))
    with pytest.raises(Exception):
        ck.restore(state, step=3)                 # explicit: strict
    with pytest.raises(Exception):
        ck.restore(state, fallback=False)
    tear(2)
    with pytest.raises(Exception):
        ck.restore(state)                         # exactly one skipped
    assert len(notes) == 2
    ck.close()
    single = Checkpointer(str(tmp_path / "one"), async_save=False)
    single.save(1, state)
    tear_one = tmp_path / "one" / "1" / STATE_FILE
    _truncate(tear_one) if damage == "truncated" else os.remove(tear_one)
    with pytest.raises(Exception):
        single.restore(state)
    single.close()


# ------------------------------------------ early stop, eval-keyed plateau

def _early_stop_cfg(mod=tconfigs, **train_kw):
    train_kw.setdefault("log_every", 0)
    return mod.PretrainConfig(
        model=mod.ModelConfig(local_dim=16, global_dim=32, key_dim=8,
                              num_heads=4, num_blocks=1, num_annotations=64,
                              dtype="float32"),
        data=mod.DataConfig(seq_len=64, batch_size=8),
        optimizer=mod.OptimizerConfig(warmup_steps=2),
        train=mod.TrainConfig(**train_kw))


def _split():
    seqs, ann = make_random_proteins(96, np.random.default_rng(0),
                                     num_annotations=64)
    return train_eval_split(InMemoryPretrainingDataset(seqs, ann, 64),
                            0.25, seed=0)


def test_eval_keyed_plateau_transform_wiring():
    cfg = tconfigs.OptimizerConfig(
        schedule="warmup_plateau", warmup_steps=0, plateau_window=2,
        plateau_patience=2, plateau_cooldown=0, plateau_factor=0.5,
        plateau_metric="eval_loss")
    assert tsched.plateau_uses_eval(cfg)

    def run(values):
        tx = tsched.make_optimizer(cfg)
        params = {"w": torch.ones(3)}
        st = tx.init(params)
        for v in values:
            _, st = tx.update([torch.ones(3)], st, params,
                              value=torch.tensor(v))
        return float(st.plateau["scale"])

    assert run([1.0] * 8) == 0.5
    assert run([1.0 - 0.05 * i for i in range(12)]) == 1.0
    with pytest.raises(ValueError, match="plateau_metric"):
        tsched.plateau_uses_eval(tconfigs.OptimizerConfig(
            plateau_metric="bogus"))


def test_plateau_observation_matches_jax():
    """The value the plateau observes: the eval loss when finite, else
    the train loss; the train loss without an eval-keyed plateau."""
    for metric in ("eval_loss", "train_loss"):
        kw = dict(schedule="warmup_plateau", plateau_metric=metric)
        jcfg = jconfigs.OptimizerConfig(**kw)
        tcfg = tconfigs.OptimizerConfig(**kw)
        for pv in (None, np.float32(np.inf), np.float32(0.25)):
            want = jts.plateau_observation(
                jcfg, {"loss": jax.numpy.float32(1.5)}, pv)
            got = tts.plateau_observation(
                tcfg, {"loss": torch.tensor(1.5)}, pv)
            assert float(got) == float(want)


def _scripted(monkeypatch, values):
    """Make both trainers' eval brackets return the eval losses of
    `values` in turn (the same stream into both packages)."""
    def fake(seq):
        it = iter(seq)

        def evaluate(*a, **k):
            v = next(it)
            return {"eval_loss": v, "eval_local_loss": v,
                    "eval_global_loss": 0.0, "eval_local_acc": 0.0}
        return evaluate

    monkeypatch.setattr(jtrainer, "_evaluate", fake(values))
    monkeypatch.setattr(ttrainer, "evaluate", fake(values))


@pytest.mark.parametrize("case", ["plateau", "early_stop"])
def test_eval_keyed_plateau_and_early_stop_match_jax(monkeypatch, tmp_path,
                                                      case):
    """Fed the same eval losses (a seed eval, then one a step), the port's
    trainer cuts the LR scale at the JAX trainer's steps (the logged lr,
    1e-6 relative), stops early at its step, and checkpoints the same data
    item (a NaN eval loss is not finite: None, as for +inf)."""
    values = [2.0, 1.9] + [1.95] * 10 + [float("nan")]
    seqs, ann = make_random_proteins(96, np.random.default_rng(0),
                                     num_annotations=64)
    out = {}
    for name, mod, ck in (("jax", jconfigs, JCheckpointer),
                          ("port", tconfigs, Checkpointer)):
        train = dict(max_steps=12, log_every=1, eval_every=1)
        if case == "early_stop":
            train.update(early_stop_patience=4, early_stop_min_delta=0.01)
        cfg = _early_stop_cfg(mod, **train)
        cfg = cfg.replace(
            optimizer=dataclasses.replace(
                cfg.optimizer, schedule="warmup_plateau", warmup_steps=0,
                plateau_metric="eval_loss", plateau_window=1,
                plateau_patience=2, plateau_cooldown=0, plateau_factor=0.5),
            checkpoint=mod.CheckpointConfig(every_steps=3, async_save=False,
                                            overlap=False))
        _scripted(monkeypatch, values)
        c = ck(str(tmp_path / name), async_save=False)
        if name == "jax":
            jtrain, _ = jds.train_eval_split(
                jds.InMemoryPretrainingDataset(seqs, ann, 64), 0.25, seed=0)
            res = jtrainer.pretrain(
                cfg, jds.make_pretrain_iterator(jtrain, 8, seed=0),
                checkpointer=c, eval_batches=lambda: iter(()))
        else:
            ttrain, _ = _split()
            res = pretrain(cfg, make_pretrain_iterator(ttrain, 8, seed=0),
                           checkpointer=c, eval_batches=lambda: iter(()),
                           device="cpu")
        _, data = c.restore(res["state"])
        c.close()
        out[name] = (res, data)
    (jres, jdata), (tres, tdata) = out["jax"], out["port"]
    assert tres["early_stopped"] == jres["early_stopped"]
    assert int(tres["state"].step) == int(jres["state"].step)
    if case == "early_stop":
        assert tres["early_stopped"] and tres["state"].step == 5
    jl = [h["lr"] for h in jres["history"] if "lr" in h]
    tl = [h["lr"] for h in tres["history"] if "lr" in h]
    assert len(jl) == len(tl) and len(set(tl)) > 1   # the scale was cut
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert tdata == jdata and "eval_stream" in tdata
    if case == "plateau":
        assert tdata["eval_stream"]["last"] is None


def test_early_stop_on_eval_stall(tmp_path):
    train_ds, eval_ds = _split()
    cfg = _early_stop_cfg(max_steps=40, eval_every=3, early_stop_patience=2,
                          early_stop_min_delta=1e9)
    ck = Checkpointer(str(tmp_path / "ckpt"), async_save=False)
    out = pretrain(cfg, make_pretrain_iterator(train_ds, 8, seed=0),
                   checkpointer=ck,
                   eval_batches=lambda: make_pretrain_iterator(
                       eval_ds, 8, shuffle=False, num_epochs=1),
                   device="cpu")
    assert out["early_stopped"] and not out["preempted"]
    assert out["state"].step == 9 < cfg.train.max_steps
    assert ck.latest_step() == 9
    ck.close()


def test_ckpt_in_flight_flag_logged(tmp_path):
    ds = _ds(n=32, A=64, seq_len=64)
    cfg = _early_stop_cfg(max_steps=4, log_every=1)
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    out = pretrain(cfg, make_pretrain_iterator(ds, 8, seed=0),
                   checkpointer=ck, device="cpu")
    ck.close()
    recs = [h for h in out["history"] if "loss" in h]
    assert recs and all(r["ckpt_in_flight"] == 0.0 for r in recs)
    out2 = pretrain(cfg, make_pretrain_iterator(ds, 8, seed=0),
                    device="cpu")
    assert all("ckpt_in_flight" not in h for h in out2["history"])
    cfg2 = cfg.replace(checkpoint=tconfigs.CheckpointConfig(
        every_steps=2, async_save=True))
    ck2 = Checkpointer(str(tmp_path / "ck2"), async_save=True)
    out3 = pretrain(cfg2, make_pretrain_iterator(ds, 8, seed=0),
                    checkpointer=ck2, device="cpu")
    ck2.close()
    flags = {h["step"]: h["ckpt_in_flight"] for h in out3["history"]}
    assert flags[3] == 1.0 and flags[2] == 0.0


def test_eval_stream_state_survives_resume(tmp_path):
    train_ds, eval_ds = _split()

    def evb():
        return make_pretrain_iterator(eval_ds, 8, shuffle=False,
                                      num_epochs=1)

    def fac(skip):
        return make_pretrain_iterator(train_ds, 8, seed=0,
                                      skip_batches=skip)

    cfg = _early_stop_cfg(max_steps=6, eval_every=3, early_stop_patience=3,
                          early_stop_min_delta=1e9)
    cfg = cfg.replace(optimizer=dataclasses.replace(
        cfg.optimizer, schedule="warmup_plateau",
        plateau_metric="eval_loss", plateau_window=3))
    ck = Checkpointer(str(tmp_path / "ckpt"), async_save=False)
    out1 = pretrain(cfg, fac, checkpointer=ck, eval_batches=evb,
                    device="cpu")
    assert not out1["early_stopped"]
    evals = [h for h in out1["history"] if "eval_loss" in h]
    assert evals[0]["step"] == 0                    # the seed eval
    _, ds1 = ck.restore(out1["state"])
    es = ds1["eval_stream"]
    assert es["stalled"] == 2 and es["best"] is not None
    assert es["last"] == pytest.approx(evals[-1]["eval_loss"])
    cfg2 = cfg.replace(train=dataclasses.replace(cfg.train, max_steps=20))
    out2 = pretrain(cfg2, fac, checkpointer=ck, eval_batches=evb,
                    device="cpu")
    assert out2["early_stopped"] and out2["state"].step == 9
    assert not any(h["step"] == 6 and "eval_loss" in h
                   for h in out2["history"])
    ck.close()


def test_early_stop_and_eval_plateau_require_eval_stream():
    ds = _ds(n=32, A=64, seq_len=64)
    cfg = _early_stop_cfg(max_steps=4, early_stop_patience=1)
    with pytest.raises(ValueError, match="early_stop_patience"):
        pretrain(cfg, make_pretrain_iterator(ds, 8, seed=0), device="cpu")
    cfg = _early_stop_cfg(max_steps=4)
    cfg = cfg.replace(optimizer=dataclasses.replace(
        cfg.optimizer, schedule="warmup_plateau",
        plateau_metric="eval_loss"))
    with pytest.raises(ValueError, match="plateau_metric"):
        pretrain(cfg, make_pretrain_iterator(ds, 8, seed=0), device="cpu")


def test_eval_keyed_plateau_end_to_end_cut():
    train_ds, eval_ds = _split()
    cfg = _early_stop_cfg(max_steps=14, eval_every=2, log_every=1)
    cfg = cfg.replace(optimizer=dataclasses.replace(
        cfg.optimizer, schedule="warmup_plateau", plateau_metric="eval_loss",
        learning_rate=1e-12, warmup_steps=0, plateau_window=2,
        plateau_patience=2, plateau_cooldown=0, plateau_factor=0.5))
    out = pretrain(cfg, make_pretrain_iterator(train_ds, 8, seed=0),
                   eval_batches=lambda: make_pretrain_iterator(
                       eval_ds, 8, shuffle=False, num_epochs=1),
                   device="cpu")
    assert float(out["state"].opt_state.plateau["scale"]) < 1.0
    lrs = [h["lr"] for h in out["history"] if "lr" in h]
    assert lrs[-1] < lrs[0]


# ------------------------------------------- overlapped (staged) boundary

class _SlowStager(Checkpointer):
    """A Checkpointer whose copy to the host waits `delay` seconds or, with
    a `gate`, until the gate opens, so a stage is in flight while training
    advances."""

    def __init__(self, *a, delay=0.0, gate=None, **kw):
        super().__init__(*a, **kw)
        self.delay = delay
        self.gate = gate
        self.fetch_done_at = []

    def _stage_fetch(self, snapshot):
        if self.gate is not None:
            self.gate.wait(60)
        time.sleep(self.delay)
        out = super()._stage_fetch(snapshot)
        self.fetch_done_at.append(time.perf_counter())
        return out


def _interrupting_factory(cfg, at_batch, fired, gate):
    """A factory whose fresh stream SIGTERMs the process while producing
    batch `at_batch`, then opens `gate`."""
    def fac(skip):
        it = factory(cfg)(skip)

        def gen():
            for i, b in enumerate(it):
                if skip == 0 and i == at_batch:
                    fired["t"] = time.perf_counter()
                    signal.raise_signal(signal.SIGTERM)
                    gate.set()
                yield b

        return gen()

    return fac


def test_overlapped_ckpt_interrupt_mid_overlap_resumes_byte_identical(
        tmp_path):
    """SIGTERM while a staged save is in flight: the preemption path
    lands the stage, and the resumed run is byte-identical (state,
    losses, eval records) to an uninterrupted one."""
    cfg = smoke_cfg(max_steps=30, log_every=1)
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, eval_every=5),
        checkpoint=tconfigs.CheckpointConfig(every_steps=10))
    eval_ds = InMemoryPretrainingDataset(*make_random_proteins(
        16, np.random.default_rng(9), num_annotations=32, max_len=40), 32)

    def evb():
        return make_pretrain_iterator(eval_ds, 8, shuffle=False,
                                      num_epochs=1)

    full = pretrain(cfg, factory(cfg)(0), eval_batches=evb, device="cpu")
    fired = {}
    gate = threading.Event()
    ck = _SlowStager(str(tmp_path / "ck"), gate=gate)
    out1 = pretrain(cfg, _interrupting_factory(cfg, 14, fired, gate),
                    checkpointer=ck, eval_batches=evb, device="cpu")
    assert out1["preempted"]
    kill = out1["state"].step
    assert 10 < kill < 20
    assert ck.fetch_done_at and fired["t"] < ck.fetch_done_at[0]
    assert 10 in ck.all_steps() and kill in ck.all_steps()
    ck.close()
    ck2 = Checkpointer(str(tmp_path / "ck"))
    resumed = pretrain(cfg, factory(cfg), checkpointer=ck2,
                       eval_batches=evb, device="cpu")
    ck2.close()
    assert resumed["state"].step == 30
    assert_states_equal(resumed["state"], full["state"])
    for key in ("loss", "eval_loss"):
        want = _losses(full["history"], kill, key)
        assert want and _losses(resumed["history"], kill, key) == want


def test_staged_save_observes_boundary_state_not_torn(tmp_path):
    """The staged save captures the boundary step's state although the
    next steps update the params and moments in place while the copy to
    the host sleeps: the overlapped run's step-10 checkpoint equals a
    synchronous run's, leaf for leaf."""
    cfg = smoke_cfg(max_steps=20, log_every=0)
    cfg_over = cfg.replace(checkpoint=tconfigs.CheckpointConfig(
        every_steps=10))
    cfg_sync = cfg.replace(
        train=dataclasses.replace(cfg.train, max_steps=10),
        checkpoint=tconfigs.CheckpointConfig(every_steps=10, overlap=False))
    ck_a = _SlowStager(str(tmp_path / "over"), delay=0.5)
    out = pretrain(cfg_over, factory(cfg)(0), checkpointer=ck_a,
                   device="cpu")
    assert 10 in ck_a.all_steps()
    assert out["perf"].get("overlap_s", 0.0) > 0.0
    ck_a.close()
    ck_b = Checkpointer(str(tmp_path / "sync"), async_save=False)
    pretrain(cfg_sync, factory(cfg)(0), checkpointer=ck_b, device="cpu")
    ck_b.close()
    template = tts.create_train_state(torch.Generator().manual_seed(0),
                                      cfg, "cpu")
    st_over, ds_over = Checkpointer(str(tmp_path / "over")).restore(
        template, step=10)
    st_sync, ds_sync = Checkpointer(str(tmp_path / "sync")).restore(
        template, step=10)
    assert ds_over["batches_consumed"] == ds_sync["batches_consumed"] == 10
    assert_states_equal(st_over, st_sync)


def test_staged_save_error_propagates(tmp_path):
    class _BrokenStager(Checkpointer):
        def _stage_fetch(self, snapshot):
            raise RuntimeError("staged fetch exploded")

    cfg = smoke_cfg(max_steps=12, log_every=0)
    cfg = cfg.replace(checkpoint=tconfigs.CheckpointConfig(every_steps=5))
    ck = _BrokenStager(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="staged fetch exploded"):
        pretrain(cfg, factory(cfg)(0), checkpointer=ck, device="cpu")
    ck._staged = None  # the failure is consumed; close() must not re-raise
    ck.close()


def test_close_releases_the_staged_buffers(tmp_path):
    """close() lands the stage, then drops the snapshot buffers and their
    pinned twins (4 GB each at Large), so the memory returns without
    waiting for the Checkpointer to be collected."""
    cfg = smoke_cfg(max_steps=1, log_every=0)
    state = tts.create_train_state(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_staged(1, state)
    assert ck._snap is not None
    ck.close()
    assert ck.all_steps() == [1]
    assert ck._snap is None and ck._pinned is None
    assert ck._side_stream is None


def _fake_clock(monkeypatch):
    import proteinbert_tpu_torch.train.metrics as metrics_mod

    clock = {"now": 0.0}
    monkeypatch.setattr(metrics_mod.time, "perf_counter",
                        lambda: clock["now"])

    def advance(seconds):
        clock["now"] += seconds

    return advance


def test_step_timer_overlap_accounting(monkeypatch):
    """overlap() records hidden boundary seconds without moving the
    anchors; summary() reports cumulative and per-window overlap and the
    window_* rates, with the JAX timer's keys."""
    advance = _fake_clock(monkeypatch)

    def step(t):
        advance(0.01)
        t.update()

    model = smoke_cfg().model
    cpu = torch.device("cpu")
    timer = StepTimer(model, 8, 32, cpu)
    for _ in range(4):   # 2 warmup + 2 timed
        step(timer)
    timer.overlap(0.7)
    first = timer.summary()
    assert first["step_ms"] == pytest.approx(10.0)
    assert first["overlap_s"] == pytest.approx(0.7)
    assert first["window_overlap_s"] == pytest.approx(0.7)
    assert first["residues_per_sec_per_chip"] == pytest.approx(8 * 32 * 100)
    step(timer)
    advance(0.02)
    timer.discount(0.02)   # an eval between two steps: out of the window
    step(timer)
    second = timer.summary()
    assert second["overlap_s"] == pytest.approx(0.7)
    assert second["window_overlap_s"] == 0.0
    assert second["window_step_ms"] == pytest.approx(10.0)
    assert second["window_steps_per_sec"] == pytest.approx(100.0)
    fresh = StepTimer(model, 8, 32, cpu)
    for _ in range(4):
        step(fresh)
    s = fresh.summary()
    assert "overlap_s" not in s and "mfu" not in s   # no CPU MFU
    from proteinbert_tpu.train.metrics import StepTimer as JStepTimer

    jfresh = JStepTimer(jconfigs.ModelConfig(**MODEL), 8, 32)
    for _ in range(4):
        step(jfresh)
    assert set(s) == set(jfresh.summary()) - {"mfu", "window_mfu"}


# ------------------------------------------------------- load_trunk

def test_load_trunk_embeds_as_the_in_memory_params(tmp_path):
    cfg = smoke_cfg(max_steps=4, log_every=0)
    ck = Checkpointer(str(tmp_path / "run"), async_save=False)
    out = pretrain(cfg, factory(cfg)(0), checkpointer=ck, device="cpu")
    ck.close()
    params, step = inference.load_trunk(str(tmp_path / "run"), cfg,
                                        device="cpu")
    state, _ = inference.load_state(str(tmp_path / "run"), cfg,
                                    device="cpu")
    assert step == 4 and state.step == 4
    assert_states_equal(state, out["state"])
    seqs = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWY", "GG"]
    want = inference.embed(out["state"].params, cfg, seqs, batch_size=4,
                           device="cpu")
    got = inference.embed(params, cfg, seqs, batch_size=4, device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        inference.load_trunk(str(tmp_path / "empty"), cfg, device="cpu")
