"""The port's failure handling in `pretrain` on the CPU — the counterparts
of the JAX package's tests/test_resilience.py: the NaN halt with its
diagnostic checkpoint and events, the warn mode, SIGTERM → checkpoint →
`preempted`, SIGTERM while a staged save is in flight (the flight dump),
and the signal handlers' restore; plus the sequence-parallel trainer's
refusal of the eval-keyed plateau (JAX's message) and its early stop, and
a two-rank gloo group's checkpoints (rank 0 writes, every rank restores)."""

import dataclasses
import json
import logging
import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from proteinbert_tpu.obs.events import validate_record as j_validate_record
from proteinbert_tpu_torch import configs as tconfigs
from proteinbert_tpu_torch import obs
from proteinbert_tpu_torch.data.dataset import (
    InMemoryPretrainingDataset, make_pretrain_iterator, train_eval_split,
)
from proteinbert_tpu_torch.data.synthetic import make_random_proteins
from proteinbert_tpu_torch.train import Checkpointer
from proteinbert_tpu_torch.train.resilience import (
    GracefulShutdown, NonFiniteLossError, check_finite,
    flush_inflight_checkpoint,
)
from proteinbert_tpu_torch.train.trainer import pretrain
from tests import torch_seq_child

MODEL = tconfigs.ModelConfig(local_dim=16, global_dim=32, key_dim=8,
                             num_heads=4, num_blocks=1, num_annotations=64,
                             dtype="float32")
SPAWN_TIMEOUT = 150  # seconds for one spawned group, start-up included


def _cfg(**train_kw):
    train = {"max_steps": 10, "log_every": 2, **train_kw}
    return tconfigs.PretrainConfig(
        model=MODEL,
        data=tconfigs.DataConfig(seq_len=64, batch_size=8),
        optimizer=tconfigs.OptimizerConfig(warmup_steps=4),
        train=tconfigs.TrainConfig(**train))


def _iterator(seed=0):
    seqs, ann = make_random_proteins(64, np.random.default_rng(seed),
                                     num_annotations=64)
    ds = InMemoryPretrainingDataset(seqs, ann, 64)
    return make_pretrain_iterator(ds, 8, seed=seed)


def _blowup(cfg):
    return cfg.replace(optimizer=tconfigs.OptimizerConfig(
        learning_rate=1e18, warmup_steps=1, grad_clip_norm=1e18))


def test_check_finite():
    assert check_finite({"loss": 1.0, "grad_norm": 2.0}, 1)
    assert not check_finite({"loss": float("nan")}, 1, mode="warn")
    assert not check_finite({"loss": float("nan")}, 1, mode="quiet")
    with pytest.raises(NonFiniteLossError, match="step 7"):
        check_finite({"loss": float("inf")}, 7, mode="halt")


def test_nan_halt_saves_diagnostic_checkpoint(tmp_path):
    """An absurd LR blows the tiny model up: the NaN state lands once in
    the sibling `-diagnostic` directory (the resume chain stays clean),
    the stream says nan_halt then run_end(outcome="nan_halt"), and both
    packages' validators accept it."""
    cfg = _blowup(_cfg())
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    tele = obs.Telemetry(events_path=str(tmp_path / "ev.jsonl"),
                         flight_dir=str(tmp_path))
    with pytest.raises(NonFiniteLossError):
        pretrain(cfg, _iterator(), checkpointer=ck, telemetry=tele,
                 device="cpu")
    tele.close()
    assert ck.latest_step() is None
    assert not (tmp_path / "ck").exists()
    diag = Checkpointer(str(tmp_path / "ck") + "-diagnostic")
    assert len(diag.all_steps()) == 1
    step = diag.latest_step()
    with open(tmp_path / "ck-diagnostic" / str(step) / "data.json") as f:
        assert json.load(f) == {"batches_consumed": step,
                                "non_finite": True}
    diag.close()
    recs = obs.read_events(str(tmp_path / "ev.jsonl"), strict=True)
    kinds = [r["event"] for r in recs]
    assert kinds[-2:] == ["nan_halt", "run_end"]
    assert kinds.count("nan_halt") == 1
    assert recs[-1]["outcome"] == "nan_halt"
    assert recs[-2]["step"] == step and recs[-2]["mode"] == "halt"
    for r in recs:
        j_validate_record(r)
    payload = json.load(open(obs.flight_path(str(tmp_path))))
    obs.validate_flight_dump(payload)
    assert payload["reason"] == "nan_halt"


def test_nan_warn_mode_continues(tmp_path, caplog):
    """Under "warn" the run trains on; the diagnostic is saved once."""
    cfg = _blowup(_cfg(on_nan="warn"))
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    caplog.set_level(logging.WARNING)
    out = pretrain(cfg, _iterator(), checkpointer=ck, device="cpu")
    ck.close()
    assert len(out["history"]) == 5
    warned = [r for r in caplog.records if "on_nan=warn" in r.getMessage()]
    assert warned
    assert len(os.listdir(tmp_path / "ck-diagnostic")) == 1
    assert ck.latest_step() == 10   # the final save still happens


def test_sigterm_checkpoints_and_exits(tmp_path):
    cfg = _cfg()
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    fired = []

    def send_signal(step, m):
        if step == 4 and not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)

    tele = obs.Telemetry(events_path=str(tmp_path / "ev.jsonl"))
    out = pretrain(cfg, _iterator(), checkpointer=ck, log_fn=send_signal,
                   telemetry=tele, device="cpu")
    tele.close()
    assert out["preempted"] is True and out["early_stopped"] is False
    assert ck.latest_step() == 4
    ck.close()
    recs = obs.read_events(str(tmp_path / "ev.jsonl"), strict=True)
    requeue = [r for r in recs if r["event"] == "requeue"]
    assert len(requeue) == 1 and requeue[0]["saved"] is True
    assert requeue[0]["reason"] == f"signal_{int(signal.SIGTERM)}"
    assert recs[-1]["event"] == "run_end"
    assert recs[-1]["outcome"] == "preempted"

    ck2 = Checkpointer(str(tmp_path / "ck"), async_save=False)
    out2 = pretrain(cfg, lambda skip: _iterator(), checkpointer=ck2,
                    device="cpu")
    assert out2["preempted"] is False
    assert out2["state"].step == cfg.train.max_steps
    ck2.close()


def test_sigterm_mid_staged_checkpoint_dumps_flight(tmp_path):
    """SIGTERM while a staged save is still in flight leaves a valid flight
    dump holding the stage's dispatch, its landing (flushed on the
    preemption path) and the requeue record."""
    cfg = _cfg()
    cfg = cfg.replace(checkpoint=dataclasses.replace(
        tconfigs.CheckpointConfig(), directory=str(tmp_path / "ck"),
        every_steps=4, overlap=True))

    release = threading.Event()

    class SlowStageCheckpointer(Checkpointer):
        # The step-4 stage stays in flight until the SIGTERM is sent.
        def _stage_fetch(self, snapshot):
            release.wait(60)
            return super()._stage_fetch(snapshot)

    ck = SlowStageCheckpointer(cfg.checkpoint.directory, async_save=False)
    tele = obs.Telemetry(events_path=str(tmp_path / "ev.jsonl"),
                         flight_dir=str(tmp_path))
    fired = []

    def send_signal(step, m):
        if step == 6 and not fired:
            assert ck.staged_in_flight(), "drill setup: stage already landed"
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)
            release.set()

    out = pretrain(cfg, _iterator(), checkpointer=ck, log_fn=send_signal,
                   telemetry=tele, device="cpu")
    ck.close()
    tele.close()
    assert out["preempted"] is True
    assert ck.all_steps() == [4, 6]
    payload = json.load(open(obs.flight_path(str(tmp_path))))
    obs.validate_flight_dump(payload)
    assert payload["reason"].startswith("signal_")
    kinds = [(r["event"], r.get("phase")) for r in payload["events"]]
    assert ("ckpt_stage", "dispatch") in kinds
    assert ("ckpt_stage", "landed") in kinds
    assert any(r["event"] == "requeue" and r["reason"] == "signal_15"
               for r in payload["events"])
    recs = obs.read_events(str(tmp_path / "ev.jsonl"), strict=True)
    assert any(r["event"] == "requeue" for r in recs)


def test_graceful_shutdown_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.requested and stop.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before


def test_flush_inflight_checkpoint_logs_and_never_raises(caplog):
    class Broken:
        def wait(self):
            raise OSError("disk full")

    caplog.set_level(logging.ERROR)
    flush_inflight_checkpoint(None, "nothing")
    flush_inflight_checkpoint(Broken(), "a test")
    assert any("a test" in r.getMessage() for r in caplog.records)


# ------------------------------------------------ the seq-parallel trainer

def _split():
    seqs, ann = make_random_proteins(96, np.random.default_rng(0),
                                     num_annotations=64)
    return train_eval_split(InMemoryPretrainingDataset(seqs, ann, 64),
                            0.25, seed=0)


def test_seq_parallel_trainer_refuses_eval_plateau_and_stops_early(
        tmp_path):
    """On the sequence-parallel step (a one-rank gloo group) the eval-keyed
    plateau is refused with the JAX trainer's message; early stopping
    works and saves at the stop."""
    train_ds, eval_ds = _split()
    cfg = _cfg(eval_every=3, early_stop_patience=2,
               early_stop_min_delta=1e9, log_every=0, max_steps=40)
    plateau = cfg.replace(optimizer=dataclasses.replace(
        cfg.optimizer, schedule="warmup_plateau",
        plateau_metric="eval_loss"))

    def evb():
        return make_pretrain_iterator(eval_ds, 8, shuffle=False,
                                      num_epochs=1)

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        with pytest.raises(ValueError, match=(
                "plateau_metric='eval_loss' is not supported with the "
                "explicit sequence-parallel pallas step")):
            pretrain(plateau, make_pretrain_iterator(train_ds, 8, seed=0),
                     eval_batches=evb, device="cpu", seq_group=group)
        ck = Checkpointer(str(tmp_path / "ck"), seq_group=group)
        out = pretrain(cfg, make_pretrain_iterator(train_ds, 8, seed=0),
                       checkpointer=ck, eval_batches=evb, device="cpu",
                       seq_group=group)
        ck.close()
    finally:
        dist.destroy_process_group()
    assert out["early_stopped"] and out["state"].step == 9
    assert ck.all_steps() == [9]


def test_two_rank_seq_checkpoints_resume_on_every_rank(tmp_path):
    """A two-rank gloo group (spawned ranks, tests/torch_seq_child.py):
    stopped at step 3 and resumed to 6 through Checkpointers made with the
    group, each rank ends byte-identical to its uninterrupted run; rank 0
    alone wrote the steps, and both ranks restored them."""
    ctx = multiprocessing.get_context("spawn")
    world = 2
    procs = [ctx.Process(target=torch_seq_child.checkpoint,
                         args=(r, world, str(tmp_path / "store"),
                               str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        assert [p.exitcode for p in procs] == [0] * world, (
            f"ranks exited {[p.exitcode for p in procs]} "
            f"(None = still running at the {SPAWN_TIMEOUT} s timeout)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    res = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    for r in res:
        assert r["same"] == 1 and r["steps"].tolist() == [3, 6]
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "6"]
    for k in res[0]:
        if k.startswith("p:"):
            np.testing.assert_array_equal(res[0][k], res[1][k])
