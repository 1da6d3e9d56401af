"""The pretraining loop — port of `proteinbert_tpu/train/trainer.py`
(`pretrain`) for dense and packed rows on one device, and for dense rows
sequence-parallel over a process group.

`pretrain(cfg, batch_iterator, ...)` creates, restores or continues a
train state, runs `cfg.train.max_steps` steps of `train_step`, logs every
`cfg.train.log_every` steps, scores `eval_batches()` every
`cfg.train.eval_every` steps under a step-keyed generator (so an eval is
reproducible), and returns {"state", "history", "perf", "preempted",
"early_stopped"}. It trains whatever batches its iterator yields: dense
ones (`make_pretrain_iterator`) or packed ones (`data/packing.
make_packed_iterator`, a "segment_ids" key), each step choosing its
branch from the batch as the JAX step does. `perf` is the StepTimer
summary (the JAX timer's keys: steps/s, step ms, residues/s per chip, the
`window_*` rates, `overlap_s`, and MFU on a card with a published peak).

As in the JAX loop:
- with a `checkpointer` (train/checkpoint.py) a fresh run restores the
  newest step and its data item (`batches_consumed` and the eval stream:
  last, best, stalled); a callable iterator is then called with
  `batches_consumed`, a plain one drained that far; saves come every
  `cfg.checkpoint.every_steps` — staged behind training under
  `cfg.checkpoint.overlap` (one-rank runs), else synchronous — plus a
  warm-start save (`cfg.checkpoint.warm_start`) and a final one;
- SIGTERM / SIGINT (`train/resilience.GracefulShutdown`) finishes the
  step, flushes the staged save, saves at the completed step, emits
  `requeue` and returns `preempted=True` (exit code 75 is a CLI's);
- at each log point the loss and grad norm go through `check_finite`
  under `cfg.train.on_nan`: a non-finite value first saves the state
  once into `<checkpoint dir>-diagnostic` and emits `nan_halt`; "halt"
  then flushes, emits `run_end(outcome="nan_halt")` and raises
  `NonFiniteLossError`, "warn" logs and trains on, "off" skips the check;
- `cfg.train.early_stop_patience` stops (and saves) after that many
  evals without an eval-loss improvement of `early_stop_min_delta`, and
  `plateau_metric="eval_loss"` feeds the latest eval loss to the plateau
  (seeded by one eval before the first step); both need an eval stream;
- `telemetry` (obs.Telemetry) receives `run_start`, `step`, `ckpt_stage`,
  `eval`, `requeue`, `nan_halt`, `run_end` and `note` records, the
  metrics registry's gauges and counters, and the flight dumps.

`seq_group` (a `torch.distributed` process group) trains through the
explicit sequence-parallel step (`parallel/seq_parallel.
make_seq_parallel_train_step`), as the JAX trainer does when
`cfg.mesh.seq > 1 and cfg.model.use_pallas`. The port has no mesh, so the
caller's group selects the path, not `cfg.mesh`; a group of size 1 is
allowed. Each rank then runs the same loop on the same batches, `perf`
counts this rank's B·L/world positions a step, rank 0 writes the
checkpoints, and the eval-keyed plateau is refused there as in JAX.

With `cfg.data.prefetch_depth` > 0 the batches come through
`data/prefetch.PrefetchIterator` (numpy made on its thread, moved to the
device inside the step on the train thread); each `step` record then
carries `data_wait_s`, and the gauges `data_wait_seconds` and
`data_batches_total` follow it. Batches may change their length L from
step to step (`data/dataset.make_bucketed_iterator`'s buckets): the step
is shape-parametric, and `perf` counts B·`cfg.data.seq_len` positions a
step as the JAX timer does.

Left as the JAX loop's other paths: the overlapped eval bracket
(`cfg.train.overlap_eval`; the port's eval is synchronous), data
parallelism and ZeRO, and the drill knobs (`PBT_FAULT_*`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import PretrainConfig
from proteinbert_tpu_torch.configs.config import config_to_dict
from proteinbert_tpu_torch.data.prefetch import prefetch
from proteinbert_tpu_torch.obs import as_telemetry
from proteinbert_tpu_torch.parallel.halo import group_size
from proteinbert_tpu_torch.parallel.seq_parallel import (
    make_seq_parallel_train_step,
)
from proteinbert_tpu_torch.train import train_state as ts
from proteinbert_tpu_torch.train.checkpoint import Checkpointer
from proteinbert_tpu_torch.train.metrics import StepTimer
from proteinbert_tpu_torch.train.resilience import (
    GracefulShutdown, check_finite, flush_inflight_checkpoint,
)
from proteinbert_tpu_torch.train.schedule import plateau_uses_eval

logger = logging.getLogger(__name__)


def eval_generator(cfg: PretrainConfig, step: int, batch_index: int,
                   device: torch.device) -> torch.Generator:
    """The corruption generator of eval batch `batch_index` at `step`: a
    pure function of (seed, step, batch), so evals are reproducible."""
    seed = ((cfg.train.seed + 1) * 1_000_003 + step) * 1_009 + batch_index
    return torch.Generator(device=device).manual_seed(seed)


def evaluate(state: ts.TrainState, batches: Iterable[Dict[str, Any]],
             cfg: PretrainConfig, step: int) -> Dict[str, float]:
    """Row-weighted mean of `eval_step` metrics over `batches`, keys
    prefixed with eval_."""
    dev = ts.tree_leaves(state.params)[0].device
    sums: Dict[str, float] = {}
    rows = 0
    for n, batch in enumerate(batches):
        b_rows = len(next(iter(batch.values())))
        m = ts.eval_step(state, batch, eval_generator(cfg, step, n, dev),
                         cfg)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v) * b_rows
        rows += b_rows
    return {f"eval_{k}": v / max(rows, 1) for k, v in sums.items()}


def pretrain(
    cfg: PretrainConfig,
    batch_iterator,
    state: Optional[ts.TrainState] = None,
    checkpointer: Optional[Checkpointer] = None,
    eval_batches: Optional[Callable[[], Iterable]] = None,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
    telemetry=None,
    device: DeviceLike = None,
    seq_group=None,
) -> Dict[str, Any]:
    """Run the pretraining loop; returns {"state", "history", "perf",
    "preempted", "early_stopped"}.

    batch_iterator: an iterator of CLEAN {"tokens", "annotations"} numpy
      batches (packed: plus "segment_ids", annotations (B, S, A)), or — on
      resume, preferred — a callable `(skip_batches) -> iterator` that
      skips the consumed batches without loading them.
    state: continue from this state; else fresh from `cfg.train.seed`,
      and restored from `checkpointer` when it holds a step.
    checkpointer: saves at the `cfg.checkpoint.every_steps` cadence, on
      preemption, at an early stop and at the end.
    eval_batches: callable() -> iterator of held-out CLEAN batches,
      scored every cfg.train.eval_every steps (history gets eval_*).
    log_fn: callable(step, metrics) at each log and eval point.
    telemetry: an obs.Telemetry; None is the do-nothing facade.
    device: None means "cuda" (raises without a card); "cpu" runs the
      plain path.
    seq_group: a `torch.distributed` process group (size 1 allowed): every
      step runs sequence-parallel over it (dense batches only). Every rank
      of the group calls `pretrain` with the same arguments (and a
      Checkpointer made with the same group).
    Raises NonFiniteLossError at a log point whose loss or grad norm is
    not finite, under cfg.train.on_nan == "halt".
    """
    device = resolve_device(device)
    tele = as_telemetry(telemetry)
    eval_keyed_plateau = plateau_uses_eval(cfg.optimizer)
    if eval_keyed_plateau and (eval_batches is None
                               or not cfg.train.eval_every):
        raise ValueError(
            "optimizer.plateau_metric='eval_loss' needs a cadenced eval "
            "stream: pass eval_batches and set train.eval_every > 0")
    if cfg.train.early_stop_patience and (eval_batches is None
                                          or not cfg.train.eval_every):
        raise ValueError(
            "train.early_stop_patience needs a cadenced eval stream: "
            "pass eval_batches and set train.eval_every > 0")
    world = 1
    seq_len = cfg.data.seq_len
    if seq_group is not None:
        if eval_keyed_plateau:
            raise ValueError(
                "plateau_metric='eval_loss' is not supported with the "
                "explicit sequence-parallel pallas step (its shard_map "
                "step takes no plateau_value input)")
        step_fn = make_seq_parallel_train_step(seq_group, cfg)
        world = group_size(seq_group)
        seq_len //= world
    else:
        def step_fn(state, batch):
            return ts.train_step(state, batch, cfg)

    batches_consumed = 0
    # Eval-stream state, checkpointed with the data position (JAX
    # trainer.py:129-143): the last eval loss feeds the eval-keyed
    # plateau (+inf = none yet), best/stalled drive early stopping.
    last_eval_loss = np.float32(np.inf)
    best_eval_loss = float("inf")
    stalled_evals = 0
    if state is None:
        state = ts.create_train_state(
            torch.Generator().manual_seed(cfg.train.seed), cfg, device)
        if checkpointer is not None and checkpointer.latest_step() is not None:
            if tele.enabled:
                checkpointer.on_note = lambda **f: tele.emit("note", **f)
            state, data_state = checkpointer.restore(state)
            batches_consumed = int((data_state or {}).get("batches_consumed",
                                                          0))
            es = (data_state or {}).get("eval_stream") or {}
            if es:
                # None encodes +inf (inf is not strict JSON).
                last_eval_loss = np.float32(
                    es["last"] if es.get("last") is not None else np.inf)
                best_eval_loss = (float(es["best"])
                                  if es.get("best") is not None
                                  else float("inf"))
                stalled_evals = int(es.get("stalled", 0))
            logger.info("resumed from checkpoint at step %d (%d batches "
                        "consumed)", state.step, batches_consumed)

    def data_state_for(consumed: int) -> Dict[str, Any]:
        d: Dict[str, Any] = {"batches_consumed": consumed}
        if np.isfinite(last_eval_loss) or stalled_evals:
            d["eval_stream"] = {
                "last": (float(last_eval_loss)
                         if np.isfinite(last_eval_loss) else None),
                "best": (float(best_eval_loss)
                         if np.isfinite(best_eval_loss) else None),
                "stalled": stalled_evals,
            }
        return d

    if callable(batch_iterator):
        batch_iterator = batch_iterator(batches_consumed)
    elif batches_consumed:
        logger.warning(
            "resuming with a plain iterator: draining %d consumed batches "
            "(pass a factory to skip them for free)", batches_consumed)
        for _ in range(batches_consumed):
            next(batch_iterator)

    prefetch_it = None
    if cfg.data.prefetch_depth > 0:
        # Hide the host's batch production (HDF5 reads, tokenization)
        # behind the asynchronously enqueued step.
        batch_iterator = prefetch_it = prefetch(batch_iterator,
                                                cfg.data.prefetch_depth)

    start_step = int(state.step)
    history: list = []

    if tele.enabled:
        if checkpointer is not None:
            checkpointer.on_event = (
                lambda phase, save_step, **info:
                tele.emit("ckpt_stage", step=save_step, phase=phase, **info))
        tele.emit(
            "run_start", step=start_step, config=config_to_dict(cfg),
            jax_version="none", torch_version=torch.__version__,
            pid=os.getpid(), mesh=None, n_chips=world,
            resumed=bool(batches_consumed), zero_update=False)

    if eval_keyed_plateau and not np.isfinite(last_eval_loss):
        # One eval before the first step seeds the plateau stream, so
        # every observed value is eval-scale (JAX trainer.py:326-344).
        em = evaluate(state, eval_batches(), cfg, start_step)
        last_eval_loss = np.float32(em["eval_loss"])
        best_eval_loss = min(best_eval_loss, float(em["eval_loss"]))
        history.append({"step": start_step, **em})
        tele.emit("eval", step=start_step, metrics=em, seed=True)
        logger.info("seed eval at step %d: eval loss %.4f (plateau "
                    "baseline)", start_step, em["eval_loss"])
        if log_fn is not None:
            log_fn(start_step, em)

    if (cfg.checkpoint.warm_start and checkpointer is not None
            and checkpointer.latest_step() is None):
        # The first save's one-time costs (directory, saver thread, host
        # copy) land before the timer anchors.
        if checkpointer.save(start_step, state, data_state_for(start_step)):
            checkpointer.wait()
            logger.info("warm-start checkpoint at step %d (pre-timer)",
                        start_step)
        else:
            logger.warning("warm-start save at step %d was skipped by "
                           "the checkpointer", start_step)

    timer = StepTimer(cfg.model, cfg.data.batch_size, seq_len, device)
    preempted = False
    early_stopped = False
    diagnostic_saved = False
    ckpt_since_log = False  # a save started since the last log point
    overlap_ckpt = (checkpointer is not None and cfg.checkpoint.overlap
                    and world == 1)

    def flush_staged_overlap():
        # Backpressure: at most one stage; the wait stays in the window,
        # the stage's hidden seconds go to the overlap account.
        if checkpointer is None:
            return
        t0 = time.perf_counter()
        stats = checkpointer.flush_staged()
        if stats:
            stall = time.perf_counter() - t0
            timer.overlap(max(stats.get("overlap_s", 0.0) - stall, 0.0))

    def harvest_staged():
        if checkpointer is None:
            return
        stats = checkpointer.poll_staged()
        if stats:
            timer.overlap(stats.get("overlap_s", 0.0))

    def checked_save(save_step, save_state):
        flush_staged_overlap()  # one save writing at a time
        if not checkpointer.save(save_step, save_state,
                                 data_state_for(save_step)):
            logger.warning(
                "checkpoint save at step %d was SKIPPED by the checkpointer "
                "(directory already holds a step >= %d) — state was NOT "
                "written", save_step, save_step)
            return False
        return True

    with GracefulShutdown(
        on_signal=((lambda signum: tele.dump_flight(f"signal_{signum}"))
                   if tele.enabled else None)
    ) as stop, (contextlib.nullcontext() if prefetch_it is None
                else contextlib.closing(prefetch_it)):
        for step in range(start_step, cfg.train.max_steps):
            batch = next(batch_iterator)
            if eval_keyed_plateau:
                state, metrics = ts.train_step(state, batch, cfg,
                                               plateau_value=last_eval_loss)
            else:
                state, metrics = step_fn(state, batch)
            timer.update()

            if step == start_step and device.type == "cuda":
                torch.cuda.synchronize(device)
                props = torch.cuda.get_device_properties(device)
                stats = {"bytes_in_use": torch.cuda.memory_allocated(device),
                         "peak_bytes_in_use":
                         torch.cuda.max_memory_allocated(device),
                         "bytes_limit": props.total_memory}
                logger.info("device memory after first step: %.2f GB in "
                            "use (peak %.2f) of %.2f GB",
                            stats["bytes_in_use"] / 1e9,
                            stats["peak_bytes_in_use"] / 1e9,
                            stats["bytes_limit"] / 1e9)
                for k, v in stats.items():
                    tele.metrics.gauge(f"hbm_{k}").set(v)

            if cfg.train.log_every and (step + 1) % cfg.train.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                timer.sync()
                if cfg.train.on_nan != "off" and not check_finite(
                        m, step + 1, mode="quiet"):
                    # Keep the blown-up state for debugging, once, in a
                    # SIBLING directory: it must never become the step a
                    # restart resumes from.
                    if checkpointer is not None and not diagnostic_saved:
                        diag = Checkpointer(
                            checkpointer.directory + "-diagnostic",
                            max_to_keep=1, async_save=False,
                            seq_group=seq_group)
                        diag.save(step + 1, state,
                                  {**data_state_for(step + 1),
                                   "non_finite": True})
                        diag.close()
                        diagnostic_saved = True
                        logger.warning("non-finite state preserved in %s",
                                       checkpointer.directory
                                       + "-diagnostic")
                    tele.emit("nan_halt", step=step + 1, metrics=m,
                              mode=cfg.train.on_nan)
                    if cfg.train.on_nan == "halt":
                        flush_inflight_checkpoint(checkpointer,
                                                  "non-finite halt")
                        tele.emit("run_end", step=step + 1,
                                  outcome="nan_halt", perf=timer.summary())
                        tele.dump_flight("nan_halt")
                    check_finite(m, step + 1, mode=cfg.train.on_nan)
                harvest_staged()
                m.update(timer.summary())
                if checkpointer is not None:
                    m["ckpt_in_flight"] = float(checkpointer.in_flight()
                                                or ckpt_since_log)
                    ckpt_since_log = False
                history.append({"step": step + 1, **m})
                if tele.enabled:
                    extra = {}
                    reg = tele.metrics
                    if prefetch_it is not None:
                        extra["data_wait_s"] = round(prefetch_it.wait_s, 4)
                        reg.gauge("data_wait_seconds").set(
                            prefetch_it.wait_s)
                        reg.gauge("data_batches_total").set(
                            prefetch_it.batches)
                    try:
                        import resource
                        import sys as _sys

                        # ru_maxrss: kilobytes on Linux, bytes on macOS.
                        rss = resource.getrusage(
                            resource.RUSAGE_SELF).ru_maxrss
                        rss *= 1 if _sys.platform == "darwin" else 1024
                        extra["host_max_rss_bytes"] = rss
                        reg.gauge("host_max_rss_bytes").set(rss)
                    except Exception:
                        pass  # non-POSIX host: the RSS gauge is absent
                    tele.emit("step", step=step + 1, metrics=m, **extra)
                    reg.counter("steps_total").inc(cfg.train.log_every)
                    reg.set_many(m)
                logger.info(
                    "step %d loss %.4f (local %.4f global %.4f) acc %.3f%s%s",
                    step + 1, m["loss"], m["local_loss"], m["global_loss"],
                    m["local_acc"],
                    (f" {m['residues_per_sec_per_chip']:.0f} res/s/chip"
                     if "residues_per_sec_per_chip" in m else ""),
                    (f" MFU {m['mfu']:.3f}"
                     + (f" (window {m['window_mfu']:.3f})"
                        if "window_mfu" in m else "")
                     if "mfu" in m else ""))
                if log_fn is not None:
                    log_fn(step + 1, m)

            if stop.requested:
                # Preemption: checkpoint the completed step and return;
                # a resume picks up exactly here.
                timer.sync()
                saved = False
                if checkpointer is not None:
                    flush_inflight_checkpoint(
                        checkpointer, "preemption (SIGTERM/SIGINT)")
                    saved = checked_save(step + 1, state)
                    checkpointer.wait()
                logger.warning("preempted at step %d: %s, exiting",
                               step + 1,
                               "state saved" if saved else "state NOT saved")
                tele.emit("requeue", step=step + 1,
                          reason=f"signal_{stop.signum}", saved=saved)
                tele.dump_flight(f"signal_{stop.signum}")
                preempted = True
                break

            if (eval_batches is not None and cfg.train.eval_every
                    and (step + 1) % cfg.train.eval_every == 0):
                timer.sync()
                t_eval = time.perf_counter()
                with tele.span("eval_bracket", step=step + 1):
                    em = evaluate(state, eval_batches(), cfg, step + 1)
                timer.discount(time.perf_counter() - t_eval)
                history.append({"step": step + 1, **em})
                tele.emit("eval", step=step + 1, metrics=em)
                logger.info(
                    "step %d eval loss %.4f (local %.4f global %.4f) "
                    "acc %.3f", step + 1, em["eval_loss"],
                    em["eval_local_loss"], em["eval_global_loss"],
                    em["eval_local_acc"])
                if log_fn is not None:
                    log_fn(step + 1, em)
                last_eval_loss = np.float32(em["eval_loss"])
                if (em["eval_loss"]
                        < best_eval_loss - cfg.train.early_stop_min_delta):
                    best_eval_loss = em["eval_loss"]
                    stalled_evals = 0
                else:
                    stalled_evals += 1
                    if (cfg.train.early_stop_patience and stalled_evals
                            >= cfg.train.early_stop_patience):
                        timer.sync()
                        if checkpointer is not None:
                            checked_save(step + 1, state)
                            checkpointer.wait()
                        logger.warning(
                            "early stop at step %d: eval_loss has not "
                            "improved for %d consecutive evals (best %.4f)",
                            step + 1, stalled_evals, best_eval_loss)
                        early_stopped = True
                        break

            if (checkpointer is not None and cfg.checkpoint.every_steps
                    and (step + 1) % cfg.checkpoint.every_steps == 0):
                if overlap_ckpt:
                    # No drain: the snapshot is a copy on the train stream,
                    # ordered before the next step's in-place update; the
                    # copy to the host and the write run on the saver
                    # thread and land in the overlap account.
                    with tele.span("ckpt_boundary_staged", step=step + 1):
                        flush_staged_overlap()
                        checkpointer.save_staged(step + 1, state,
                                                 data_state_for(step + 1))
                    ckpt_since_log = True
                else:
                    timer.sync()
                    t_save = time.perf_counter()
                    with tele.span("ckpt_boundary_sync", step=step + 1):
                        checked_save(step + 1, state)
                    ckpt_since_log = True
                    timer.discount(time.perf_counter() - t_save)

    if not preempted and not early_stopped:
        timer.sync()
        if checkpointer is not None:
            flush_staged_overlap()
            if checkpointer.latest_step() != cfg.train.max_steps:
                checked_save(cfg.train.max_steps, state)
            checkpointer.wait()

    perf = timer.summary()
    tele.emit("run_end", step=int(state.step),
              outcome=("preempted" if preempted
                       else "early_stopped" if early_stopped
                       else "completed"),
              perf=perf)
    return {"state": state, "history": history, "perf": perf,
            "preempted": preempted, "early_stopped": early_stopped}
