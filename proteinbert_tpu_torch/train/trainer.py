"""The pretraining loop — port of `proteinbert_tpu/train/trainer.py`
(`pretrain`) for dense and packed rows on one device, and for dense rows
sequence-parallel over a process group.

`pretrain(cfg, batch_iterator, ...)` creates or continues a train state,
runs `cfg.train.max_steps` steps of `train_step`, logs every
`cfg.train.log_every` steps, scores `eval_batches()` every
`cfg.train.eval_every` steps under a step-keyed generator (so an eval is
reproducible), and returns {"state", "history", "perf"}. It trains
whatever batches its iterator yields: dense ones (`make_pretrain_iterator`)
or packed ones (`data/packing.make_packed_iterator`, a "segment_ids" key),
each step choosing its branch from the batch as the JAX step does. `perf`
is the StepTimer summary: step ms, tokens/s (B·L positions a step, pad
included, as the JAX timer counts) and, on a card with a published peak,
MFU.

`seq_group` (a `torch.distributed` process group) trains through the
explicit sequence-parallel step (`parallel/seq_parallel.
make_seq_parallel_train_step`), as the JAX trainer does when
`cfg.mesh.seq > 1 and cfg.model.use_pallas` (trainer.py:257-268). The port
has no mesh, so the caller's group selects the path, not `cfg.mesh`; a
group of size 1 is allowed. Each rank then runs the same loop on the same
batches, and `perf` counts this rank's B·L/world positions a step.

The NaN halt: at each log point the logged loss and grad norm go through
`train/resilience.check_finite` under `cfg.train.on_nan` ("halt" raises
`NonFiniteLossError`, "warn" logs and continues, "off" skips the check),
as the JAX trainer does (trainer.py:554-586). The JAX trainer first saves
a diagnostic checkpoint; the port has no checkpointer, so it saves
nothing. Checkpointing, resume, preemption, early stopping, the
eval-keyed plateau, data parallelism and telemetry are not ported;
nothing here accepts them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import PretrainConfig
from proteinbert_tpu_torch.parallel.halo import group_size
from proteinbert_tpu_torch.parallel.seq_parallel import (
    make_seq_parallel_train_step,
)
from proteinbert_tpu_torch.train import train_state as ts
from proteinbert_tpu_torch.train.metrics import StepTimer
from proteinbert_tpu_torch.train.resilience import check_finite
from proteinbert_tpu_torch.train.schedule import plateau_uses_eval


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
    eval_batches: Optional[Callable[[], Iterable]] = None,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
    device: DeviceLike = None,
    seq_group=None,
) -> Dict[str, Any]:
    """Run the pretraining loop; returns {"state", "history", "perf"}.

    batch_iterator: an iterator of CLEAN {"tokens", "annotations"} numpy
      batches (packed: plus "segment_ids", annotations (B, S, A)), or a
      callable `(skip_batches) -> iterator`.
    state: continue from this state; fresh from `cfg.train.seed` if None.
    eval_batches: callable() -> iterator of held-out CLEAN batches,
      scored every cfg.train.eval_every steps (history gets eval_*).
    log_fn: callable(step, metrics) at each log and eval point.
    device: None means "cuda" (raises without a card); "cpu" runs the
      plain path.
    seq_group: a `torch.distributed` process group (size 1 allowed): every
      step runs sequence-parallel over it (dense batches only). Every rank
      of the group calls `pretrain` with the same arguments.
    Raises NonFiniteLossError at a log point whose loss or grad norm is
    not finite, under cfg.train.on_nan == "halt".
    """
    device = resolve_device(device)
    if cfg.train.early_stop_patience or plateau_uses_eval(cfg.optimizer):
        raise ValueError("early stopping and an eval-keyed plateau "
                         "(plateau_metric='eval_loss') are not supported by "
                         "the port's trainer")
    seq_len = cfg.data.seq_len
    step_fn = lambda state, batch: ts.train_step(state, batch, cfg)  # noqa: E731
    if seq_group is not None:
        step_fn = make_seq_parallel_train_step(seq_group, cfg)
        seq_len //= group_size(seq_group)
    if state is None:
        state = ts.create_train_state(
            torch.Generator().manual_seed(cfg.train.seed), cfg, device)
    if callable(batch_iterator):
        batch_iterator = batch_iterator(state.step)

    history: list = []
    timer = StepTimer(cfg.model, cfg.data.batch_size, seq_len, device)
    for step in range(state.step, cfg.train.max_steps):
        state, metrics = step_fn(state, next(batch_iterator))
        timer.update()
        if cfg.train.log_every and (step + 1) % cfg.train.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            timer.sync()
            if cfg.train.on_nan != "off":
                check_finite(m, step + 1, mode=cfg.train.on_nan)
            m.update(timer.summary())
            history.append({"step": step + 1, **m})
            if log_fn is not None:
                log_fn(step + 1, m)
        if (eval_batches is not None and cfg.train.eval_every
                and (step + 1) % cfg.train.eval_every == 0):
            timer.sync()
            t0 = time.perf_counter()
            em = evaluate(state, eval_batches(), cfg, step + 1)
            timer.discount(time.perf_counter() - t0)
            history.append({"step": step + 1, **em})
            if log_fn is not None:
                log_fn(step + 1, em)
    timer.sync()
    return {"state": state, "history": history, "perf": timer.summary()}
