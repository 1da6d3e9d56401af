"""The pretraining loop — port of `proteinbert_tpu/train/trainer.py`
(`pretrain`) for dense and packed rows on one device, data-parallel over
a mesh (replicated, ZeRO-1, or ZeRO-1 with a quantized reduce-scatter),
and for dense rows sequence-parallel over a process group or a data ×
seq mesh.

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

`mesh` (`parallel.mesh.make_mesh`, one process a card) chooses the step
as the JAX trainer does: the sequence-parallel step when its seq extent
is above 1 (with an fsdp or model axis as well, on the sharded layout of
`parallel/fsdp.py`, ZeRO-1 under `cfg.parallel.zero_update` and "bf16"
as JAX's cast of the reduced gradients); the sharded step of `parallel/fsdp.py` when its fsdp or model extent is
above 1 (FSDP placement, the GO head's tensor parallelism, with ZeRO-1
under `cfg.parallel.zero_update`, and then the quantized reduce-scatter
over data·fsdp for a `grad_reduce_dtype` other than "fp32",
`parallel/quant.make_quant_fsdp_train_step`); else ZeRO-1
(`parallel/zero.py`, or
the quantized reduce-scatter of `parallel/quant.py` when
`cfg.parallel.grad_reduce_dtype` is not "fp32") when
`cfg.parallel.zero_update` and the replica extent is above 1; else the
replicated data-parallel step (`train_state.
make_data_parallel_train_step`). The JAX warnings are logged when
`zero_update` or `grad_reduce_dtype` cannot take effect.
`cfg.data.batch_size` is the GLOBAL batch of a step, as on a single JAX
host: the iterator of each rank yields its batch_size / (data·fsdp) rows
(a batch that does not split is refused), its seq and model ranks the
same rows. On the sharded step the state is this rank's shards
(`TrainState.layout`) from the first step on; a fresh or restored state
is cut to them before the loop.
Every rank calls `pretrain` with the same arguments and a Checkpointer
made with the same mesh. A preemption signal stops every rank at the
same step: each step the ranks agree on it with one small all-reduce
(MAX) before any of them acts on it, since the save that follows makes
collectives. Evals corrupt each replica's rows with the replica's own
draws and pool their sums and ranking statistics across the joint
replica group (data·fsdp), so a model rank's copy of its replica's rows
is counted once; on the sharded step they read the params gathered to
full shape. `perf` counts this rank's share of its replica's rows (the
rows over `model`), the collectives' bytes go to the telemetry registry
(`collective_bytes{kind}`, `collective_wire_bytes{kind}`), `run_start`
carries the mesh, the rank count and whether ZeRO is on, and the
`per_chip_state_bytes{part}` gauges follow the rules (params at their
fsdp or model shard, the moments at their ZeRO shard).

The eval bracket (JAX trainer.py:389-390, :681-699). Under
`cfg.train.overlap_eval` (the presets' default), without an eval-keyed
plateau and without early stopping (both need the eval's value before
the next step), the boundary only dispatches the eval (`dispatch_eval`,
nothing fetched: the metric scalars stay on the device) and the next
step's dispatch comes first; `resolve_eval` then makes the one fetch
right after that step is queued, before a checkpoint boundary builds
its data item, and once after the loop. Otherwise the bracket is
synchronous (`evaluate`). Both routes give the same records, keyed by
the 1-based boundary step, and discount the bracket's host seconds from
the timing window. The drill knobs of the JAX loop:
`PBT_FAULT_STALL_AT="<step>:<seconds>"` sleeps at the top of that
1-based step, inside the timed window; `PBT_FAULT_EVAL_STALL="<seconds>"`
sleeps inside every eval bracket, where the time is discounted. A
malformed spec is logged and ignored.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import PretrainConfig
from proteinbert_tpu_torch.configs.config import config_to_dict
from proteinbert_tpu_torch.data.prefetch import prefetch
from proteinbert_tpu_torch.obs import as_telemetry
from proteinbert_tpu_torch.parallel.fsdp import make_sharded_train_step
from proteinbert_tpu_torch.parallel.halo import group_size
from proteinbert_tpu_torch.parallel.seq_parallel import (
    make_seq_parallel_train_step,
)
from proteinbert_tpu_torch.parallel.sharding import local_batch_size
from proteinbert_tpu_torch.parallel.zero import (
    all_reduce, make_zero_train_step, per_chip_state_bytes, zero_extent,
)
from proteinbert_tpu_torch.train import train_state as ts
from proteinbert_tpu_torch.train.checkpoint import Checkpointer
from proteinbert_tpu_torch.train.loss import (
    DEFAULT_RANKING_BINS, ranking_metrics_from_stats,
)
from proteinbert_tpu_torch.train.metrics import (
    DeviceMetricAccumulator, StepTimer, copy_to_host,
)
from proteinbert_tpu_torch.train.resilience import (
    GracefulShutdown, check_finite, flush_inflight_checkpoint,
)
from proteinbert_tpu_torch.train.schedule import plateau_uses_eval
from proteinbert_tpu_torch.utils.profiling import device_memory_report

logger = logging.getLogger(__name__)


def _parse_fault_secs(secs_s):
    """Seconds for a drill knob, or ValueError. Rejects what time.sleep
    would crash or hang on (negative, NaN, inf): the drill contract is
    "malformed specs are ignored, not fatal" — a drill knob must never
    be able to kill an uncheckpointed run."""
    secs = float(secs_s)
    if not (0 <= secs < float("inf")):
        raise ValueError(secs_s)
    return secs


def _fault_stall_spec():
    """Observability-drill fault injection: parse
    PBT_FAULT_STALL_AT="<1-based step>:<seconds>" into (step, secs).
    The trainer sleeps that long at the top of the named step — INSIDE
    the timed window, like a real host-side stall (slow async-save
    serialization, input starvation, a tunnel hiccup) — so a drill can
    assert the window_* metrics and the slow-window summary localize it.
    Never set in production; the spec is logged loudly when active."""
    spec = os.environ.get("PBT_FAULT_STALL_AT")
    if not spec:
        return None
    try:
        step_s, _, secs_s = spec.partition(":")
        step = int(step_s)
        if step < 1:
            raise ValueError(spec)
        return step, _parse_fault_secs(secs_s)
    except ValueError:
        logger.warning("ignoring malformed PBT_FAULT_STALL_AT=%r", spec)
        return None


def _fault_eval_stall_secs():
    """Companion drill knob: PBT_FAULT_EVAL_STALL="<seconds>" sleeps
    inside every eval bracket — INSIDE the discounted region, so the
    drill can assert a slow eval does NOT masquerade as a training
    stall in the window metrics (the negative control for the
    PBT_FAULT_STALL_AT positive). Same ignore-malformed contract."""
    spec = os.environ.get("PBT_FAULT_EVAL_STALL")
    if not spec:
        return None
    try:
        return _parse_fault_secs(spec)
    except ValueError:
        logger.warning("ignoring malformed PBT_FAULT_EVAL_STALL=%r", spec)
        return None


def eval_generator(cfg: PretrainConfig, step: int, batch_index: int,
                   device: torch.device,
                   data_index: int = 0) -> torch.Generator:
    """The corruption generator of eval batch `batch_index` at `step` on
    data rank `data_index`: a pure function of (seed, step, batch, data
    rank), so evals are reproducible and the data ranks draw independent
    noise (rank 0 draws what one process draws)."""
    seed = ((cfg.train.seed + 1) * 1_000_003 + step) * 1_009 + batch_index
    if data_index:
        seed = (seed * 1_000_033 + data_index) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


def eval_generators(cfg: PretrainConfig, step: int, device: torch.device,
                    group=None) -> Callable[[int], torch.Generator]:
    """batch index → `eval_generator` of this rank's data index in `group`
    (0 without one)."""
    index = 0 if group is None else dist.get_rank(group)
    return lambda n: eval_generator(cfg, step, n, device, index)


def stop_agreed(stop, group, device: torch.device) -> bool:
    """Whether any rank of `group` was asked to stop (`stop.requested`,
    MAX over one all-reduce of a one-element flag; the local flag without
    a group). Every rank calls it at the same point of every step, so
    the collectives a stop then makes (the save's gathers and barrier)
    start on every rank together. The flag is read on the host: one
    synchronization a step."""
    if group is None:
        return stop.requested
    on = device if dist.get_backend(group) == "nccl" else "cpu"
    flag = torch.tensor([int(stop.requested)], dtype=torch.int32, device=on)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


_EVAL_SUMS = ("loss", "local_loss", "global_loss", "local_acc",
              "global_auroc_batch_mean", "global_p_at_k_batch_mean")


def _pool(sums: Dict[str, float], n: int, rows: int, rank_stats, group,
          device: torch.device):
    """Every data rank's eval sums, counts and ranking statistics summed
    over `group` with one all-reduce (a rank without batches adds
    zeros) → (sums, n, rows, rank_stats). The vector lies on the card
    for NCCL, else on the host (gloo reduces there either way)."""
    on = device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    stats = rank_stats or {
        "pos_hist": torch.zeros(DEFAULT_RANKING_BINS, device=on),
        "neg_hist": torch.zeros(DEFAULT_RANKING_BINS, device=on),
        "p_at_k_num": torch.zeros((), device=on),
        "p_at_k_den": torch.zeros((), device=on)}
    names = list(stats)
    head = torch.tensor([sums.get(k, 0.0) for k in _EVAL_SUMS] + [n, rows],
                        dtype=torch.float64, device=on)
    vec = torch.cat([head] + [stats[k].double().reshape(-1).to(on)
                              for k in names])
    all_reduce(vec, group)
    head, off = vec[:len(head)].tolist(), len(head)
    pooled = {}
    for k in names:
        size = stats[k].numel()
        pooled[k] = vec[off:off + size].float().reshape(
            stats[k].shape).cpu()
        off += size
    n, rows = int(head[-2]), int(head[-1])
    return (dict(zip(_EVAL_SUMS, head)) if n else {}, n, rows,
            pooled if n else None)


_POOLED = ("global_auroc", "global_p_at_k")


def _batch_mean_key(k: str) -> str:
    return f"{k}_batch_mean" if k in _POOLED else k


@dataclasses.dataclass
class PendingEval:
    """What `dispatch_eval` queued: the per-batch metric scalars (in the
    accumulator, on the device), the ranking statistics summed on the
    device, the batch and row counts, the data `group` to pool over, and
    the state the batches read. Holding `state` keeps a gathered
    full-shape params tree (an fsdp layout's `eval_state()`) alive until
    the resolve, so the caching allocator cannot hand its memory to the
    next step while the eval's kernels may still read it."""
    acc: DeviceMetricAccumulator
    rank_stats: Optional[Dict[str, torch.Tensor]]
    n: int
    rows: int
    group: Any
    device: torch.device
    state: Any
    stats_ready: Any = None   # the event of the statistics' host copy


def dispatch_eval(state: ts.TrainState, batches: Iterable[Dict[str, Any]],
                  cfg: PretrainConfig,
                  generator_for: Callable[[int], torch.Generator],
                  max_batches: int = 0, drain_every: int = 8,
                  group=None) -> PendingEval:
    """Queue `eval_step` over `batches` (batch n corrupted under
    `generator_for(n)`; at most `max_batches` when > 0) → a
    `PendingEval` for `resolve_eval`. Each batch's metrics go into a
    `DeviceMetricAccumulator` weighted by its rows (the exact in-batch
    `global_auroc` / `global_p_at_k` renamed `*_batch_mean`), its
    `ranking_stats` are summed on the device. With `drain_every=0`
    nothing is fetched: on the card the call only enqueues work (the
    batches go up from pinned memory without a wait), so the host can
    queue the next train step behind it."""
    if max_batches:
        # Cap before pulling: no extra batch read and dropped.
        batches = itertools.islice(batches, max_batches)
    acc = DeviceMetricAccumulator(drain_every=drain_every)
    rank_stats = None
    n = rows = 0
    for batch in batches:
        b_rows = len(next(iter(batch.values())))
        m = ts.eval_step(state, batch, generator_for(n), cfg)
        stats = m.pop("ranking_stats")
        rank_stats = stats if rank_stats is None else {
            k: rank_stats[k] + v for k, v in stats.items()}
        acc.add(m, weight=b_rows, key_fn=_batch_mean_key)
        n += 1
        rows += b_rows
    pending = PendingEval(acc, rank_stats, n, rows, group,
                          ts.tree_leaves(state.params)[0].device, state)
    if not drain_every:
        # The one fetch, queued now behind the eval's work: the resolve
        # then waits for these copies alone, not for the train step
        # queued after them.
        acc.prefetch()
        if rank_stats is not None:
            host, pending.stats_ready = copy_to_host(list(
                rank_stats.values()))
            pending.rank_stats = dict(zip(rank_stats, host))
    return pending


def resolve_eval(pending: PendingEval, prefix: str = "eval_"):
    """Fetch and reduce a `dispatch_eval` handle → (metrics, batches,
    rows). Loss and accuracy metrics are the row-weighted means of the
    per-batch values; `global_auroc` / `global_p_at_k` are pooled over
    the whole split from the summed `ranking_stats`, as the JAX
    package's `resolve_eval` does. With a data `group`, each rank scored
    its own rows and the sums, counts and statistics are pooled across
    the group (one all-reduce, `_pool`), so the metrics are the whole
    split's on every rank; every rank must resolve at the same point."""
    sums = pending.acc.sums()
    n, rows, rank_stats = pending.n, pending.rows, pending.rank_stats
    ready = pending.stats_ready
    if ready is None and rank_stats is not None:
        # The statistics in one host copy and one wait (the synchronous
        # route's; the overlapped dispatch queued its copy already).
        host, ready = copy_to_host(list(rank_stats.values()))
        rank_stats = dict(zip(rank_stats, host))
    if ready is not None:
        ready.synchronize()
    if pending.group is not None:
        sums, n, rows, rank_stats = _pool(sums, n, rows, rank_stats,
                                          pending.group, pending.device)
    metrics = {f"{prefix}{k}": v / max(rows, 1) for k, v in sums.items()}
    if rank_stats is not None:
        metrics.update({f"{prefix}{k}": v for k, v in
                        ranking_metrics_from_stats(
                            {k: v.numpy() for k, v in rank_stats.items()}
                        ).items()})
    return metrics, n, rows


def evaluate_batches(state: ts.TrainState, batches: Iterable[Dict[str, Any]],
                     cfg: PretrainConfig,
                     generator_for: Callable[[int], torch.Generator],
                     max_batches: int = 0, group=None):
    """The synchronous eval: `resolve_eval(dispatch_eval(...))` with
    unprefixed keys → (metrics, batches, rows) — the CLI `evaluate`
    verb's path."""
    return resolve_eval(dispatch_eval(state, batches, cfg, generator_for,
                                      max_batches=max_batches, group=group),
                        prefix="")


def evaluate(state: ts.TrainState, batches: Iterable[Dict[str, Any]],
             cfg: PretrainConfig, step: int, group=None) -> Dict[str, float]:
    """`evaluate_batches` under the step-keyed generators of this data
    rank (pooled over a data `group`), keys prefixed with eval_."""
    dev = ts.tree_leaves(state.params)[0].device
    metrics, _, _ = resolve_eval(dispatch_eval(
        state, batches, cfg, eval_generators(cfg, step, dev, group),
        group=group))
    return metrics


def first_step_memory(tele, device: torch.device) -> Optional[Dict]:
    """One-time device memory report once the first step is resident
    (the JAX trainer's HBM report): the card's `device_memory_report()`
    entry, logged and set as the `hbm_bytes_in_use`,
    `hbm_peak_bytes_in_use` and `hbm_bytes_limit` gauges. A CPU device
    reports no stats: silent, as the JAX trainer is on a CPU backend."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stats = device_memory_report().get(f"cuda:{index}")
    if not stats:
        return None
    logger.info("device memory after first step: %.2f GB in use (peak "
                "%.2f) of %.2f GB", stats["bytes_in_use"] / 1e9,
                stats["peak_bytes_in_use"] / 1e9, stats["bytes_limit"] / 1e9)
    for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
        tele.metrics.gauge(f"hbm_{k}").set(stats[k])
    return stats


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
    mesh=None,
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
    mesh: a `parallel.mesh.Mesh` (not with seq_group): data parallelism,
      FSDP, the model axis, ZeRO-1 and the sequence-parallel step, as the
      module docstring says; `batch_iterator` then yields this rank's
      batch_size / (data·fsdp) rows.
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
    ranks = 1
    rows = cfg.data.batch_size
    seq_len = cfg.data.seq_len
    zero_on = (mesh is not None and cfg.parallel.zero_update
               and zero_extent(mesh) > 1)
    if cfg.parallel.zero_update and not zero_on:
        logger.warning(
            "parallel.zero_update requested but %s — running the "
            "replicated update",
            "no mesh was passed" if mesh is None
            else "the mesh has data*fsdp == 1 (nothing to shard across)")
    if cfg.parallel.grad_reduce_dtype != "fp32" and not zero_on:
        logger.warning(
            "parallel.grad_reduce_dtype=%r has no effect without an "
            "active ZeRO-1 update (zero_update on a data*fsdp > 1 "
            "mesh) — the replicated step reduces gradients at fp32",
            cfg.parallel.grad_reduce_dtype)

    def plateau_step(state, batch, value):
        return ts.train_step(state, batch, cfg, plateau_value=value)

    seq_extent = (group_size(seq_group) if mesh is None
                  else mesh.shape["seq"])
    if seq_extent > 1 or seq_group is not None:
        if eval_keyed_plateau:
            raise ValueError(
                "plateau_metric='eval_loss' is not supported with the "
                "explicit sequence-parallel pallas step (its shard_map "
                "step takes no plateau_value input)")
    if mesh is not None:
        if seq_group is not None:
            raise ValueError("pass a seq_group or a mesh, not both")
        ranks = mesh.size
        rows = local_batch_size(cfg.data.batch_size, mesh.data_extent)
        if seq_extent > 1:
            step_fn = make_seq_parallel_train_step(
                mesh.seq_group, cfg, mesh=mesh, registry=tele.metrics)
            seq_len //= seq_extent
            kind = "the sequence-parallel step"
            if mesh.sharded:
                reduce = (f", ZeRO-1, gradient reduction "
                          f"{cfg.parallel.grad_reduce_dtype}"
                          if zero_on else "")
                kind += (f" on the sharded layout (fsdp="
                         f"{mesh.shape['fsdp']}, model="
                         f"{mesh.shape['model']}{reduce})")
        elif mesh.sharded:
            step_fn = plateau_step = make_sharded_train_step(
                mesh, cfg, registry=tele.metrics)
            reduce = (f", ZeRO-1, gradient reduction "
                      f"{cfg.parallel.grad_reduce_dtype}" if zero_on else "")
            kind = (f"the sharded step (fsdp={mesh.shape['fsdp']}, model="
                    f"{mesh.shape['model']}{reduce})")
        elif zero_on:
            step_fn = plateau_step = make_zero_train_step(
                mesh, cfg, registry=tele.metrics)
            kind = (f"the ZeRO-1 update, gradient reduction "
                    f"{cfg.parallel.grad_reduce_dtype}")
        else:
            step_fn = plateau_step = ts.make_data_parallel_train_step(
                mesh, cfg, registry=tele.metrics)
            kind = "the replicated data-parallel step"
        logger.info("mesh %s over %d ranks: %s", mesh.shape, ranks, kind)
    elif seq_group is not None:
        step_fn = make_seq_parallel_train_step(seq_group, cfg)
        ranks = group_size(seq_group)
        seq_len //= ranks
    else:
        def step_fn(state, batch):
            return ts.train_step(state, batch, cfg)
    if checkpointer is not None and checkpointer.world != ranks:
        raise ValueError(
            f"the checkpointer is shared by {checkpointer.world} ranks, the "
            f"run has {ranks}: make it with the run's mesh (or seq_group)")
    eval_group = None if mesh is None else mesh.replica_group
    layout_for = getattr(step_fn, "layout_for", None)
    stop_group = (None if ranks == 1 else
                  dist.group.WORLD if mesh is not None else seq_group)

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
        if layout_for is not None:   # the restore template: this rank's
            state = layout_for(state).shard_state(state)
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

    if layout_for is not None:
        state = layout_for(state).shard_state(state)

    def eval_state():
        """The state the evals read: the params at full shape."""
        if state.layout is None:
            return state
        return ts.TrainState(state.step,
                             state.layout.full_params(state.params),
                             state.opt_state, state.generator)

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
            pid=os.getpid(), mesh=None if mesh is None else dict(mesh.shape),
            n_chips=ranks, resumed=bool(batches_consumed),
            zero_update=zero_on)
        if mesh is not None:
            # Per-rank persistent state bytes under the rules (the ZeRO-1
            # memory claim, from shapes alone).
            for part, n in per_chip_state_bytes(
                    mesh, state, zero_update=zero_on).items():
                tele.metrics.gauge("per_chip_state_bytes", part=part).set(n)

    if eval_keyed_plateau and not np.isfinite(last_eval_loss):
        # One eval before the first step seeds the plateau stream, so
        # every observed value is eval-scale (JAX trainer.py:326-344).
        em = evaluate(eval_state(), eval_batches(), cfg, start_step,
                      eval_group)
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

    # A model rank counts its share of its replica's rows.
    timer = StepTimer(cfg.model, rows if mesh is None
                      else rows / mesh.shape["model"], seq_len, device)
    preempted = False
    early_stopped = False
    diagnostic_saved = False
    ckpt_since_log = False  # a save started since the last log point
    overlap_ckpt = (checkpointer is not None and cfg.checkpoint.overlap
                    and ranks == 1)

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

    # The overlapped eval bracket is legal only when nothing needs the
    # eval's value before the next step: an eval-keyed plateau feeds it
    # to the optimizer, and early stopping decides at the boundary.
    overlap_eval = (cfg.train.overlap_eval and not eval_keyed_plateau
                    and not cfg.train.early_stop_patience)
    pending_eval = None   # (1-based boundary step, PendingEval)

    def record_eval(e_step, em, **extra):
        """The eval's history record, event, log line and eval-stream
        bookkeeping (the same on both routes, so the checkpointed
        eval_stream is too) → whether early stopping is due."""
        nonlocal last_eval_loss, best_eval_loss, stalled_evals
        history.append({"step": e_step, **em})
        tele.emit("eval", step=e_step, metrics=em, **extra)
        logger.info("step %d eval loss %.4f (local %.4f global %.4f) "
                    "acc %.3f", e_step, em["eval_loss"],
                    em["eval_local_loss"], em["eval_global_loss"],
                    em["eval_local_acc"])
        if log_fn is not None:
            log_fn(e_step, em)
        last_eval_loss = np.float32(em["eval_loss"])
        if em["eval_loss"] < best_eval_loss - cfg.train.early_stop_min_delta:
            best_eval_loss = em["eval_loss"]
            stalled_evals = 0
            return False
        stalled_evals += 1
        return bool(cfg.train.early_stop_patience and stalled_evals
                    >= cfg.train.early_stop_patience)

    def resolve_pending_eval():
        """Land an overlapped eval: right after the next step's dispatch
        (so the one fetch waits only for the eval's device work queued
        ahead of that step), before a checkpoint boundary builds its data
        item, and after the loop. The wait is eval time: discounted."""
        nonlocal pending_eval
        if pending_eval is None:
            return
        e_step, handle = pending_eval
        pending_eval = None
        t0 = time.perf_counter()
        em, _, _ = resolve_eval(handle)
        timer.discount(time.perf_counter() - t0)
        record_eval(e_step, em, overlapped=True)

    fault_stall = _fault_stall_spec()
    if fault_stall:
        logger.warning("FAULT INJECTION ACTIVE: %.1fs stall at step %d "
                       "(PBT_FAULT_STALL_AT)", fault_stall[1],
                       fault_stall[0])
    fault_eval_stall = _fault_eval_stall_secs()
    if fault_eval_stall:
        logger.warning("FAULT INJECTION ACTIVE: %.1fs stall per eval "
                       "bracket (PBT_FAULT_EVAL_STALL)", fault_eval_stall)

    with GracefulShutdown(
        on_signal=((lambda signum: tele.dump_flight(f"signal_{signum}"))
                   if tele.enabled else None)
    ) as stop, (contextlib.nullcontext() if prefetch_it is None
                else contextlib.closing(prefetch_it)):
        for step in range(start_step, cfg.train.max_steps):
            batch = next(batch_iterator)
            if fault_stall and step + 1 == fault_stall[0]:
                # An injected host stall, inside the timed window: the
                # drill asserts that it shows there.
                time.sleep(fault_stall[1])
            if eval_keyed_plateau:
                state, metrics = plateau_step(state, batch, last_eval_loss)
            else:
                state, metrics = step_fn(state, batch)
            timer.update()
            # An overlapped eval lands here, behind this step's dispatch.
            # Under a data group every rank resolves at this point of
            # this step, so `_pool`'s all-reduce meets the same call on
            # every rank, after the step's collectives and before
            # `stop_agreed`.
            resolve_pending_eval()

            if step == start_step:
                first_step_memory(tele, device)

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
                            seq_group=seq_group, mesh=mesh)
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

            if stop_agreed(stop, stop_group, device):
                # Preemption (on this rank or another): checkpoint the
                # completed step and return; a resume picks up exactly
                # here.
                reason = (f"signal_{stop.signum}" if stop.requested
                          else "signal_on_another_rank")
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
                tele.emit("requeue", step=step + 1, reason=reason,
                          saved=saved)
                tele.dump_flight(reason)
                preempted = True
                break

            if (eval_batches is not None and cfg.train.eval_every
                    and (step + 1) % cfg.train.eval_every == 0):
                # Drain first, so that neither route's discount swallows
                # queued step time; afterwards the eval's batches are the
                # only work the card has queued.
                timer.sync()
                t_eval = time.perf_counter()
                if fault_eval_stall:
                    # Injected inside the discounted bracket: the drill
                    # asserts that it does NOT show as a slow window.
                    time.sleep(fault_eval_stall)
                if overlap_eval:
                    # Dispatch only; the records come at the resolve.
                    # On the card the eval is correct because every one
                    # of its kernels is queued on this stream before the
                    # next step's in-place updates (`_foreach_add_`, the
                    # optimizer): no part of it may run on another
                    # stream. The staged saver's side stream reads the
                    # snapshot, whose event is recorded after this
                    # dispatch. The handle holds the state it read (on an
                    # fsdp layout the gathered full params) until then.
                    # The span is the bracket's host time on this route.
                    es = eval_state()
                    with tele.span("eval_bracket", step=step + 1):
                        handle = dispatch_eval(
                            es, eval_batches(), cfg, eval_generators(
                                cfg, step + 1,
                                ts.tree_leaves(es.params)[0].device,
                                eval_group),
                            drain_every=0, group=eval_group)
                    timer.discount(time.perf_counter() - t_eval)
                    pending_eval = (step + 1, handle)
                else:
                    with tele.span("eval_bracket", step=step + 1):
                        em = evaluate(eval_state(), eval_batches(), cfg,
                                      step + 1, eval_group)
                    timer.discount(time.perf_counter() - t_eval)
                    if record_eval(step + 1, em):
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
                # The eval stream must be current in this boundary's data
                # item, on either save route (a same-step overlapped eval
                # is still pending).
                resolve_pending_eval()
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

    # An eval dispatched at the last step lands before the final save.
    resolve_pending_eval()
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
