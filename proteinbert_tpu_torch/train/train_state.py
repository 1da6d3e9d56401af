"""Train state and the train/eval steps — port of
`proteinbert_tpu/train/train_state.py` for dense and packed rows.

`TrainState` bundles the step count, the params tree, the optimizer state
and the corruption generator (a `torch.Generator` on the params' device
in place of the JAX PRNG key). `train_step` corrupts the clean batch on
the device, runs the forward through the block kernels (on CUDA) or their
plain versions (on the CPU), takes the dual masked loss, backpropagates
(each kernel's gradient recomputes its plain version,
`kernels/autograd.py`), and applies clip → Adam [→ plateau]. The step
updates the params and optimizer moments IN PLACE and returns the state
with its count advanced; the JAX step returns new arrays.

The attention mask is the JAX training mask `W["local"] > 0`, the clean
sequence's non-pad positions. A batch with "segment_ids" is PACKED
(data/packing.py): it corrupts segment-aware (`corrupt_packed_batch`),
runs the packed model with no pad mask (so `encode` derives it from
`segment_ids > 0`) and takes the per-segment `packed_pretrain_loss`, as
the JAX step chooses from the batch's keys.

Data parallelism (`make_data_parallel_train_step`, the JAX `train_step`
jitted under a data mesh): each data rank of a `parallel.mesh.Mesh` runs
the forward and backward on its B/data rows, and its objective is its
SHARE of the global loss — its own numerators over the weight masses
summed across the data group (`loss.pretrain_loss_terms`; JAX
quant.py:331-367), so the shares sum to the global loss whatever each
rank's masses are (a mean of per-rank losses would not). The masses and
numerators are summed in one small all-reduce before the backward (so
the metrics are the global batch's on every rank), the gradients with
one all-reduce of one flat fp32 buffer after it, and every rank applies
the same `gradient_update`.
Each rank corrupts its rows with a generator derived from the state's
generator and its data index (`replica_generators`); the state's
generator advances identically on every rank. A data group of one rank
corrupts with the state's generator itself, so a one-rank run is the
plain step bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import PretrainConfig
from proteinbert_tpu_torch.data.corruption import (
    corrupt_batch, corrupt_packed_batch,
)
from proteinbert_tpu_torch.models import proteinbert
from proteinbert_tpu_torch.parallel.zero import all_reduce, all_reduce_flat
from proteinbert_tpu_torch.train.loss import (
    global_ranking_metrics, global_ranking_stats, loss_from_terms,
    packed_loss_terms, pretrain_loss_terms,
)
from proteinbert_tpu_torch.train.schedule import (
    OptState, Optimizer, effective_lr, global_norm, make_optimizer,
    needs_loss_value, plateau_uses_eval, tree_leaves,
)

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """`layout`: a `parallel.fsdp.MeshLayout` when the params and moments
    are this rank's shards of a data × fsdp × model mesh (the sharded
    step's state), else None (whole tensors)."""
    step: int
    params: Any
    opt_state: OptState
    generator: torch.Generator
    layout: Any = None


def gradient_update(
    tx: Optimizer, params: Any, grads, opt_state: OptState,
    loss: Any = None, needs_value: bool = False,
) -> Tuple[Any, OptState]:
    """Optimizer apply: updates from `tx`, added to the params in place
    (under no_grad). Returns (params, opt_state)."""
    with torch.no_grad():
        updates, opt_state = tx.update(
            list(grads), opt_state, params,
            value=loss if needs_value else None)
        torch._foreach_add_(tree_leaves(params), updates)
    return params, opt_state


def _to_device(batch: Dict[str, Any], device: torch.device) -> Batch:
    """The batch's arrays on `device`. To a card they go up from pinned
    host memory without a host wait (a pageable copy synchronizes the
    stream, which would stall the host behind queued steps or evals);
    the pinned buffer is held until its copy has run."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def _corrupt(gen: torch.Generator, batch: Dict[str, Any],
             cfg: PretrainConfig, device: torch.device):
    """(X, Y, W, segment_ids or None) for a dense or packed clean batch."""
    b = _to_device(batch, device)
    probs = dict(token_randomize_prob=cfg.data.token_randomize_prob,
                 annotation_corrupt_prob=cfg.data.annotation_corrupt_prob,
                 annotation_drop_prob=cfg.data.annotation_drop_prob,
                 annotation_add_prob=cfg.data.annotation_add_prob)
    if "segment_ids" in b:
        seg = b["segment_ids"]
        return (*corrupt_packed_batch(gen, b["tokens"], seg,
                                      b["annotations"], **probs), seg)
    return (*corrupt_batch(gen, b["tokens"], b["annotations"], **probs),
            None)


def corrupt_for_step(state: TrainState, batch: Dict[str, Any],
                     cfg: PretrainConfig,
                     generator: Optional[torch.Generator] = None):
    """Corrupt the CLEAN batch on the state's device with `generator`
    (default: the state's) → (X, Y, W, segment_ids), segment_ids None for
    a dense batch."""
    dev = tree_leaves(state.params)[0].device
    return _corrupt(state.generator if generator is None else generator,
                    batch, cfg, dev)


def forward_logits(params: Any, X: Batch, W: Batch, cfg: PretrainConfig,
                   segment_ids: Optional[torch.Tensor] = None, tp=None):
    """(local_logits, global_logits) of a corrupted batch: dense rows under
    the training mask `W["local"] > 0`, packed rows (`segment_ids`)
    through the packed model; `tp`: the GO head's tensor parallelism."""
    if segment_ids is not None:
        return proteinbert.apply(params, X["local"], X["global"], cfg.model,
                                 segment_ids=segment_ids, tp=tp)
    return proteinbert.apply(params, X["local"], X["global"], cfg.model,
                             W["local"] > 0, tp=tp)


def loss_terms(local_logits, global_logits, Y: Batch, W: Batch,
               segment_ids: Optional[torch.Tensor] = None):
    """The loss's (numerators, denominators): per segment for a packed
    batch, else dense."""
    if segment_ids is not None:
        return packed_loss_terms(local_logits, global_logits, Y, W,
                                 segment_ids)
    return pretrain_loss_terms(local_logits, global_logits, Y, W)


def forward_loss(params: Any, X: Batch, Y: Batch, W: Batch,
                 cfg: PretrainConfig,
                 segment_ids: Optional[torch.Tensor] = None):
    """(loss, metrics, local_logits, global_logits) of a corrupted batch:
    dense rows under the training mask `W["local"] > 0`, packed rows
    (`segment_ids`) through the packed model and the per-segment loss."""
    local_logits, global_logits = forward_logits(params, X, W, cfg,
                                                 segment_ids)
    loss, metrics = loss_from_terms(*loss_terms(
        local_logits, global_logits, Y, W, segment_ids))
    return loss, metrics, local_logits, global_logits


def loss_and_grads(params: Any, X: Batch, Y: Batch, W: Batch,
                   cfg: PretrainConfig,
                   segment_ids: Optional[torch.Tensor] = None):
    """Forward, dual masked loss and backward on a corrupted batch (packed
    when `segment_ids` is given) → (grads aligned with
    `tree_leaves(params)`, loss metrics)."""
    return grads_of(params, lambda: forward_loss(params, X, Y, W, cfg,
                                                 segment_ids)[:2])


def grads_of(params: Any, loss_fn):
    """`loss_fn() → (loss, metrics)` run with the params' leaves requiring
    grad → (d loss / d leaves aligned with `tree_leaves(params)`, zeros for
    an unused leaf; the metrics detached)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, metrics = loss_fn()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return grads, {k: v.detach() for k, v in metrics.items()}


def corrupt_forward_grads(state: TrainState, batch: Dict[str, Any],
                          cfg: PretrainConfig):
    """Corrupt, forward, loss, backward → (grads, loss metrics)."""
    X, Y, W, seg = corrupt_for_step(state, batch, cfg)
    return loss_and_grads(state.params, X, Y, W, cfg, seg)


def _seed(state_bytes: bytes, label: str) -> int:
    digest = hashlib.blake2b(state_bytes + label.encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") & (2 ** 63 - 1)


def replica_generators(state: TrainState, mesh,
                       labels: Sequence[str]) -> List[torch.Generator]:
    """This step's generators of this data rank, one per label, seeded
    from the state's generator and the rank's data index; the state's
    generator then advances once, on the host and identically on every
    rank (so a resumed run stays in lockstep)."""
    gen = state.generator
    st = gen.get_state().numpy().tobytes()
    out = [torch.Generator(device=gen.device).manual_seed(
        _seed(st, f"{label}/{mesh.data_index}")) for label in labels]
    gen.manual_seed(_seed(st, "next"))
    return out


def replica_generator(state: TrainState, mesh) -> torch.Generator:
    """The corruption generator of this data rank: the state's own when
    the data extent is 1 (the plain step's draws), else derived."""
    if mesh.data_extent == 1:
        return state.generator
    return replica_generators(state, mesh, ("corrupt",))[0]


def replica_loss_and_grads(params: Any, X: Batch, Y: Batch, W: Batch,
                           cfg: PretrainConfig,
                           segment_ids: Optional[torch.Tensor], group,
                           registry=None):
    """This data rank's share of the global loss on its corrupted rows →
    (partial gradients aligned with `tree_leaves(params)`, the global
    batch's loss metrics). The weight masses and the loss numerators are
    summed over `group` in one all-reduce before the backward; the
    partials summed over the group are the gradient of the global loss."""
    out = {}

    def share():
        ll, gl = forward_logits(params, X, W, cfg, segment_ids)
        nums, dens = loss_terms(ll, gl, Y, W, segment_ids)
        loss, out["metrics"] = global_loss_share(nums, dens, group, registry)
        return loss, {}

    grads, _ = grads_of(params, share)
    return grads, {k: v.detach() for k, v in out["metrics"].items()}


def global_loss_share(nums: Batch, dens: Batch, group, registry=None):
    """(this rank's share of the global loss — its numerators over the
    weight masses summed over `group` —, the global loss metrics), with
    one all-reduce of the masses and the numerators (none without a
    group)."""
    sums = all_reduce(torch.stack(
        [dens["local"], dens["global"], nums["local"], nums["global"],
         nums["local_acc"]]).detach(), group, registry)
    total = {"local": sums[0], "global": sums[1]}
    loss, _ = loss_from_terms(nums, total)
    _, metrics = loss_from_terms(
        {"local": sums[2], "global": sums[3], "local_acc": sums[4]}, total)
    return loss, metrics


def corrupt_replica_grads(state: TrainState, batch: Dict[str, Any],
                          cfg: PretrainConfig, mesh, registry=None,
                          generator: Optional[torch.Generator] = None):
    """Corrupt this rank's CLEAN rows (with `generator`, default
    `replica_generator`), then `replica_loss_and_grads` over the mesh's
    data group — the front half of every data-parallel step → (partial
    gradients, global metrics)."""
    X, Y, W, seg = corrupt_for_step(
        state, batch, cfg,
        replica_generator(state, mesh) if generator is None else generator)
    return replica_loss_and_grads(state.params, X, Y, W, cfg, seg,
                                  mesh.data_group, registry)


def plateau_observation(cfg_opt, metrics: Dict[str, torch.Tensor],
                        plateau_value: Any) -> torch.Tensor:
    """The value the plateau transform observes this step: the train
    loss, or — under an eval-keyed plateau with a finite caller-provided
    value — the latest cadenced eval loss (+inf means "no eval yet" and
    falls back to the train loss so the placeholder can't tick the
    patience counter)."""
    value = metrics["loss"]
    if plateau_uses_eval(cfg_opt) and plateau_value is not None:
        pv = torch.as_tensor(plateau_value, dtype=torch.float32,
                             device=value.device)
        value = torch.where(torch.isfinite(pv), pv, value)
    return value


def create_train_state(generator: torch.Generator, cfg: PretrainConfig,
                       device: DeviceLike = None) -> TrainState:
    """Fresh params from `generator` (model.init), a zero optimizer
    state, and a corruption generator on `device` seeded from
    `generator` (None → "cuda")."""
    device = resolve_device(device)
    params = proteinbert.init(cfg.model, generator, device=device)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(0, params, make_optimizer(cfg.optimizer).init(params),
                      gen)


def train_step(
    state: TrainState, batch: Dict[str, Any], cfg: PretrainConfig,
    plateau_value: Any = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One pretraining step on a CLEAN {"tokens", "annotations"} numpy or
    tensor batch (packed: plus "segment_ids", annotations (B, S, A)) →
    (state with step + 1, device metrics). The params and
    optimizer moments are updated in place. A plateau schedule observes
    the step's train loss, or `plateau_value` when
    cfg.optimizer.plateau_metric == "eval_loss" (the trainer passes the
    latest cadenced eval loss; +inf falls back to the train loss, see
    `plateau_observation`)."""
    grads, metrics = corrupt_forward_grads(state, batch, cfg)
    metrics = dict(metrics)
    metrics["grad_norm"] = global_norm(grads)  # before the in-place clip
    value = plateau_observation(cfg.optimizer, metrics, plateau_value)
    params, opt_state = gradient_update(
        make_optimizer(cfg.optimizer), state.params, grads, state.opt_state,
        value, needs_loss_value(cfg.optimizer))
    metrics["lr"] = effective_lr(cfg.optimizer, opt_state, state.step)
    return TrainState(state.step + 1, params, opt_state,
                      state.generator), metrics


def make_data_parallel_train_step(mesh, cfg: PretrainConfig, registry=None):
    """`step(state, batch, plateau_value=None) → (state, metrics)`, the
    replicated data-parallel step over `mesh`'s data group: this rank's
    share of the global loss on its rows, one flat all-reduce of the
    gradients, then `gradient_update` on every rank. The
    metrics are the global batch's, the same on every rank; `registry`
    receives the comm accounting."""
    group = mesh.data_group

    def step(state: TrainState, batch: Dict[str, Any],
             plateau_value: Any = None):
        grads, metrics = corrupt_replica_grads(state, batch, cfg, mesh,
                                               registry)
        grads = all_reduce_flat(grads, group, registry)
        metrics["grad_norm"] = global_norm(grads)
        value = plateau_observation(cfg.optimizer, metrics, plateau_value)
        params, opt_state = gradient_update(
            make_optimizer(cfg.optimizer), state.params, grads,
            state.opt_state, value, needs_loss_value(cfg.optimizer))
        metrics["lr"] = effective_lr(cfg.optimizer, opt_state, state.step)
        return TrainState(state.step + 1, params, opt_state,
                          state.generator), metrics

    return step


def eval_step(
    state: TrainState, batch: Dict[str, Any], generator: torch.Generator,
    cfg: PretrainConfig,
) -> Dict[str, torch.Tensor]:
    """Corrupted-input eval with a caller-provided generator
    (deterministic): loss metrics plus the GO head's ranking metrics
    (`global_auroc` / `global_p_at_k` exact in the batch, and
    `ranking_stats`, the mergeable statistic `trainer.evaluate_batches`
    pools over a split). A packed batch is scored with the per-segment
    loss, and its ranking metrics see each packed protein as its own row
    ((B, S, A) flattened to (B·S, A); empty segment slots carry zero
    weight)."""
    dev = tree_leaves(state.params)[0].device
    X, Y, W, seg = _corrupt(generator, batch, cfg, dev)
    with torch.no_grad():
        _, metrics, _, global_logits = forward_loss(state.params, X, Y, W,
                                                    cfg, seg)
        A = global_logits.shape[-1]
        flat = [t.reshape(-1, A) for t in (global_logits, Y["global"],
                                           W["global"])]
        metrics.update(global_ranking_metrics(*flat))
        metrics["ranking_stats"] = global_ranking_stats(*flat)
    return metrics
