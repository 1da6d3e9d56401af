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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import PretrainConfig
from proteinbert_tpu_torch.data.corruption import (
    corrupt_batch, corrupt_packed_batch,
)
from proteinbert_tpu_torch.models import proteinbert
from proteinbert_tpu_torch.train.loss import (
    global_ranking_metrics, global_ranking_stats, packed_pretrain_loss,
    pretrain_loss,
)
from proteinbert_tpu_torch.train.schedule import (
    OptState, Optimizer, effective_lr, global_norm, make_optimizer,
    needs_loss_value, plateau_uses_eval, tree_leaves,
)

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: OptState
    generator: torch.Generator


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
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device)
            for k, v in batch.items()}


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
                     cfg: PretrainConfig):
    """Corrupt the CLEAN batch on the state's device with the state's
    generator → (X, Y, W, segment_ids), segment_ids None for a dense
    batch."""
    dev = tree_leaves(state.params)[0].device
    return _corrupt(state.generator, batch, cfg, dev)


def forward_loss(params: Any, X: Batch, Y: Batch, W: Batch,
                 cfg: PretrainConfig,
                 segment_ids: Optional[torch.Tensor] = None):
    """(loss, metrics, local_logits, global_logits) of a corrupted batch:
    dense rows under the training mask `W["local"] > 0`, packed rows
    (`segment_ids`) through the packed model and the per-segment loss."""
    if segment_ids is not None:
        local_logits, global_logits = proteinbert.apply(
            params, X["local"], X["global"], cfg.model,
            segment_ids=segment_ids)
        loss, metrics = packed_pretrain_loss(local_logits, global_logits, Y,
                                             W, segment_ids)
    else:
        local_logits, global_logits = proteinbert.apply(
            params, X["local"], X["global"], cfg.model, W["local"] > 0)
        loss, metrics = pretrain_loss(local_logits, global_logits, Y, W)
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
