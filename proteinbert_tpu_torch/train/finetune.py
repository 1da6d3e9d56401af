"""Epoch-based fine-tuning — port of `proteinbert_tpu/train/finetune.py`.

- `finetune_step`: forward through the trunk's kernels (`models/
  finetune.apply`), the task loss, backward, clip → Adam(W) with the
  schedule (`train/schedule.make_optimizer`); trunk and head in one
  gradient, or the head alone under `task.freeze_trunk`;
- `finetune`: the epoch loop with per-epoch eval and best-epoch
  selection, per-epoch checkpoints through `train/checkpoint.
  Checkpointer` (the epoch count as the step, the history and the best
  epoch as the data item), resume, and the optional registration of the
  trained head (`heads/registry.HeadRegistry`, a `head_registered`
  event);
- `task_loss` by TaskConfig.kind: softmax cross-entropy per residue with
  -1 labels and <pad> left out, per protein, or the squared error of a
  per-protein scalar, all from logits.

`freeze_trunk`. The JAX optimizer wraps the whole chain, clip included,
in `optax.multi_transform` with `set_to_zero` on the trunk, so the
global-norm clip sees the head's gradients alone, the trunk has no Adam
moments and no weight decay, and its weights never change. Here the
optimizer is built over the head's leaves alone (`trained_params`), which
is the same arithmetic, and the trunk's forward runs without autograd, so
its backward is skipped: the head's gradients are the same, and the trunk
is untouched bit for bit.

The state is a `train_state.TrainState` ({"trunk", "head"} params, the
optimizer state of the trained leaves, a generator the step never draws
from), so the pretraining Checkpointer saves and restores it unchanged.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import FinetuneConfig
from proteinbert_tpu_torch.configs.config import config_to_dict
from proteinbert_tpu_torch.data.vocab import PAD_ID
from proteinbert_tpu_torch.models import finetune as ft_model
from proteinbert_tpu_torch.models import proteinbert
from proteinbert_tpu_torch.obs import as_telemetry
from proteinbert_tpu_torch.train.metrics import DeviceMetricAccumulator
from proteinbert_tpu_torch.train.schedule import (
    Optimizer, make_optimizer, needs_loss_value, tree_leaves,
)
from proteinbert_tpu_torch.train.train_state import (
    TrainState, _to_device, gradient_update, grads_of,
)

logger = logging.getLogger(__name__)


def make_finetune_optimizer(cfg: FinetuneConfig) -> Optimizer:
    """The chain of `cfg.optimizer`, applied to `trained_params`."""
    return make_optimizer(cfg.optimizer)


def trained_params(params: Dict[str, Any], cfg: FinetuneConfig):
    """The subtree the optimizer updates: the head alone under
    `task.freeze_trunk`, else {"trunk", "head"}."""
    return params["head"] if cfg.task.freeze_trunk else params


def create_finetune_state(generator: torch.Generator, cfg: FinetuneConfig,
                          pretrained_trunk: Optional[Any] = None,
                          device: DeviceLike = None) -> TrainState:
    """A fresh state: the trunk from `pretrained_trunk` (its pretraining
    heads dropped) or drawn from `generator`, a head drawn from
    `generator`, and a zero optimizer state over `trained_params`."""
    device = resolve_device(device)
    params = ft_model.init(generator, cfg.model, cfg.task, pretrained_trunk,
                           device)
    opt_state = make_finetune_optimizer(cfg).init(trained_params(params,
                                                                 cfg))
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed)
    return TrainState(0, params, opt_state, gen)


def _cross_entropy(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels: logsumexp minus
    the label's logit."""
    label_logits = logits.gather(-1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def task_loss(outputs: torch.Tensor, batch: Dict[str, torch.Tensor],
              kind: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch. `batch["labels"]`: (B, L) int for
    token_classification (-1 and <pad> positions ignored), (B,) int for
    sequence_classification, (B,) float for sequence_regression."""
    labels = batch["labels"]
    if kind == "token_classification":
        w = ((batch["tokens"] != PAD_ID) & (labels >= 0)).float()
        safe = labels.clamp_min(0)
        ce = _cross_entropy(outputs, safe)
        denom = w.sum().clamp_min(1.0)
        loss = (ce * w).sum() / denom
        acc = ((outputs.argmax(-1) == safe).float() * w).sum() / denom
        return loss, {"loss": loss, "accuracy": acc}
    if kind == "sequence_classification":
        loss = _cross_entropy(outputs, labels).mean()
        acc = (outputs.argmax(-1) == labels).float().mean()
        return loss, {"loss": loss, "accuracy": acc}
    if kind == "sequence_regression":
        err = outputs[..., 0] - labels.float()
        loss = (err ** 2).mean()
        return loss, {"loss": loss, "mae": err.abs().mean()}
    raise ValueError(f"unknown task kind {kind!r}")


def _outputs(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
             cfg: FinetuneConfig, frozen: bool) -> torch.Tensor:
    """`models/finetune.apply`; with `frozen` the trunk runs without
    autograd (nothing upstream of the head needs a gradient)."""
    if not frozen:
        return ft_model.apply(params, batch["tokens"], cfg.model, cfg.task,
                              batch.get("annotations"))
    with torch.no_grad():
        trunk_out = proteinbert.encode_trunk(
            params["trunk"], batch["tokens"], cfg.model,
            batch.get("annotations"))
    return ft_model.apply_head(params["head"], trunk_out["local"],
                               trunk_out["global"], trunk_out["pad_mask"],
                               cfg.task.kind)


def loss_and_grads(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   cfg: FinetuneConfig):
    """Forward, task loss and backward of a tensor batch on the params'
    device → (grads aligned with `tree_leaves(trained_params(params,
    cfg))`, the loss metrics)."""
    return grads_of(trained_params(params, cfg), lambda: task_loss(
        _outputs(params, batch, cfg, cfg.task.freeze_trunk), batch,
        cfg.task.kind))


def finetune_step(state: TrainState, batch: Dict[str, Any],
                  cfg: FinetuneConfig
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step on a {"tokens", "labels"[, "annotations"]} numpy or tensor
    batch → (state with step + 1, device metrics). The trained params and
    the optimizer moments are updated in place."""
    dev = tree_leaves(state.params)[0].device
    grads, metrics = loss_and_grads(state.params, _to_device(batch, dev),
                                    cfg)
    _, opt_state = gradient_update(
        make_finetune_optimizer(cfg), trained_params(state.params, cfg),
        grads, state.opt_state, metrics["loss"],
        needs_loss_value(cfg.optimizer))
    return TrainState(state.step + 1, state.params, opt_state,
                      state.generator), metrics


def finetune_eval_step(state: TrainState, batch: Dict[str, Any],
                       cfg: FinetuneConfig) -> Dict[str, torch.Tensor]:
    dev = tree_leaves(state.params)[0].device
    b = _to_device(batch, dev)
    with torch.no_grad():
        outputs = ft_model.apply(state.params, b["tokens"], cfg.model,
                                 cfg.task, b.get("annotations"))
        _, metrics = task_loss(outputs, b, cfg.task.kind)
    return metrics


def _means(acc: DeviceMetricAccumulator) -> Dict[str, float]:
    """Each metric's mean over the batches added: the accumulator's
    float64 sums over its count (the JAX loops' arithmetic)."""
    n = acc.count
    return {k: v / max(n, 1) for k, v in acc.sums().items()}


def evaluate(state: TrainState, batches: Iterable[Dict[str, Any]],
             cfg: FinetuneConfig) -> Dict[str, float]:
    """Mean metrics over an eval split; the per-batch scalars stay on
    the device until a drain (`DeviceMetricAccumulator`)."""
    acc = DeviceMetricAccumulator()
    for batch in batches:
        acc.add(finetune_eval_step(state, batch, cfg))
    return _means(acc)


def finetune(
    cfg: FinetuneConfig,
    train_batches,
    eval_batches=None,
    state: Optional[TrainState] = None,
    pretrained_trunk: Optional[Any] = None,
    checkpointer=None,
    log_fn=None,
    telemetry=None,
    registry=None,
    register_name: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """The epoch loop → {"state", "history", "best", "head_id"}.

    train_batches: callable(epoch) → iterator of batches.
    eval_batches: callable() → iterator, or None; scored every
      `task.eval_every_epochs` epochs and after the last.
    `best` is the best eval epoch by accuracy (classification) or −loss
    (regression). With a `checkpointer` each epoch's state is saved at
    step = epochs completed, with {"history", "best"}; a fresh call on a
    directory that holds a step resumes after it (ValueError when it
    already holds `task.epochs` epochs). With a `registry` the trained
    head is registered against the fingerprint of the trunk it was
    trained with (the pretrained one under freeze_trunk), with the last
    and best metrics, and a `head_registered` event is emitted.
    device: None means "cuda" (raises without a card)."""
    device = resolve_device(device)
    tele = as_telemetry(telemetry)
    start_epoch = 0
    history: list = []
    best: Dict[str, Any] = {"epoch": -1, "score": -float("inf")}
    if state is None:
        state = create_finetune_state(
            torch.Generator().manual_seed(cfg.train.seed), cfg,
            pretrained_trunk, device)
        if checkpointer is not None and checkpointer.latest_step() is not None:
            start_epoch = checkpointer.latest_step()
            if start_epoch >= cfg.task.epochs:
                raise ValueError(
                    f"checkpoint dir {checkpointer.directory} already holds "
                    f"{start_epoch} completed epochs >= task.epochs="
                    f"{cfg.task.epochs}; use a fresh directory or raise "
                    "task.epochs to continue training")
            state, data = checkpointer.restore(state)
            data = data or {}
            history = list(data.get("history", []))
            best = dict(data.get("best", best))
            logger.info("resumed fine-tune after epoch %d", start_epoch)

    tele.emit("run_start", step=start_epoch, kind="finetune",
              config=config_to_dict(cfg), jax_version="none",
              torch_version=torch.__version__, pid=os.getpid(),
              resumed=bool(start_epoch))

    for epoch in range(start_epoch, cfg.task.epochs):
        acc = DeviceMetricAccumulator()
        for batch in train_batches(epoch):
            state, metrics = finetune_step(state, batch, cfg)
            acc.add(metrics)
        record = {"epoch": epoch, **{f"train_{k}": v for k, v in
                                     _means(acc).items()}}
        if eval_batches is not None and (
                (epoch + 1) % cfg.task.eval_every_epochs == 0
                or epoch == cfg.task.epochs - 1):
            with tele.span("finetune_eval", step=epoch + 1):
                em = evaluate(state, eval_batches(), cfg)
            record.update({f"eval_{k}": v for k, v in em.items()})
            tele.emit("eval", step=epoch + 1, metrics=em, kind="finetune")
            score = em.get("accuracy", -em.get("loss", float("inf")))
            if score > best["score"]:
                best = {"epoch": epoch, "score": score, **record}
        history.append(record)
        tele.emit("step", step=epoch + 1, metrics=record, kind="finetune")
        logger.info("finetune %s", record)
        if log_fn is not None:
            log_fn(epoch, record)
        if checkpointer is not None:
            checkpointer.save(epoch + 1, state,
                              {"history": history, "best": best})

    if checkpointer is not None:
        checkpointer.wait()

    head_id = None
    if registry is not None:
        from proteinbert_tpu_torch.heads.registry import trunk_fingerprint

        # The trunk the head was trained against: the pretrained one under
        # freeze_trunk, the co-trained one otherwise.
        fp = trunk_fingerprint(state.params["trunk"], cfg.model.scan_blocks)
        metrics = {k: v for k, v in (history[-1] if history else {}).items()
                   if isinstance(v, (int, float))}
        metrics.update({k: v for k, v in best.items()
                        if k.startswith(("eval_", "train_"))
                        and isinstance(v, (int, float))})
        head_id = registry.save(
            state.params["head"], cfg.task, fp, name=register_name,
            metrics=metrics, model={"local_dim": cfg.model.local_dim,
                                    "global_dim": cfg.model.global_dim})
        tele.emit("head_registered", head_id=head_id, kind=cfg.task.kind,
                  name=register_name or head_id, trunk_fingerprint=fp,
                  metrics=metrics)
        logger.info("registered head %s (%s) in %s", head_id,
                    cfg.task.kind, registry.directory)

    tele.emit("run_end", outcome="completed", kind="finetune",
              perf={"best_epoch": best["epoch"],
                    "best_score": best["score"]})
    return {"state": state, "history": history, "best": best,
            "head_id": head_id}
