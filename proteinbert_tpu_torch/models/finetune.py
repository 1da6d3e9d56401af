"""Task heads on the pretrained trunk — port of
`proteinbert_tpu/models/finetune.py`.

A task head is a plain params dict over the trunk's representation
(`proteinbert.encode_trunk`); trunk and head live in one tree
{"trunk", "head"}, so one backward covers both (or only the head under
`task.freeze_trunk`, train/finetune.py).

Head shapes by task kind (TaskConfig.kind):
  token_classification    local (B, L, C)              → (B, L, num_outputs)
  sequence_classification [global ‖ masked-mean local] → (B, num_outputs)
  sequence_regression     [global ‖ masked-mean local] → (B, 1)

Sequence-level heads read both tracks: the global track and the mean of
the local track over the real positions (the count clamped at 1). The
optional hidden layer uses the tanh GELU, as every layer of the port does.
Head outputs are float32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import ModelConfig, TaskConfig
from proteinbert_tpu_torch.models import proteinbert
from proteinbert_tpu_torch.models.proteinbert import _dense_init, to_device
from proteinbert_tpu_torch.ops.layers import dense_apply, gelu

Params = Dict[str, Any]

KINDS = ("token_classification", "sequence_classification",
         "sequence_regression")
PRETRAIN_HEADS = ("local_head", "global_head")


def head_in_dim(model_cfg: ModelConfig, task: TaskConfig) -> int:
    if task.kind == "token_classification":
        return model_cfg.local_dim
    return model_cfg.global_dim + model_cfg.local_dim


def head_init(generator: torch.Generator, model_cfg: ModelConfig,
              task: TaskConfig, device: DeviceLike = None) -> Params:
    """A fresh head drawn from `generator` (on the CPU), placed on
    `device` (None → "cuda")."""
    if task.kind not in KINDS:
        raise ValueError(f"unknown task kind {task.kind!r}; have {KINDS}")
    device = resolve_device(device)
    in_dim = head_in_dim(model_cfg, task)
    if task.head_hidden_dim:
        head = {"hidden": _dense_init(generator, in_dim,
                                      task.head_hidden_dim),
                "out": _dense_init(generator, task.head_hidden_dim,
                                   task.num_outputs)}
    else:
        head = {"out": _dense_init(generator, in_dim, task.num_outputs)}
    return to_device(head, device)


def init(generator: torch.Generator, model_cfg: ModelConfig,
         task: TaskConfig, pretrained_trunk: Optional[Params] = None,
         device: DeviceLike = None) -> Params:
    """{"trunk", "head"}: the trunk from pretrained params (its
    pretraining heads dropped) or fresh, and a fresh head. The trunk is a
    copy on `device`: the fine-tune step updates its params in place, and
    the caller's pretrained tensors stay as they were."""
    device = resolve_device(device)
    if pretrained_trunk is None:
        pretrained_trunk = proteinbert.init(model_cfg, generator, device)

    def copy(tree):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [copy(v) for v in tree]
        return tree.to(device, copy=True)

    trunk = copy({k: v for k, v in pretrained_trunk.items()
                  if k not in PRETRAIN_HEADS})
    return {"trunk": trunk,
            "head": head_init(generator, model_cfg, task, device)}


def head_apply(head: Params, x: torch.Tensor) -> torch.Tensor:
    """The head's layers on a feature tensor, in x's dtype."""
    if "hidden" in head:
        x = gelu(dense_apply(head["hidden"], x))
    return dense_apply(head["out"], x)


def head_features(local: torch.Tensor, global_: torch.Tensor,
                  pad_mask: torch.Tensor, kind: str) -> torch.Tensor:
    """The trunk representation → the features a `kind` head reads: the
    local track per residue, or [global ‖ masked-mean local] per
    sequence. One definition for `apply` and the serving tails
    (heads/apply.py)."""
    if kind == "token_classification":
        return local
    m = pad_mask.to(local.dtype)[..., None]
    pooled = (local * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return torch.cat([global_, pooled], dim=-1)


def apply_head(head: Params, local: torch.Tensor, global_: torch.Tensor,
               pad_mask: torch.Tensor, kind: str) -> torch.Tensor:
    """One head off an already computed trunk representation: float32
    outputs shaped by `kind` (module doc)."""
    return head_apply(head, head_features(local, global_, pad_mask,
                                          kind)).float()


def apply(params: Params, tokens: torch.Tensor, model_cfg: ModelConfig,
          task: TaskConfig, annotations: Optional[torch.Tensor] = None,
          pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Task outputs in float32: `encode_trunk` → `apply_head`, the
    decomposition the serving path runs. `annotations` defaults to zeros
    (the pretraining corruption's hide-all input)."""
    trunk_out = proteinbert.encode_trunk(params["trunk"], tokens, model_cfg,
                                         annotations, pad_mask)
    return apply_head(params["head"], trunk_out["local"],
                      trunk_out["global"], trunk_out["pad_mask"], task.kind)
