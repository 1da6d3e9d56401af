"""Split apply: one shared trunk pass, many cheap head tails — port of
`proteinbert_tpu/heads/apply.py`.

A batch of requests for DIFFERENT task heads runs the trunk once
(`trunk_batch`, bucketed; `packed_trunk_batch`, ragged): on the card the
trunk goes through the port's kernels (K1 or #3, then K2), and the
serving dispatcher captures it as one CUDA graph per served shape, shared
by every head. Each distinct head then runs its tail (`head_batch` /
`packed_head_batch`: one or two float32-parameter denses over the trunk's
features) over the whole batch, and each row or segment keeps its own
head's output. The tails are plain PyTorch.

`head_batch` composes `models/finetune.apply_head` over
`proteinbert.encode_trunk`, the decomposition `models/finetune.apply` is
built from, so the split path computes what the monolithic one does, and
a row's answer does not depend on which heads share its batch.

A head is any object with `.head_id`, `.task.kind` and `.params`
(heads/registry.LoadedHead); its params may be numpy arrays (as the
registry loads them) or tensors, and go to the trunk's device here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch import inference
from proteinbert_tpu_torch.configs import ModelConfig
from proteinbert_tpu_torch.data.vocab import PAD_ID
from proteinbert_tpu_torch.models import finetune as ft_model
from proteinbert_tpu_torch.models import proteinbert
from proteinbert_tpu_torch.train.schedule import tree_leaves


def head_params_on(params: Any, device: torch.device) -> Any:
    """A head's params as float32 tensors on `device` (no copy for a
    tensor already there)."""
    if isinstance(params, dict):
        return {k: head_params_on(v, device) for k, v in params.items()}
    return torch.as_tensor(params, dtype=torch.float32, device=device)


@torch.inference_mode()
def trunk_batch(params, tokens: torch.Tensor, annotations: torch.Tensor,
                cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The shared trunk: (B, L) tokens + (B, A) annotations → {"local"
    (B, L, C), "global" (B, G), "pad_mask" (B, L) bool}, whichever heads
    read it."""
    return proteinbert.encode_trunk(params, tokens, cfg, annotations)


def head_batch(head, local: torch.Tensor, global_: torch.Tensor,
               pad_mask: torch.Tensor, kind: str) -> torch.Tensor:
    """One head's tail over a whole trunk-encoded batch: float32 outputs
    shaped by `kind` (models/finetune module doc)."""
    with torch.inference_mode():
        return ft_model.apply_head(head, local, global_, pad_mask, kind)


@torch.inference_mode()
def packed_trunk_batch(params, tokens: torch.Tensor,
                       segment_ids: torch.Tensor, annotations: torch.Tensor,
                       cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The ragged shared trunk: one (rows, seq_len) PACKED batch →
    {"local" (B, L, C), "global" (B, S, G), "seg_mask" (B, S, L) bool}
    per segment. `seg_mask` is True only at a segment's real tokens (a
    bucket-quantized span's <pad> tail is out), so the tails pool what
    the bucketed path's pad_mask keeps. On the card the local track runs
    #3 (or #6 where the one-pass rule admits the shape), then K2."""
    local, global_ = proteinbert.encode(params, tokens, annotations, cfg,
                                        pad_mask=tokens != PAD_ID,
                                        segment_ids=segment_ids)
    return {"local": local, "global": global_,
            "seg_mask": inference._segment_real_mask(
                tokens, segment_ids, annotations.shape[1])}


def packed_head_features(local: torch.Tensor, global_: torch.Tensor,
                         seg_mask: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-SEGMENT features for a `kind` head over a packed trunk output:
    `models/finetune.head_features` per segment (the mask-weighted mean
    over the segment's real positions beside its own global vector), or
    the local track for token_classification (callers slice each span
    from the (B, L, out) result)."""
    if kind == "token_classification":
        return local
    m = seg_mask.to(local.dtype)  # (B, S, L)
    pooled = (torch.einsum("bsl,blc->bsc", m, local)
              / m.sum(-1)[..., None].clamp_min(1.0))
    return torch.cat([global_, pooled], dim=-1)


def packed_head_batch(head, local: torch.Tensor, global_: torch.Tensor,
                      seg_mask: torch.Tensor, kind: str) -> torch.Tensor:
    """One head's tail over a packed trunk batch: float32 (B, L, out) for
    token_classification, else (B, S, out) per segment."""
    with torch.inference_mode():
        return ft_model.head_apply(head, packed_head_features(
            local, global_, seg_mask, kind)).float()


def _distinct(heads: Sequence[Any]) -> Dict[str, Any]:
    """head_id → head, in first-seen order."""
    out: Dict[str, Any] = {}
    for h in heads:
        out.setdefault(h.head_id, h)
    return out


def head_outputs(trunk_out: Dict[str, torch.Tensor],
                 heads: Sequence[Any]) -> Dict[str, torch.Tensor]:
    """Each DISTINCT head once over the whole bucketed batch →
    {head_id: float32 output on the trunk's device}."""
    dev = trunk_out["local"].device
    return {hid: head_batch(head_params_on(h.params, dev),
                            trunk_out["local"], trunk_out["global"],
                            trunk_out["pad_mask"], h.task.kind)
            for hid, h in _distinct(heads).items()}


def packed_head_outputs(trunk_out: Dict[str, torch.Tensor],
                        heads: Sequence[Any]) -> Dict[str, torch.Tensor]:
    """`head_outputs` over a packed trunk batch."""
    dev = trunk_out["local"].device
    return {hid: packed_head_batch(head_params_on(h.params, dev),
                                   trunk_out["local"], trunk_out["global"],
                                   trunk_out["seg_mask"], h.task.kind)
            for hid, h in _distinct(heads).items()}


def rows_of(outs: Dict[str, np.ndarray],
            heads: Sequence[Any]) -> List[np.ndarray]:
    """Row i's own head's output, for every row."""
    return [outs[h.head_id][i] for i, h in enumerate(heads)]


def riders_of(outs: Dict[str, np.ndarray],
              riders: Sequence[Tuple[Any, int, int, int, int]]
              ) -> List[np.ndarray]:
    """Each (head, row, segment_index, start, span) rider's own slice:
    (span, out) for token_classification (the bucketed (bucket_len, out)
    output's layout), else its segment's (out,)."""
    res = []
    for head, row, seg, start, span in riders:
        out = outs[head.head_id]
        if head.task.kind == "token_classification":
            res.append(out[row, start:start + span])
        else:
            res.append(out[row, seg])
    return res


def _host(outs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in outs.items()}


def apply_heads(trunk_out: Dict[str, torch.Tensor],
                heads: Sequence[Any]) -> List[np.ndarray]:
    """Mixed-head tail: per-row heads over one shared trunk
    representation → host arrays aligned with the rows."""
    return rows_of(_host(head_outputs(trunk_out, heads)), heads)


def apply_heads_packed(trunk_out: Dict[str, torch.Tensor],
                       riders: Sequence[Tuple[Any, int, int, int, int]]
                       ) -> List[np.ndarray]:
    """Mixed-head tail for a PACKED batch: one (head, row, segment_index,
    start, span) rider a request → host arrays aligned with `riders`."""
    outs = packed_head_outputs(trunk_out, [r[0] for r in riders])
    return riders_of(_host(outs), riders)


def predict_task_rows(trunk_params, cfg: ModelConfig, head,
                      tokens: np.ndarray,
                      annotations: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """Offline single-head entry: (N, L) tokens → (N, ...) float32 head
    outputs through the same trunk and tail the server runs (eagerly,
    on the trunk params' device)."""
    dev = tree_leaves(trunk_params)[0].device
    if annotations is None:
        annotations = np.zeros((tokens.shape[0], cfg.num_annotations),
                               np.float32)
    trunk_out = trunk_batch(trunk_params,
                            torch.from_numpy(np.asarray(tokens)).to(dev),
                            torch.from_numpy(np.asarray(annotations)).to(dev),
                            cfg)
    return _host(head_outputs(trunk_out, [head]))[head.head_id]
