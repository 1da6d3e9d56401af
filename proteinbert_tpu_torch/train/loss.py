"""Dual masked pretraining loss — port of `proteinbert_tpu/train/loss.py`
(dense and packed rows).

Both terms come from LOGITS: token cross-entropy over the local head and
per-annotation sigmoid BCE over the global head, each a weighted mean
sum(w·loss)/max(sum(w), 1). Local weights are the clean sequence's
non-pad mask; global weights are 1 for a protein with any positive
annotation. `F.cross_entropy` / `F.binary_cross_entropy_with_logits`
stand in for optax's `softmax_cross_entropy_with_integer_labels` /
`sigmoid_binary_cross_entropy`. PACKED batches normalise per segment
(`packed_pretrain_loss`): each term averages within a segment, then over
the segments that exist, so a long and a short protein packed into one
row weigh as two unpacked rows would. The GO head's eval-only ranking
metrics come exact per batch (`global_ranking_metrics`) and pooled over
a split (`global_ranking_stats` + `ranking_metrics_from_stats`).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Batch = Dict[str, torch.Tensor]


def _weighted_mean(loss: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (loss * w).sum() / w.sum().clamp_min(1.0)


def pretrain_loss_terms(
    local_logits: torch.Tensor,
    global_logits: torch.Tensor,
    targets: Batch,
    weights: Batch,
) -> Tuple[Batch, Batch]:
    """The loss's sums: (numerators {"local", "global", "local_acc"},
    denominators {"local", "global"}) — Σ w·CE, Σ w·BCE, Σ w·correct and
    the weight masses Σ w. Every term of `pretrain_loss` is a ratio of
    these, so a data-parallel rank's share of the global loss is its own
    numerators over the denominators summed across ranks."""
    labels = targets["local"].long()
    local_ce = F.cross_entropy(local_logits.transpose(1, 2), labels,
                               reduction="none")
    global_bce = F.binary_cross_entropy_with_logits(
        global_logits, targets["global"].to(global_logits.dtype),
        reduction="none")
    wl, wg = weights["local"], weights["global"]
    correct = (local_logits.argmax(-1) == labels).float()
    return ({"local": (local_ce * wl).sum(), "global": (global_bce * wg).sum(),
             "local_acc": (correct * wl).sum()},
            {"local": wl.sum(), "global": wg.sum()})


def loss_from_terms(nums: Batch, dens: Batch
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics) from the sums of `pretrain_loss_terms` /
    `packed_loss_terms`: each term a numerator over max(its weight
    mass, 1)."""
    dl = dens["local"].clamp_min(1.0)
    local_loss = nums["local"] / dl
    global_loss = nums["global"] / dens["global"].clamp_min(1.0)
    total = local_loss + global_loss
    return total, {"loss": total, "local_loss": local_loss,
                   "global_loss": global_loss,
                   "local_acc": nums["local_acc"] / dl}


def pretrain_loss(
    local_logits: torch.Tensor,
    global_logits: torch.Tensor,
    targets: Batch,
    weights: Batch,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics). local_logits (B, L, V) and global_logits (B, A)
    float32; targets {"local": (B, L) ids, "global": (B, A) 0/1};
    weights {"local": (B, L), "global": (B, A)}."""
    return loss_from_terms(*pretrain_loss_terms(local_logits, global_logits,
                                                targets, weights))


def packed_segment_losses(
    local_logits: torch.Tensor,
    global_logits: torch.Tensor,
    targets: Batch,
    weights: Batch,
    segment_ids: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Per-SEGMENT loss terms of a packed batch, each (B, S): "local"
    (mean token CE over the segment's positions), "global" (mean
    annotation BCE over its weighted dims), "local_acc", and the masks
    "seg_valid" (the segment has positions) and "seg_weighted" (it has
    global loss weight) — what an unpacked run computes per row."""
    S = global_logits.shape[1]
    ids = torch.arange(1, S + 1, dtype=segment_ids.dtype,
                       device=segment_ids.device)
    onehot = (segment_ids[..., None] == ids).float()  # (B, L, S)
    tok_w = weights["local"]
    labels = targets["local"].long()
    ce = F.cross_entropy(local_logits.transpose(1, 2), labels,
                         reduction="none")  # (B, L)
    seg_tokens = torch.einsum("bl,bls->bs", tok_w, onehot)
    denom = seg_tokens.clamp_min(1.0)
    per_seg_local = torch.einsum("bl,bls->bs", ce * tok_w, onehot) / denom
    correct = (local_logits.argmax(-1) == labels).float()
    per_seg_acc = torch.einsum("bl,bls->bs", correct * tok_w, onehot) / denom
    bce = F.binary_cross_entropy_with_logits(
        global_logits, targets["global"].to(global_logits.dtype),
        reduction="none")  # (B, S, A)
    gw = weights["global"]
    gw_sum = gw.sum(dim=-1)
    per_seg_global = (bce * gw).sum(dim=-1) / gw_sum.clamp_min(1.0)
    return {"local": per_seg_local, "global": per_seg_global,
            "local_acc": per_seg_acc,
            "seg_valid": (seg_tokens > 0).float(),
            "seg_weighted": (gw_sum > 0).float()}


def packed_loss_terms(
    local_logits: torch.Tensor,
    global_logits: torch.Tensor,
    targets: Batch,
    weights: Batch,
    segment_ids: torch.Tensor,
) -> Tuple[Batch, Batch]:
    """`pretrain_loss_terms` of a PACKED batch: the per-segment terms
    summed over the valid segments, over the counts of valid segments
    (JAX quant.py:358-367)."""
    seg = packed_segment_losses(local_logits, global_logits, targets,
                                weights, segment_ids)
    valid, weighted = seg["seg_valid"], seg["seg_weighted"]
    return ({"local": (seg["local"] * valid).sum(),
             "global": (seg["global"] * weighted).sum(),
             "local_acc": (seg["local_acc"] * valid).sum()},
            {"local": valid.sum(), "global": weighted.sum()})


def packed_pretrain_loss(
    local_logits: torch.Tensor,
    global_logits: torch.Tensor,
    targets: Batch,
    weights: Batch,
    segment_ids: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`pretrain_loss` for PACKED batches, normalised per segment: each
    term averages within a segment, then over the valid segments (empty
    segments weigh 0). local_logits (B, L, V), global_logits (B, S, A);
    targets/weights as `packed_weights` lays them out."""
    return loss_from_terms(*packed_loss_terms(
        local_logits, global_logits, targets, weights, segment_ids))


def global_ranking_metrics(
    global_logits: torch.Tensor,
    targets: torch.Tensor,
    weights: torch.Tensor,
    k: int = 10,
) -> Dict[str, torch.Tensor]:
    """Eval-only ranking quality of the GO head: micro AUROC over the
    elements with weight > 0 (rank-based Mann-Whitney U, float32 counts)
    and precision@k over the weighted proteins."""
    valid = weights > 0
    labels = (targets > 0) & valid
    scores = torch.where(valid, global_logits,
                         torch.full_like(global_logits, -float("inf")))
    scores, pos, val = (t.reshape(-1) for t in (scores, labels, valid))
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty(n, dtype=torch.float32, device=scores.device)
    ranks[order] = torch.arange(n, dtype=torch.float32,
                                device=scores.device)
    n_pos = pos.sum().float()
    n_val = val.sum().float()
    n_neg = n_val - n_pos
    u = (torch.where(pos, ranks, torch.zeros_like(ranks)).sum()
         - n_pos * (n_pos - 1) / 2 - n_pos * (n - n_val))
    auroc = torch.where((n_pos > 0) & (n_neg > 0),
                        u / (n_pos * n_neg).clamp_min(1.0),
                        torch.full_like(u, 0.5))
    k = min(k, global_logits.shape[-1])
    top_idx = torch.topk(global_logits, k, dim=-1).indices
    hits = torch.gather(labels, -1, top_idx)
    p_at_k = _weighted_mean(hits.float().mean(-1), valid.any(-1).float())
    return {"global_auroc": auroc, "global_p_at_k": p_at_k}


# Pooled (split-level) ranking metrics: a dataset micro-AUROC is not a
# mean of per-batch AUROCs. `global_ranking_stats` is a per-batch
# sufficient statistic that merges by addition; `ranking_metrics_from_stats`
# finishes the merged statistic on the host. Same bins as the JAX package.

RANKING_BIN_LO = -30.0
RANKING_BIN_HI = 30.0
DEFAULT_RANKING_BINS = 8192


def global_ranking_stats(
    global_logits: torch.Tensor,
    targets: torch.Tensor,
    weights: torch.Tensor,
    k: int = 10,
    num_bins: int = DEFAULT_RANKING_BINS,
) -> Dict[str, torch.Tensor]:
    """{"pos_hist", "neg_hist" (num_bins,), "p_at_k_num", "p_at_k_den"}
    of one batch: the valid positive and negative elements counted in
    linear logit bins over [RANKING_BIN_LO, RANKING_BIN_HI], and
    precision@k's numerator and denominator over the weighted proteins.
    Elements sharing a bin score as ties."""
    valid = weights > 0
    labels = (targets > 0) & valid
    span = RANKING_BIN_HI - RANKING_BIN_LO
    pos_f = (global_logits.float() - RANKING_BIN_LO) * (num_bins / span)
    bins = pos_f.clamp(0, num_bins - 1).long().reshape(-1)
    posf = labels.reshape(-1).float()
    negf = (valid & ~labels).reshape(-1).float()
    zeros = torch.zeros(num_bins, dtype=torch.float32,
                        device=global_logits.device)
    k = min(k, global_logits.shape[-1])
    top_idx = torch.topk(global_logits, k, dim=-1).indices
    hits = torch.gather(labels, -1, top_idx)
    row_valid = valid.any(-1).float()
    return {"pos_hist": zeros.index_add(0, bins, posf),
            "neg_hist": zeros.index_add(0, bins, negf),
            "p_at_k_num": (hits.float().mean(-1) * row_valid).sum(),
            "p_at_k_den": row_valid.sum()}


def ranking_metrics_from_stats(stats: Dict[str, Any]) -> Dict[str, float]:
    """Merged `global_ranking_stats` → {"global_auroc", "global_p_at_k"}
    of the whole split (on the host, float64)."""
    pos = np.asarray(stats["pos_hist"], np.float64)
    neg = np.asarray(stats["neg_hist"], np.float64)
    n_pos, n_neg = pos.sum(), neg.sum()
    neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
    u = (pos * (neg_below + 0.5 * neg)).sum()
    auroc = float(u / (n_pos * n_neg)) if n_pos > 0 and n_neg > 0 else 0.5
    den = float(stats["p_at_k_den"])
    p_at_k = float(stats["p_at_k_num"]) / den if den > 0 else 0.0
    return {"global_auroc": auroc, "global_p_at_k": p_at_k}
