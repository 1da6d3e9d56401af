"""Downstream-task eval of registered heads — port of
`proteinbert_tpu/heads/eval.py` on the port's `heads/apply`; the rank
numerics (`_ranks`, `spearman`, `auc_proxy`) are copied as they are.

Every eval emits a `head_eval` event on the telemetry stream. Metrics by
task kind (the ProteinBERT paper's benchmark shapes):

  token_classification     per-residue accuracy over labeled positions
                           + a multilabel AUC proxy (mean one-vs-rest
                           rank-AUC over classes);
  sequence_classification  accuracy + the same AUC proxy;
  sequence_regression      Spearman rank correlation + MSE.

The AUC proxy is the exact Mann-Whitney rank statistic per class (ties
mid-ranked), averaged over the classes that have both positives and
negatives. Every metric dict carries a normalized `score` (accuracy for
classification, Spearman for regression). The forward passes run through
`heads/apply.predict_task_rows`, the trunk and tail the server runs.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from proteinbert_tpu_torch.configs import ModelConfig
from proteinbert_tpu_torch.data.vocab import PAD_ID
from proteinbert_tpu_torch.heads import apply as heads_apply
from proteinbert_tpu_torch.obs import as_telemetry


def _ranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based, ties mid-ranked) — the shared primitive
    under both Spearman and the rank-AUC."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.arange(1, len(x) + 1, dtype=np.float64)
    # Average the ranks inside each tie group.
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    return ranks


def spearman(pred: np.ndarray, target: np.ndarray) -> float:
    """Spearman rank correlation (Pearson over average ranks); 0.0 for
    degenerate (constant) inputs rather than NaN."""
    pred = np.asarray(pred, np.float64).ravel()
    target = np.asarray(target, np.float64).ravel()
    if len(pred) < 2:
        return 0.0
    rp, rt = _ranks(pred), _ranks(target)
    sp, st = rp.std(), rt.std()
    if sp == 0.0 or st == 0.0:
        return 0.0
    return float(((rp - rp.mean()) * (rt - rt.mean())).mean() / (sp * st))


def auc_proxy(scores: np.ndarray, labels: np.ndarray) -> Optional[float]:
    """Mean one-vs-rest rank-AUC over classes: scores (N, C) per-class
    logits/probs, labels (N,) int class ids. Classes without both a
    positive and a negative example are skipped; None when no class is
    scorable (a single-class split)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    aucs: List[float] = []
    for c in range(scores.shape[1]):
        pos = labels == c
        n_pos = int(pos.sum())
        n_neg = len(labels) - n_pos
        if n_pos == 0 or n_neg == 0:
            continue
        r = _ranks(scores[:, c])
        # Mann-Whitney U from the positive ranks.
        u = r[pos].sum() - n_pos * (n_pos + 1) / 2.0
        aucs.append(float(u / (n_pos * n_neg)))
    return float(np.mean(aucs)) if aucs else None


def evaluate_head(
    trunk_params,
    model_cfg: ModelConfig,
    head,
    batches: Iterable[Dict[str, np.ndarray]],
) -> Dict[str, Any]:
    """Score one head over labeled batches ({"tokens", "labels"} — the
    data/finetune_data.py / data/synthetic.make_task_batches format) on
    the trunk params' device. Returns {"kind", "rows", metrics...,
    "score"}; predictions run through the serving split-apply path."""
    kind = head.task.kind
    preds: List[np.ndarray] = []
    tokens_all: List[np.ndarray] = []
    labels_all: List[np.ndarray] = []
    for batch in batches:
        out = heads_apply.predict_task_rows(
            trunk_params, model_cfg, head, batch["tokens"],
            batch.get("annotations"))
        preds.append(out)
        tokens_all.append(np.asarray(batch["tokens"]))
        labels_all.append(np.asarray(batch["labels"]))
    if not preds:
        raise ValueError("no eval batches given")
    out = np.concatenate(preds)
    tokens = np.concatenate(tokens_all)
    labels = np.concatenate(labels_all)

    metrics: Dict[str, Any] = {"kind": kind, "rows": int(len(tokens))}
    if kind == "token_classification":
        mask = (tokens != PAD_ID) & (labels >= 0)
        flat_out = out[mask]                       # (M, C)
        flat_lab = labels[mask]
        acc = float((flat_out.argmax(-1) == flat_lab).mean()) \
            if flat_lab.size else 0.0
        metrics["per_residue_accuracy"] = round(acc, 6)
        auc = auc_proxy(flat_out, flat_lab)
        if auc is not None:
            metrics["auc_proxy"] = round(auc, 6)
        metrics["score"] = metrics["per_residue_accuracy"]
    elif kind == "sequence_classification":
        acc = float((out.argmax(-1) == labels).mean())
        metrics["accuracy"] = round(acc, 6)
        auc = auc_proxy(out, labels)
        if auc is not None:
            metrics["auc_proxy"] = round(auc, 6)
        metrics["score"] = metrics["accuracy"]
    elif kind == "sequence_regression":
        pred = out[..., 0]
        target = labels.astype(np.float64)
        metrics["spearman"] = round(spearman(pred, target), 6)
        metrics["mse"] = round(float(((pred - target) ** 2).mean()), 6)
        metrics["score"] = metrics["spearman"]
    else:
        raise ValueError(f"unknown task kind {kind!r}")
    return metrics


def evaluate_heads(
    trunk_params,
    model_cfg: ModelConfig,
    heads: Iterable[Any],
    batches_for,                  # callable(LoadedHead) -> iterable of batches
    telemetry=None,
) -> Dict[str, Dict[str, Any]]:
    """Evaluate many heads against one resident trunk; emits one
    `head_eval` event per head on the telemetry stream (NULL-safe).
    Returns {head_id: metrics}."""
    tele = as_telemetry(telemetry)
    results: Dict[str, Dict[str, Any]] = {}
    for head in heads:
        m = evaluate_head(trunk_params, model_cfg, head,
                          batches_for(head))
        results[head.head_id] = m
        tele.emit("head_eval", head_id=head.head_id, metrics=m,
                  kind=head.task.kind, name=head.name)
    return results
