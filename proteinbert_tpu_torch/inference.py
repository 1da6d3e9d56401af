"""Inference on a trunk: embeddings, GO prediction, residue filling —
port of `proteinbert_tpu/inference.py` (its outputs and dtypes).

Entry points (each takes `device=None`, meaning "cuda"; the params must
already live on that device — `models.proteinbert.init`,
`weights.params_from_flat`, `weights.load_npz` and `load_trunk` put them
there):
- `load_state` / `load_trunk` — the train state / params of a pretrain
  run's newest checkpoint (`train/checkpoint.Checkpointer`);
- `embed` / `embed_batches` — (N, G) global + length-masked mean (N, C)
  local representations, float32;
- `predict_go` — sigmoid GO-annotation probabilities or top-k;
- `predict_residues` — per-position amino-acid distributions; fills
  '?'-masked positions with the argmax residue.
The `_packed_*_batch` functions are the ragged serving forms of the batch
functions: a packed (rows, seq_len) batch with segment_ids in, one output
per segment out (serve/dispatch.RaggedDispatcher).

Batches are padded to a fixed batch size, as the JAX path pads to one
compiled shape, so a row's numbers do not depend on how many rows share
its call. Annotations default to the all-zero "no annotations known"
input.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import ModelConfig, PretrainConfig
from proteinbert_tpu_torch.data.vocab import (
    EOS_ID, PAD_ID, SOS_ID, UNK_ID, get_vocab,
)
from proteinbert_tpu_torch.models import proteinbert

logger = logging.getLogger(__name__)

MASK_CHAR = "?"  # maps to <unk>: the "residue unknown, predict it" input

# Process-wide count of sequences whose tail was truncated to fit the
# model window (one-slot list, as in the JAX module).
TRUNCATED_TOTAL = [0]


class SequenceTooLongError(ValueError):
    """A sequence exceeds the model window (seq_len - 2 residues) and the
    caller asked for rejection instead of truncate-and-count."""


def load_state(checkpoint_dir: str, cfg: PretrainConfig,
               device: DeviceLike = None):
    """(TrainState, step) of the newest checkpoint of a pretrain run
    directory, on `device` (None → "cuda"). `cfg` must describe the
    pretrain run, so the restore template matches the saved tree."""
    from proteinbert_tpu_torch.train.checkpoint import Checkpointer
    from proteinbert_tpu_torch.train.train_state import create_train_state

    template = create_train_state(
        torch.Generator().manual_seed(cfg.train.seed), cfg, device)
    ck = Checkpointer(checkpoint_dir, async_save=False)
    try:
        state, _ = ck.restore(template)
    finally:
        ck.close()
    if state is None:
        raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir}")
    return state, int(state.step)


def load_trunk(checkpoint_dir: str, cfg: PretrainConfig,
               device: DeviceLike = None):
    """(params, step) of a pretrain run's newest checkpoint —
    `load_state` for callers that need only the model weights."""
    state, step = load_state(checkpoint_dir, cfg, device)
    return state.params, step


@torch.inference_mode()
def _encode_batch(params, tokens: torch.Tensor, annotations: torch.Tensor,
                  cfg: ModelConfig, per_residue: bool = False):
    local, global_ = proteinbert.encode(params, tokens, annotations, cfg)
    mask = (tokens != PAD_ID).float()[:, :, None]
    local = local.float()
    out = {
        "local_mean": (local * mask).sum(1) / mask.sum(1).clamp_min(1.0),
        "global": global_.float(),
    }
    if per_residue:
        out["local"] = local
    return out


@torch.inference_mode()
def _go_probs_batch(params, tokens, annotations, cfg: ModelConfig):
    _, global_logits = proteinbert.apply(params, tokens, annotations, cfg)
    return torch.sigmoid(global_logits)


@torch.inference_mode()
def _residue_probs_batch(params, tokens, annotations, cfg: ModelConfig):
    local_logits, _ = proteinbert.apply(params, tokens, annotations, cfg)
    return torch.softmax(local_logits, -1)


def _segment_real_mask(tokens: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """(B, S, L) bool: True where position l belongs to segment s AND
    holds a real (non-<pad>) token — a ragged serving span is bucket-
    quantized, so its <pad> tail stays out of pooling and attention as the
    bucketed path's pad_mask keeps it out."""
    ids = torch.arange(1, num_segments + 1, device=segment_ids.device)
    seg = segment_ids[:, None, :] == ids[None, :, None]
    return seg & (tokens != PAD_ID)[:, None, :]


@torch.inference_mode()
def _packed_encode_batch(params, tokens, segment_ids, annotations,
                         cfg: ModelConfig):
    """The ragged serving form of `_encode_batch`: a (rows, seq_len)
    packed batch of up to S segments per row → {"local_mean": (B, S, C),
    "global": (B, S, G)} float32 per SEGMENT (mask-weighted mean over each
    segment's real positions)."""
    local, global_ = proteinbert.encode(params, tokens, annotations, cfg,
                                        pad_mask=tokens != PAD_ID,
                                        segment_ids=segment_ids)
    m = _segment_real_mask(tokens, segment_ids,
                           annotations.shape[1]).float()
    local = local.float()
    local_mean = (torch.einsum("bsl,blc->bsc", m, local)
                  / m.sum(-1)[..., None].clamp_min(1.0))
    return {"local_mean": local_mean, "global": global_.float()}


@torch.inference_mode()
def _packed_go_probs_batch(params, tokens, segment_ids, annotations,
                           cfg: ModelConfig):
    """(B, S, A) sigmoid GO probabilities per packed segment."""
    _, global_logits = proteinbert.apply(
        params, tokens, annotations, cfg, pad_mask=tokens != PAD_ID,
        segment_ids=segment_ids)
    return torch.sigmoid(global_logits)


@torch.inference_mode()
def _packed_residue_probs_batch(params, tokens, segment_ids, annotations,
                                cfg: ModelConfig):
    """(B, L, V) per-position softmax over a packed batch; callers slice
    each segment's span back out."""
    local_logits, _ = proteinbert.apply(
        params, tokens, annotations, cfg, pad_mask=tokens != PAD_ID,
        segment_ids=segment_ids)
    return torch.softmax(local_logits, -1)


def _tokenize_masked(seqs: Sequence[str], seq_len: int,
                     on_overflow: str = "warn") -> np.ndarray:
    """Tokenize with MASK_CHAR → <unk> (no random crop). Sequences
    longer than seq_len-2 residues are rejected with
    SequenceTooLongError (`on_overflow="error"`) or truncated and counted
    in TRUNCATED_TOTAL ("warn" logs once per call, "count" does not)."""
    if on_overflow not in ("warn", "error", "count"):
        raise ValueError(f"on_overflow must be 'warn', 'error', or "
                         f"'count', got {on_overflow!r}")
    window = seq_len - 2
    too_long = [i for i, s in enumerate(seqs) if len(s) > window]
    if too_long:
        if on_overflow == "error":
            raise SequenceTooLongError(
                f"{len(too_long)} sequence(s) exceed the model window of "
                f"{window} residues (first: index {too_long[0]}, length "
                f"{len(seqs[too_long[0]])}); raise data.seq_len, split "
                "the sequence, or allow truncation")
        TRUNCATED_TOTAL[0] += len(too_long)
        if on_overflow == "warn":
            logger.warning(
                "truncating %d sequence(s) longer than the %d-residue "
                "model window to their first %d residues (counted in "
                "inference.TRUNCATED_TOTAL)", len(too_long), window,
                window)
    vocab = get_vocab()
    out = np.full((len(seqs), seq_len), PAD_ID, dtype=np.int32)
    for i, seq in enumerate(seqs):
        seq = seq[:window]
        ids = vocab.encode(seq)  # MASK_CHAR is outside the alphabet → <unk>
        out[i, 0] = SOS_ID
        out[i, 1: 1 + len(ids)] = ids
        out[i, 1 + len(ids)] = EOS_ID
    return out


def check_annotations(annotations: Optional[np.ndarray], n: int,
                      cfg: PretrainConfig) -> np.ndarray:
    """Default-and-validate a query annotation matrix to (n, A) float32
    (None → the all-zero "no annotations known" input)."""
    if annotations is None:
        annotations = np.zeros((n, cfg.model.num_annotations), np.float32)
    annotations = np.asarray(annotations, np.float32)
    if annotations.shape != (n, cfg.model.num_annotations):
        raise ValueError(
            f"annotations shape {annotations.shape} != "
            f"({n}, {cfg.model.num_annotations})"
        )
    return annotations


def fill_masked_residues(seq: str, probs: np.ndarray, window: int) -> str:
    """Fill each MASK_CHAR in seq[:window] with the argmax amino acid of
    `probs` (one (L, V) softmax row, position 0 = <sos>), never a
    special token; the tail beyond `window` passes through."""
    aa = np.asarray(probs).copy()
    aa[:, : UNK_ID + 1] = 0.0  # only amino-acid tokens are valid fills
    vocab = get_vocab()
    chars = list(seq[:window])
    for pos, ch in enumerate(chars):
        if ch == MASK_CHAR:
            chars[pos] = vocab.itos[int(aa[pos + 1].argmax())]
    return "".join(chars) + seq[window:]


def run_batch(fn, params, cfg: PretrainConfig, *arrays: np.ndarray,
              device: torch.device):
    """One call of a batch function on host arrays (tokens[,
    segment_ids], annotations) → host float32/int numpy outputs (a dict
    or an array)."""
    res = fn(params, *(torch.from_numpy(a).to(device) for a in arrays),
             cfg.model)
    if isinstance(res, dict):
        return {k: v.cpu().numpy() for k, v in res.items()}
    return res.cpu().numpy()


def _batched(params, cfg: PretrainConfig, tokens: np.ndarray,
             annotations: Optional[np.ndarray], batch_size: int, fn,
             device: torch.device) -> List:
    """Run `fn` over fixed-size batches (the tail padded to batch_size),
    returning per-batch host outputs trimmed to the true rows."""
    n = tokens.shape[0]
    if n == 0:
        raise ValueError("no sequences given")
    annotations = check_annotations(annotations, n, cfg)
    outs = []
    for start in range(0, n, batch_size):
        tb = tokens[start: start + batch_size]
        ab = annotations[start: start + batch_size]
        rows = tb.shape[0]
        if rows < batch_size:
            tb = np.pad(tb, ((0, batch_size - rows), (0, 0)))
            ab = np.pad(ab, ((0, batch_size - rows), (0, 0)))
        res = run_batch(fn, params, cfg, tb, ab, device=device)
        if isinstance(res, dict):
            outs.append({k: v[:rows] for k, v in res.items()})
        else:
            outs.append(res[:rows])
    return outs


def embed_batches(
    params, cfg: PretrainConfig, seqs: Sequence[str],
    annotations: Optional[np.ndarray] = None, batch_size: int = 32,
    per_residue: bool = False, on_overflow: str = "warn",
    device: DeviceLike = None,
):
    """Yield per-batch representation dicts: float32 "global" (b, G) and
    "local_mean" (b, C), plus "local" (b, seq_len, C) and int32 "tokens"
    with `per_residue=True`."""
    device = resolve_device(device)
    n = len(seqs)
    if n == 0:
        raise ValueError("no sequences given")
    for start in range(0, n, batch_size):
        chunk_tokens = _tokenize_masked(seqs[start: start + batch_size],
                                        cfg.data.seq_len, on_overflow)
        chunk_ann = (annotations[start: start + batch_size]
                     if annotations is not None else None)
        out = _batched(params, cfg, chunk_tokens, chunk_ann, batch_size,
                       partial(_encode_batch, per_residue=per_residue),
                       device)[0]
        if per_residue:
            out["tokens"] = chunk_tokens
        yield out


def _bucketed_rows(params, cfg: PretrainConfig, kind: str,
                   tokens: np.ndarray, annotations: Optional[np.ndarray],
                   batch_size: int, buckets, device: torch.device):
    """Route an offline job through the serving bucket dispatcher: each
    row runs at its length bucket, results come back in input order."""
    from proteinbert_tpu_torch.serve.dispatch import BucketDispatcher

    if tokens.shape[0] == 0:
        raise ValueError("no sequences given")
    dispatcher = BucketDispatcher(
        params, cfg, buckets=buckets, max_batch=batch_size,
        batch_classes=(batch_size,), device=device)
    return dispatcher.run_rows(kind, tokens, annotations, batch_size)


def embed(
    params, cfg: PretrainConfig, seqs: Sequence[str],
    annotations: Optional[np.ndarray] = None, batch_size: int = 32,
    per_residue: bool = False, bucketed: bool = False, buckets=None,
    on_overflow: str = "warn", device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """{"global": (N, G), "local_mean": (N, C)} float32 — plus "local"
    (N, seq_len, C) and "tokens" (N, seq_len) int32 with
    `per_residue=True`. `bucketed=True` runs each row at its length
    bucket (incompatible with `per_residue`)."""
    device = resolve_device(device)
    if bucketed:
        if per_residue:
            raise ValueError(
                "per_residue output is (N, seq_len, C) by contract; "
                "bucketed execution would change its shape — use "
                "bucketed=False for per-residue embeddings")
        n = len(seqs)
        if n == 0:
            raise ValueError("no sequences given")
        tokens = _tokenize_masked(seqs, cfg.data.seq_len, on_overflow)
        annotations = check_annotations(annotations, n, cfg)
        return _bucketed_rows(params, cfg, "embed", tokens, annotations,
                              batch_size, buckets, device)
    outs = list(embed_batches(params, cfg, seqs, annotations, batch_size,
                              per_residue, on_overflow, device))
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def predict_go(
    params, cfg: PretrainConfig, seqs: Sequence[str],
    batch_size: int = 32, top_k: Optional[int] = None,
    bucketed: bool = False, buckets=None, on_overflow: str = "warn",
    device: DeviceLike = None,
):
    """(N, A) sigmoid probabilities; with `top_k`, N descending
    [(annotation_index, prob), ...] lists."""
    device = resolve_device(device)
    tokens = _tokenize_masked(seqs, cfg.data.seq_len, on_overflow)
    if bucketed:
        probs = _bucketed_rows(params, cfg, "predict_go", tokens, None,
                               batch_size, buckets, device)
    else:
        probs = np.concatenate(_batched(params, cfg, tokens, None,
                                        batch_size, _go_probs_batch, device))
    if top_k is None:
        return probs
    k = min(top_k, probs.shape[1])
    idx = np.argsort(-probs, axis=1)[:, :k]
    return [
        [(int(j), float(p)) for j, p in zip(row, prob_row[row])]
        for row, prob_row in zip(idx, probs)
    ]


def predict_residues(
    params, cfg: PretrainConfig, seqs: Sequence[str], batch_size: int = 32,
    bucketed: bool = False, buckets=None, on_overflow: str = "warn",
    device: DeviceLike = None,
) -> Tuple[List[str], np.ndarray]:
    """'?' marks residues to fill. Returns (filled_seqs, probs (N,
    seq_len, V)); a '?' beyond the seq_len window raises ValueError.
    Bucketed rows come back zero-filled past their bucket."""
    device = resolve_device(device)
    window = cfg.data.seq_len - 2
    for i, seq in enumerate(seqs):
        if MASK_CHAR in seq[window:]:
            raise ValueError(
                f"sequence {i} has a {MASK_CHAR!r} beyond position "
                f"{window} — outside the model's seq_len window; raise "
                "data.seq_len or split the sequence")
    tokens = _tokenize_masked(seqs, cfg.data.seq_len, on_overflow)
    if bucketed:
        probs = _bucketed_rows(params, cfg, "predict_residues", tokens,
                               None, batch_size, buckets, device)
    else:
        probs = np.concatenate(_batched(params, cfg, tokens, None,
                                        batch_size, _residue_probs_batch,
                                        device))
    filled = [fill_masked_residues(seq, probs[i], window)
              for i, seq in enumerate(seqs)]
    return filled, probs
