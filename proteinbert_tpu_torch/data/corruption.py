"""On-device denoising corruption — port of
`proteinbert_tpu/data/corruption.py` (dense and packed rows), drawn from
a `torch.Generator` on the batch's device.

- Token randomization: each non-special position is replaced with
  probability p by a token drawn uniformly from the 22 amino-acid ids
  (4..25); <pad>/<sos>/<eos>/<unk> are never touched.
- Annotation corruption: per protein, with probability `corrupt_prob`
  the annotation vector is kept and noised (positives dropped with
  `drop_prob`, negatives switched on with `add_prob`); otherwise the
  whole vector is hidden (all zeros).
- Loss weights: per-token weight = non-pad mask of the CLEAN sequence;
  per-annotation weight = 1 iff the protein has any positive annotation.
- PACKED rows (data/packing.py: tokens (B, L), segment_ids (B, L),
  annotations (B, S, A)) need nothing new: specials are protected by id
  wherever they sit in the row, and the keep/hide draw runs over the
  leading (B, S) axes, so each packed protein keeps or hides its own
  annotations. Their weights come from the segment map
  (`packed_weights`).

The draws are not the JAX package's threefry bits: the tests hold the
port to the same rates, and feed both packages the same corrupted batch
where they compare numbers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from proteinbert_tpu_torch.data.vocab import N_SPECIAL, PAD_ID, VOCAB_SIZE

Batch = Dict[str, torch.Tensor]


def randomize_tokens(gen: torch.Generator, tokens: torch.Tensor,
                     prob: float) -> torch.Tensor:
    """(..., L) int tokens with non-special positions replaced w.p. prob
    by a random amino-acid id."""
    replace = torch.rand(tokens.shape, generator=gen,
                         device=tokens.device) < prob
    replace &= tokens >= N_SPECIAL
    random_aa = torch.randint(N_SPECIAL, VOCAB_SIZE, tokens.shape,
                              generator=gen, device=tokens.device,
                              dtype=tokens.dtype)
    return torch.where(replace, random_aa, tokens)


def _bernoulli(gen: torch.Generator, prob: float, shape,
               device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) < prob


def corrupt_annotations(
    gen: torch.Generator,
    annotations: torch.Tensor,
    corrupt_prob: float,
    drop_prob: float,
    add_prob: float,
) -> torch.Tensor:
    """Noise-or-hide the (..., A) float annotation matrix, one keep/hide
    draw per leading index (a protein, or a packed segment)."""
    dev = annotations.device
    keep = _bernoulli(gen, corrupt_prob, annotations.shape[:-1], dev)[..., None]
    zeros = torch.zeros_like(annotations)
    dropped = torch.where(_bernoulli(gen, drop_prob, annotations.shape, dev),
                          zeros, annotations)
    added = torch.where(_bernoulli(gen, add_prob, annotations.shape, dev),
                        torch.ones_like(annotations), dropped)
    return torch.where(keep, added, zeros)


def pretrain_weights(tokens: torch.Tensor,
                     annotations: torch.Tensor) -> Batch:
    """Loss weights from the CLEAN batch."""
    seq_w = (tokens != PAD_ID).float()
    has_any = (annotations.sum(dim=-1, keepdim=True) > 0).float()
    return {"local": seq_w, "global": has_any.expand_as(annotations)}


def packed_weights(tokens: torch.Tensor, segment_ids: torch.Tensor,
                   annotations: torch.Tensor) -> Batch:
    """Loss weights of a PACKED clean batch: local (B, L) 1 at real
    (segment > 0) positions; global (B, S, A) 1 iff the segment exists in
    the row and has any positive annotation."""
    del tokens  # the segment map is the authoritative pad mask
    seq_w = (segment_ids > 0).float()
    S = annotations.shape[-2]
    ids = torch.arange(1, S + 1, dtype=segment_ids.dtype,
                       device=segment_ids.device)
    seg_exists = (segment_ids[..., None] == ids).any(dim=-2)  # (B, S)
    has_any = (annotations.sum(dim=-1) > 0) & seg_exists
    return {"local": seq_w,
            "global": has_any[..., None].float().expand_as(annotations)}


def corrupt_packed_batch(
    gen: torch.Generator,
    tokens: torch.Tensor,
    segment_ids: torch.Tensor,
    annotations: torch.Tensor,
    token_randomize_prob: float = 0.05,
    annotation_corrupt_prob: float = 0.5,
    annotation_drop_prob: float = 0.25,
    annotation_add_prob: float = 1e-4,
) -> Tuple[Batch, Batch, Batch]:
    """`corrupt_batch` for PACKED rows: tokens (B, L), segment_ids
    (B, L), annotations (B, S, A) → (X, Y, W)."""
    x_local = randomize_tokens(gen, tokens, token_randomize_prob)
    x_global = corrupt_annotations(gen, annotations, annotation_corrupt_prob,
                                   annotation_drop_prob, annotation_add_prob)
    X = {"local": x_local, "global": x_global}
    Y = {"local": tokens, "global": annotations}
    return X, Y, packed_weights(tokens, segment_ids, annotations)


def corrupt_batch(
    gen: torch.Generator,
    tokens: torch.Tensor,
    annotations: torch.Tensor,
    token_randomize_prob: float = 0.05,
    annotation_corrupt_prob: float = 0.5,
    annotation_drop_prob: float = 0.25,
    annotation_add_prob: float = 1e-4,
) -> Tuple[Batch, Batch, Batch]:
    """(X, Y, W): corrupted inputs, clean targets and loss weights, each
    a {"local", "global"} dict on the batch's device."""
    x_local = randomize_tokens(gen, tokens, token_randomize_prob)
    x_global = corrupt_annotations(gen, annotations, annotation_corrupt_prob,
                                   annotation_drop_prob, annotation_add_prob)
    X = {"local": x_local, "global": x_global}
    Y = {"local": tokens, "global": annotations}
    return X, Y, pretrain_weights(tokens, annotations)
