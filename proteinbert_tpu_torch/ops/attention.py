"""Local→global broadcast attention — port of
`proteinbert_tpu/ops/attention.py` (the dense and the packed form).

Each head has ONE query from the global vector and attends over the
local positions, padding masked out of the softmax:

  q = tanh(global · Wq)        (B,G)·(H,G,k)   -> (B,H,k)
  K = tanh(local · Wk)         (B,L,C)·(H,C,k) -> (B,H,L,k)
  V = gelu(local · Wv)         (B,L,C)·(H,C,v) -> (B,H,L,v)
  scores = q·K / sqrt(k)                       -> (B,H,L)   [pad-masked]
  out = softmax_L(scores)·V                    -> (B,H,v)   -> (B,G)

Rounding points mirror the JAX function: scores are formed and scaled
in the activation dtype, then masked with -1e30 (not -inf: an all-pad
row gets the uniform softmax, not NaN) and softmaxed in float32. The
model's path runs the kernel form instead (`kernels/attention.py`),
whose scores stay float32 throughout; the two agree exactly in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from proteinbert_tpu_torch.ops.layers import Params, gelu


def global_attention_apply(
    params: Params,
    local: torch.Tensor,
    global_: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """local (B, L, C), global_ (B, G), pad_mask (B, L) bool True at real
    positions → (B, G) in local's dtype."""
    dtype = local.dtype
    wq = params["wq"].to(dtype)
    wk = params["wk"].to(dtype)
    wv = params["wv"].to(dtype)
    key_dim = wq.shape[-1]

    q = torch.tanh(torch.einsum("bg,hgk->bhk", global_.to(dtype), wq))
    k = torch.tanh(torch.einsum("blc,hck->bhlk", local, wk))
    v = gelu(torch.einsum("blc,hcv->bhlv", local, wv))

    scores = torch.einsum("bhk,bhlk->bhl", q, k) / torch.tensor(
        math.sqrt(key_dim), dtype=dtype)
    scores = scores.float()
    if pad_mask is not None:
        scores = scores.masked_fill(~pad_mask[:, None, :], -1e30)
    weights = torch.softmax(scores, dim=-1).to(dtype)

    out = torch.einsum("bhl,bhlv->bhv", weights, v)
    b, h, vd = out.shape
    return out.reshape(b, h * vd)


def packed_global_attention_apply(
    params: Params,
    local: torch.Tensor,
    global_: torch.Tensor,
    segment_ids: torch.Tensor,
    real_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-SEGMENT attention over packed rows, in the JAX function's
    rounding: local (B, L, C), global_ (B, S, G), segment_ids (B, L) with
    0 = pad and 1..S a segment, real_mask (B, L) True at real tokens
    (None = every in-segment position). Each segment attends only over its
    own positions (scores elsewhere -1e30, whose exp is an exact 0); a
    segment with no position gets an exact 0 → (B, S, G)."""
    dtype = local.dtype
    wq = params["wq"].to(dtype)
    wk = params["wk"].to(dtype)
    wv = params["wv"].to(dtype)
    key_dim = wq.shape[-1]
    S = global_.shape[1]

    q = torch.tanh(torch.einsum("bsg,hgk->bshk", global_.to(dtype), wq))
    k = torch.tanh(torch.einsum("blc,hck->bhlk", local, wk))
    v = gelu(torch.einsum("blc,hcv->bhlv", local, wv))

    scores = torch.einsum("bshk,bhlk->bshl", q, k) / torch.tensor(
        math.sqrt(key_dim), dtype=dtype)
    scores = scores.float()
    ids = torch.arange(1, S + 1, device=segment_ids.device)
    seg_mask = segment_ids[:, None, :] == ids[None, :, None]  # (B, S, L)
    if real_mask is not None:
        seg_mask = seg_mask & real_mask[:, None, :]
    scores = scores.masked_fill(~seg_mask[:, :, None, :], -1e30)
    weights = torch.softmax(scores, dim=-1).to(dtype)

    out = torch.einsum("bshl,bhlv->bshv", weights, v)
    out = torch.where(seg_mask.any(dim=-1)[:, :, None, None], out,
                      torch.zeros((), dtype=dtype, device=out.device))
    b, s, h, vd = out.shape
    return out.reshape(b, s, h * vd)
