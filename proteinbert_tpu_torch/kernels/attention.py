"""K2 — global attention over a one-hot segment mask: plain PyTorch
version, CUDA wrappers and its gradient.

Port of `proteinbert_tpu/kernels/attention.py` (`_attention_kernel` /
`_attention_body`; entries `fused_global_attention`, S=1, and
`fused_packed_attention`). Per row and head:
K = tanh(x·wk), V = gelu(x·wv), q = tanh(g·wq); scores = K·qᵀ/√k in
float32, masked to -1e30 where the one-hot is 0; softmax over L; out =
weightsᵀ·V; heads concatenate. With `zero_empty`, a segment with no
position gets an exact 0.

The wrappers run the hand-written Hopper kernel
(`csrc/global_attention.cu`, key_dim 64, value_dim 64 or 128) on CUDA
tensors and the plain version `attention_oh_reference` on CPU tensors. A
CUDA call the kernel does not cover raises ValueError; nothing falls
back. `fused_attention`, which both entries go through, is differentiable
(`kernels/autograd.recompute_vjp`): the forward saves only its inputs and
the backward recomputes the plain version, as the JAX `_bwd_attention`
does.

int8 weights (`kernels/quant_leaves`, the int8 serving arm): when wq is
a quant leaf both entries run K2's int8 leg (`csrc/global_attention_q8.cu`,
attention.py:262-272), which dequantizes each weight tile on the card; its
plain version is `attention_oh_reference` on the dequantized weights. The
int8 leg is inference-only, as in the JAX package (attention.py:430-431).

Rounding points are the TPU kernel's (attention.py:195-228), which the
plain version repeats: projections accumulate in float32 and are
rounded to the activation dtype before and after tanh/gelu, scores stay
float32, the softmax weights are rounded before the weighted sum. (The
JAX `attention_oh_reference` forms the scores in the activation dtype;
the two agree exactly in float32.)
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from proteinbert_tpu_torch.kernels.autograd import recompute_vjp
from proteinbert_tpu_torch.kernels.build import (
    INT, PTR, Kernel, check_cuda, stream_ptr,
)
from proteinbert_tpu_torch.kernels.quant_leaves import (
    int8_leg, is_quant_leaf, weight_leaf, weight_operands,
)
from proteinbert_tpu_torch.ops.layers import gelu

Params = Dict[str, torch.Tensor]

ATTENTION = Kernel(
    "global_attention", "global_attention.cu", "pbt_global_attention",
    [INT] + [PTR] * 7 + [INT] * 7 + [PTR])
ATTENTION_Q8 = Kernel(
    "global_attention_q8", "global_attention_q8.cu",
    "pbt_global_attention_q8", [INT] + [PTR] * 10 + [INT] * 7 + [PTR])

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 64   # key_dim
KERNEL_VALUE_DIMS = (64, 128)
KERNEL_MAX_SEGMENTS = 16
KERNEL_MAX_SCORES = 40960  # L·S float32 scores held in shared memory
MASK_VALUE = -1e30


def attention_oh_reference(
    params: Params, local: torch.Tensor, global_seg: torch.Tensor,
    seg_oh: torch.Tensor, zero_empty: bool = True,
) -> torch.Tensor:
    """Plain PyTorch attention at the kernel's rounding points. local
    (B, L, C), global_seg (B, S, G), seg_oh (B, L, S) > 0 where position
    l belongs to segment s and is real → (B, S, G) in local's dtype."""
    dtype = local.dtype

    def r(t):  # round to the activation dtype, compute on in float32
        return t.to(dtype).float()

    wq, wk, wv = (r(params[n]) for n in ("wq", "wk", "wv"))
    x = local.float()
    key_dim = wq.shape[-1]
    inv_scale = 1.0 / torch.sqrt(torch.tensor(float(key_dim)))

    q = r(torch.tanh(r(torch.einsum("bsg,hgk->bshk", r(global_seg), wq))))
    k = r(torch.tanh(r(torch.einsum("blc,hck->bhlk", x, wk))))
    v = r(gelu(r(torch.einsum("blc,hcv->bhlv", x, wv))))

    scores = torch.einsum("bhlk,bshk->bshl", k, q) * inv_scale.to(x.device)
    mask = (seg_oh > 0).transpose(1, 2)  # (B, S, L)
    scores = scores.masked_fill(~mask[:, :, None, :], MASK_VALUE)
    weights = r(torch.softmax(scores, dim=-1))

    out = torch.einsum("bshl,bhlv->bshv", weights, v)
    if zero_empty:
        out = torch.where(mask.any(dim=-1)[:, :, None, None], out,
                          torch.zeros((), device=out.device))
    b, s, h, vd = out.shape
    return out.reshape(b, s, h * vd).to(dtype)


def check_attention_shapes(params: Params, local: torch.Tensor,
                           global_seg: torch.Tensor,
                           seg_oh: torch.Tensor) -> None:
    """Raise ValueError unless K2 covers these operands: bf16/fp32,
    key_dim 64, value_dim 64 or 128 with G == H·value_dim, C % 32 == 0,
    1 <= S <= 16 and L·S scores in shared memory."""
    B, L, C = local.shape
    S, G = global_seg.shape[1], global_seg.shape[2]
    H, _, key_dim = weight_leaf(params["wq"]).shape
    value_dim = weight_leaf(params["wv"]).shape[-1]
    if local.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_attention: no kernel for {local.dtype}")
    if (key_dim != KERNEL_HEAD_DIM or value_dim not in KERNEL_VALUE_DIMS
            or G != H * value_dim or C % 32):
        raise ValueError(
            f"fused_attention: the kernel covers key_dim "
            f"{KERNEL_HEAD_DIM}, value_dim in {KERNEL_VALUE_DIMS} with "
            f"G == H·value_dim, and C % 32 == 0; got key_dim {key_dim}, "
            f"value_dim {value_dim}, G {G}, H {H}, C {C}")
    if not 1 <= S <= KERNEL_MAX_SEGMENTS or L * S > KERNEL_MAX_SCORES:
        raise ValueError(f"fused_attention: S={S}, L={L} outside the "
                         f"kernel's S <= {KERNEL_MAX_SEGMENTS}, "
                         f"L·S <= {KERNEL_MAX_SCORES}")
    if tuple(seg_oh.shape) != (B, L, S):
        raise ValueError(f"fused_attention: seg_oh {tuple(seg_oh.shape)} "
                         f"!= {(B, L, S)}")


def _attention_kernel(
    params: Params, local: torch.Tensor, global_seg: torch.Tensor,
    seg_oh: torch.Tensor, zero_empty: bool,
) -> torch.Tensor:
    """One launch of K2 on CUDA tensors — of its int8 leg when wq is a
    quant leaf; ValueError for what it does not cover."""
    check_attention_shapes(params, local, global_seg, seg_oh)
    B, L, C = local.shape
    S, G = global_seg.shape[1], global_seg.shape[2]
    H = weight_leaf(params["wq"]).shape[0]
    dtype = local.dtype
    x, g = (t.to(dtype).contiguous() for t in (local, global_seg))
    weights = [t for n in ("wq", "wk", "wv")
               for t in weight_operands("fused_attention", params[n], dtype)]
    oh = seg_oh.float().contiguous()
    out = torch.empty((B, S, G), dtype=dtype, device=x.device)
    ops = (x, oh, g, *weights, out)
    check_cuda("fused_attention", *ops)
    kernel = ATTENTION_Q8 if is_quant_leaf(params["wq"]) else ATTENTION
    with torch.cuda.device(x.device):
        kernel.launch(KERNEL_DTYPES[dtype], *(t.data_ptr() for t in ops),
                      B, L, C, G, S, H, int(zero_empty), stream_ptr(x.device))
    return out


def fused_attention(
    params: Params, local: torch.Tensor, global_seg: torch.Tensor,
    seg_oh: torch.Tensor, zero_empty: bool = True,
) -> torch.Tensor:
    """The one-hot attention of `attention_oh_reference`: CUDA → the
    kernel (or ValueError), CPU → the plain version; differentiable
    through the plain version either way. Quant leaves: K2's int8 leg,
    inference-only."""
    if is_quant_leaf(params["wq"]):
        return int8_leg("fused_attention", local, attention_oh_reference,
                        _attention_kernel, params, local, global_seg, seg_oh,
                        zero_empty)
    if local.device.type == "cpu":
        run = attention_oh_reference
    elif local.device.type == "cuda":
        run = _attention_kernel
    else:
        raise ValueError(f"fused_attention: unsupported device "
                         f"{local.device}")
    return recompute_vjp(run, attention_oh_reference, params, local,
                         global_seg, seg_oh, zero_empty)


def fused_global_attention(
    params: Params, local: torch.Tensor, global_: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DENSE attention (bucketed serving, unpacked rows) through the same
    kernel: the (B, G) global track is an S=1 segment set and the pad
    mask a one-column one-hot; an all-pad row keeps the uniform softmax
    (`zero_empty=False`). → (B, G)."""
    B, L, _ = local.shape
    if pad_mask is None:
        oh = torch.ones((B, L, 1), device=local.device)
    else:
        oh = pad_mask[..., None].float()
    out = fused_attention(params, local, global_[:, None, :], oh,
                          zero_empty=False)
    return out.reshape(B, -1)


def segment_one_hot(segment_ids: torch.Tensor, S: int,
                    real_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, L) segment ids (+ optional real-token mask) → the (B, L, S)
    float32 one-hot the kernels' plain versions consume. Ids outside
    1..S and masked-out positions get all-zero rows (the JAX
    `_segment_one_hot`)."""
    ids = torch.arange(1, S + 1, device=segment_ids.device)
    oh = (segment_ids[..., None] == ids).float()
    if real_mask is not None:
        oh = oh * real_mask[..., None].float()
    return oh


def fused_packed_attention(
    params: Params, local: torch.Tensor, global_: torch.Tensor,
    segment_ids: torch.Tensor, real_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-SEGMENT attention over packed rows: global_ (B, S, G),
    segment_ids (B, L) with 0 = pad and 1..S a segment, real_mask
    (B, L) the real-token mask (None = every in-segment position).
    Empty segments come back as exact 0. → (B, S, G)."""
    oh = segment_one_hot(segment_ids, global_.shape[1], real_mask)
    return fused_attention(params, local, global_, oh, zero_empty=True)


def attention_flops(B: int, L: int, C: int, G: int, S: int, H: int,
                    key_dim: int) -> int:
    """The TPU kernel's own count (attention.py:308): the K/V
    projections, the query projection and the score/weighted-sum
    products."""
    v_dim = G // H
    return 2 * B * H * (L * C * (key_dim + v_dim) + S * G * key_dim
                        + L * S * (key_dim + v_dim))
