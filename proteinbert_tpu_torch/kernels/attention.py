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
back. In bfloat16 the kernel is three passes on the card
(`csrc/attention_sm90.cuh`): a query pass, one projection GEMM for all
heads on wgmma fed by TMA that writes the scores and V, and a softmax /
weighted-sum pass; the wrapper allocates their scratches
(`attention_scratch_layout`, one buffer) and checks that x, wq, wk and
wv are 16-byte aligned (`build.check_tma`). float32 keeps the one-block-per-(head, row) plan
(`csrc/attention.cuh`). The kernel takes the mask as (B, L) int32 segment
ids (s + 1 for segment s); the entries build those, not the float32
one-hot, and `fused_attention` derives them from its one-hot
(`one_hot_ids`). Every entry
is differentiable (`kernels/autograd.recompute_vjp`): the forward saves
only its inputs and the backward recomputes `attention_oh_grad_reference`,
the port of the JAX `attention_oh_reference` at its own rounding points,
as the JAX `_bwd_attention` does.

int8 weights (`kernels/quant_leaves`, the int8 serving arm): when wq is
a quant leaf both entries run K2's int8 leg (`csrc/global_attention_q8.cu`,
attention.py:262-272), which dequantizes the weights on the card (in
bfloat16 into per-call scratches, then the floating-point leg's passes);
its plain version is `attention_oh_reference` on the dequantized weights.
The int8 leg is inference-only, as in the JAX package
(attention.py:430-431).

Rounding points are the TPU kernel's (attention.py:195-228), which the
plain version repeats: projections accumulate in float32 and are
rounded to the activation dtype before and after tanh/gelu, scores stay
float32, the softmax weights are rounded before the weighted sum. (The
JAX `attention_oh_reference` forms the scores in the activation dtype;
the two agree exactly in float32.)
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from proteinbert_tpu_torch.kernels.autograd import recompute_vjp
from proteinbert_tpu_torch.kernels.build import (
    INT, PTR, Kernel, check_cuda, check_tma, stream_ptr,
)
from proteinbert_tpu_torch.kernels.quant_leaves import (
    int8_leg, is_quant_leaf, weight_leaf, weight_operands,
)
from proteinbert_tpu_torch.ops.layers import gelu, gelu_stepwise

Params = Dict[str, torch.Tensor]

# dtype, x, ids, g, wq, wk, wv, the scratches q, scores, v, out, then B,
# L, C, G, S, H, zero_empty and the stream.
ATTENTION = Kernel(
    "global_attention", "global_attention.cu", "pbt_global_attention",
    [INT] + [PTR] * 10 + [INT] * 7 + [PTR])
# dtype, x, ids, g, (wq, sq), (wk, sk), (wv, sv), the scratches wk, wv, q,
# scores, v, out, then as ATTENTION.
ATTENTION_Q8 = Kernel(
    "global_attention_q8", "global_attention_q8.cu",
    "pbt_global_attention_q8", [INT] + [PTR] * 15 + [INT] * 7 + [PTR])

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 64   # key_dim
KERNEL_VALUE_DIMS = (64, 128)
KERNEL_MAX_SEGMENTS = 16
# float32 only: its plan holds the L·S float32 scores in shared memory;
# bf16 keeps them in a scratch, so any L.
KERNEL_MAX_SCORES = 40960
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


def attention_oh_grad_reference(
    params: Params, local: torch.Tensor, global_seg: torch.Tensor,
    seg_oh: torch.Tensor, zero_empty: bool = True,
) -> torch.Tensor:
    """Port of the JAX `attention_oh_reference` (attention.py:137-168),
    the composition `fused_attention`'s backward differentiates:
    projections, scores and the weighted sum in local's dtype; the masked
    softmax in float32, its weights rounded back to local's dtype."""
    dtype = local.dtype
    wq, wk, wv = (params[n].to(dtype) for n in ("wq", "wk", "wv"))
    key_dim = wq.shape[-1]

    q = torch.tanh(torch.einsum("bsg,hgk->bshk", global_seg.to(dtype), wq))
    k = torch.tanh(torch.einsum("blc,hck->bhlk", local, wk))
    v = gelu_stepwise(torch.einsum("blc,hcv->bhlv", local, wv))

    scores = torch.einsum("bshk,bhlk->bshl", q, k) / torch.tensor(
        math.sqrt(key_dim), dtype=dtype)
    mask = (seg_oh > 0).transpose(1, 2)  # (B, S, L)
    scores = scores.float().masked_fill(~mask[:, :, None, :], MASK_VALUE)
    weights = torch.softmax(scores, dim=-1).to(dtype)

    out = torch.einsum("bshl,bhlv->bshv", weights, v)
    if zero_empty:
        out = torch.where(mask.any(dim=-1)[:, :, None, None], out,
                          torch.zeros((), dtype=dtype, device=out.device))
    b, s, h, vd = out.shape
    return out.reshape(b, s, h * vd)


def check_attention_shapes(params: Params, local: torch.Tensor,
                           global_seg: torch.Tensor,
                           mask: torch.Tensor) -> None:
    """Raise ValueError unless K2 covers these operands: bf16/fp32,
    key_dim 64, value_dim 64 or 128 with G == H·value_dim, C % 32 == 0,
    1 <= S <= 16 and, in float32, L·S scores in shared memory. mask is
    the (B, L, S) one-hot or the (B, L) segment ids."""
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
    if not 1 <= S <= KERNEL_MAX_SEGMENTS or (
            local.dtype == torch.float32 and L * S > KERNEL_MAX_SCORES):
        raise ValueError(f"fused_attention: S={S}, L={L} outside the "
                         f"kernel's S <= {KERNEL_MAX_SEGMENTS} (float32: "
                         f"L·S <= {KERNEL_MAX_SCORES})")
    if tuple(mask.shape) not in ((B, L, S), (B, L)):
        raise ValueError(f"fused_attention: mask {tuple(mask.shape)} is "
                         f"neither {(B, L, S)} nor {(B, L)}")


def ids_one_hot(ids: torch.Tensor, S: int) -> torch.Tensor:
    """(B, L) segment ids → the (B, L, S) float32 one-hot the plain
    versions consume: 1 where ids == s + 1."""
    segs = torch.arange(1, S + 1, device=ids.device)
    return (ids[..., None] == segs).float()


def one_hot_ids(seg_oh: torch.Tensor) -> torch.Tensor:
    """(B, L, S) one-hot (> 0 where position l is in segment s) → (B, L)
    int32 segment ids, s + 1 of the position's segment (the first, where a
    row names several), 0 where it names none."""
    hit = seg_oh > 0
    first = hit.to(torch.uint8).argmax(dim=-1) + 1
    return torch.where(hit.any(dim=-1), first, 0).to(torch.int32)


@functools.lru_cache(maxsize=64)
def attention_scratch_layout(B: int, L: int, C: int, S: int, H: int,
                             value_dim: int, quant: bool) -> tuple:
    """The scratches of one bf16 call as parts of one byte buffer, in the
    C entry's order: ((shape, dtype, byte offset), ...) and the buffer's
    bytes, each part 256-byte aligned. On the int8 leg the dequantized wk
    (H, C, 64) and wv (H, C, value_dim) bf16, then q (B, S, H, 64) and
    scores (B, H, S, L) float32 and V (B, L, H·value_dim) bf16
    (csrc/attention_sm90.cuh `AttnScratch`)."""
    k = KERNEL_HEAD_DIM
    parts = ([((H, C, k), torch.bfloat16), ((H, C, value_dim), torch.bfloat16)]
             if quant else [])
    parts += [((B, S, H, k), torch.float32), ((B, H, S, L), torch.float32),
              ((B, L, H * value_dim), torch.bfloat16)]
    layout, offset = [], 0
    for shape, dtype in parts:
        layout.append((shape, dtype, offset))
        offset += -(-math.prod(shape) * dtype.itemsize // 256) * 256
    return tuple(layout), offset


def kv_dequant_reference(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Plain version of the dequantize pass of K2's and #6's int8 legs in
    bf16 (csrc/attention_sm90.cuh `dequant_kv_kernel`): int8 wk (H, C, 64)
    or wv (H, C, v) with float32 scales (H, 64) / (H, v), one per (head,
    output column) → q·scale in float32, cast to `dtype`: the operand the
    floating-point leg loads from the dequantized weights."""
    return (q.float() * scale.unsqueeze(-2)).to(dtype)


def _attention_launch(
    params: Params, local: torch.Tensor, global_seg: torch.Tensor,
    ids: torch.Tensor, zero_empty: bool,
) -> torch.Tensor:
    """One launch of K2 on CUDA tensors, the mask as (B, L) segment ids —
    of its int8 leg when wq is a quant leaf; ValueError, before any
    launch, for what it does not cover (a shape, or in bf16 an x, wq, wk
    or wv not 16-byte aligned: TMA and the vector loads need it)."""
    check_attention_shapes(params, local, global_seg, ids)
    B, L, C = local.shape
    S, G = global_seg.shape[1], global_seg.shape[2]
    H = weight_leaf(params["wq"]).shape[0]
    value_dim = weight_leaf(params["wv"]).shape[-1]
    quant = is_quant_leaf(params["wq"])
    dtype = local.dtype
    x, g = (t.to(dtype).contiguous() for t in (local, global_seg))
    ids = ids.to(torch.int32).contiguous()
    weights = [t for n in ("wq", "wk", "wv")
               for t in weight_operands("fused_attention", params[n], dtype)]
    out = torch.empty((B, S, G), dtype=dtype, device=x.device)
    if dtype == torch.bfloat16:
        # The projection pass reads x, wk and wv by TMA (on the int8 leg
        # the dequantize pass reads int8 wk and wv in 16-byte loads); the
        # query pass reads wq in 8- or 16-byte loads.
        wk, wv = (weights[2], weights[4]) if quant else weights[1:]
        check_tma("fused_attention", x, weights[0], wk, wv)
        check_cuda("fused_attention", x, ids, g, *weights, out)
        # One allocation for all scratches (each torch.empty costs the host
        # several microseconds).
        layout, nbytes = attention_scratch_layout(B, L, C, S, H, value_dim,
                                                  quant)
        buf = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        scratch_ptrs = [buf.data_ptr() + off for _, _, off in layout]
    else:
        check_cuda("fused_attention", x, ids, g, *weights, out)
        scratch_ptrs = [None] * (5 if quant else 3)
    kernel = ATTENTION_Q8 if quant else ATTENTION
    with torch.cuda.device(x.device):
        kernel.launch(KERNEL_DTYPES[dtype],
                      *(t.data_ptr() for t in (x, ids, g, *weights)),
                      *scratch_ptrs, out.data_ptr(), B, L, C, G, S, H,
                      int(zero_empty), stream_ptr(x.device))
    return out


def _ids_reference(params, local, global_seg, ids, zero_empty):
    return attention_oh_reference(params, local, global_seg,
                                  ids_one_hot(ids, global_seg.shape[1]),
                                  zero_empty)


def _ids_grad_reference(params, local, global_seg, ids, zero_empty):
    return attention_oh_grad_reference(params, local, global_seg,
                                       ids_one_hot(ids, global_seg.shape[1]),
                                       zero_empty)


def _attention_ids(
    params: Params, local: torch.Tensor, global_seg: torch.Tensor,
    ids: torch.Tensor, zero_empty: bool,
) -> torch.Tensor:
    """`fused_attention` over (B, L) segment ids, the entries' route: the
    kernel takes the ids as they are; the plain version and the backward
    build the one-hot."""
    if is_quant_leaf(params["wq"]):
        return int8_leg("fused_attention", local, _ids_reference,
                        _attention_launch, params, local, global_seg, ids,
                        zero_empty)
    if local.device.type == "cpu":
        run = _ids_reference
    elif local.device.type == "cuda":
        run = _attention_launch
    else:
        raise ValueError(f"fused_attention: unsupported device "
                         f"{local.device}")
    return recompute_vjp(run, _ids_grad_reference, params, local,
                         global_seg, ids, zero_empty)


def fused_attention(
    params: Params, local: torch.Tensor, global_seg: torch.Tensor,
    seg_oh: torch.Tensor, zero_empty: bool = True,
) -> torch.Tensor:
    """The one-hot attention of `attention_oh_reference` over a (B, L, S)
    one-hot that puts each position in at most one segment: CUDA → the
    kernel (or ValueError), CPU → the plain version; differentiable
    through `attention_oh_grad_reference` either way. Quant leaves: K2's
    int8 leg, inference-only."""
    return _attention_ids(params, local, global_seg, one_hot_ids(seg_oh),
                          zero_empty)


def _truthy(mask: torch.Tensor) -> torch.Tensor:
    return mask if mask.dtype == torch.bool else mask > 0


def fused_global_attention(
    params: Params, local: torch.Tensor, global_: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DENSE attention (bucketed serving, unpacked rows) through the same
    kernel: the (B, G) global track is an S=1 segment set and the pad
    mask its segment ids (1 at a real position); an all-pad row keeps the
    uniform softmax (`zero_empty=False`). → (B, G)."""
    B, L, _ = local.shape
    if pad_mask is None:
        ids = torch.ones((B, L), dtype=torch.int32, device=local.device)
    else:
        ids = _truthy(pad_mask).to(torch.int32)
    out = _attention_ids(params, local, global_[:, None, :], ids,
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
    ids = segment_ids
    if real_mask is not None:
        ids = torch.where(_truthy(real_mask), segment_ids, 0)
    return _attention_ids(params, local, global_, ids.to(torch.int32),
                          zero_empty=True)


def attention_flops(B: int, L: int, C: int, G: int, S: int, H: int,
                    key_dim: int) -> int:
    """The TPU kernel's own count (attention.py:308): the K/V
    projections, the query projection and the score/weighted-sum
    products."""
    v_dim = G // H
    return 2 * B * H * (L * C * (key_dim + v_dim) + S * G * key_dim
                        + L * S * (key_dim + v_dim))
