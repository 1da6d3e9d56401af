"""#6 — the one-pass trunk: plain PyTorch version, CUDA wrapper, its
gradient and the dispatch of both entries.

Port of `proteinbert_tpu/kernels/one_pass.py` (`_onepass_kernel`; entries
`fused_onepass_segments`, packed rows, and `fused_onepass_dense`, S = 1).
One block layer's local track AND global attention: the local track
(segment-masked over packed rows, plain over dense rows), then the
attention over the rounded local output with the OLD global track, masked
by the segment one-hot narrowed to real tokens. `real` narrows only the
attention: in-span <pad> positions still take part in the convs. Packed
rows zero an empty segment exactly; an all-pad dense row keeps the
uniform softmax.

In bfloat16 the kernel is passes on the card, launched by one ctypes call
(`csrc/one_pass_sm90.cuh`): a query pass that also writes the softmax's
mask ids (`onepass_attention_ids` is their plain version), K1's / #3's
conv and finish passes, K2's projection pass over the rounded local output
(scores and V) and K2's softmax pass (`onepass_passes_reference` chains
the passes' plain versions). They meet in scratches carved from
one buffer (`onepass_scratch_layout`); the wrapper checks that TMA and
the 16-byte loads can read x and every weight (`build.check_tma`) before
any launch. float32 keeps the one-launch 8-CTA cluster plan
(`csrc/one_pass.cuh`).

Dispatch mirrors one_pass.py:448-596:
- on CUDA, the one-pass kernel (`csrc/one_pass.cu`) where the reference's
  rule (`budget.onepass_supported`) admits the shape — a shape the rule
  admits and the kernel does not cover raises ValueError — else the
  composition of hand-written kernels: K1 (dense) or #3 (packed), then K2;
- on the CPU, the plain version `onepass_oh_reference`, which IS that
  composition of the plain versions.
`fused_onepass` is the kernel's own wrapper: the kernel on CUDA, the
plain version on the CPU, whatever the rule says. It is differentiable
(`kernels/autograd.recompute_vjp`): the forward saves only its inputs and
the backward recomputes `onepass_oh_grad_reference`, the port of the JAX
`onepass_oh_reference` in the activation dtype, as the JAX `_bwd_onepass`
does.

int8 weights (`kernels/quant_leaves`, the int8 serving arm): where the
rule admits the shape, both entries run #6's int8 leg
(`csrc/one_pass_q8.cu`, one_pass.py:236-241, :499-504, :564-568),
inference-only; its plain version is `onepass_oh_reference` on the
dequantized weights. The composition passes the quant leaves on: the
dense one's `fused_local_track` dequantizes before K1 (one_pass.py:580),
the packed one's `fused_local_track_segments` runs #3's int8 leg
(:512-514), and both attentions run K2's (:515-517, :594-595).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from proteinbert_tpu_torch.kernels import budget
from proteinbert_tpu_torch.kernels.attention import (
    KERNEL_HEAD_DIM, KERNEL_MAX_SCORES, KERNEL_MAX_SEGMENTS,
    KERNEL_VALUE_DIMS, MASK_VALUE, attention_oh_grad_reference,
    attention_oh_reference, fused_global_attention, fused_packed_attention,
    segment_one_hot,
)
from proteinbert_tpu_torch.kernels.autograd import recompute_vjp
from proteinbert_tpu_torch.kernels.build import (
    INT, PTR, Kernel, check_cuda, check_tma, stream_ptr,
)
from proteinbert_tpu_torch.kernels.fused_block import (
    KERNEL_TAPS, _device_check, _track_operands, check_track_shapes,
    fused_local_track, fused_local_track_segments,
    local_track_grad_reference, local_track_reference,
    local_track_segment_oh_grad_reference, local_track_segment_oh_reference,
)
from proteinbert_tpu_torch.kernels.quant_leaves import (
    int8_leg, is_quant_leaf, weight_leaf, weight_operands,
)
from proteinbert_tpu_torch.ops.layers import gelu

Params = Dict[str, torch.Tensor]

# dtype, seg_masked, x, seg, real, bcast, g, the track's weights (nk, nb,
# wk, wb, s1, b1, dk, db, s2, b2), wq, wk, wv, local, attn, the scratch
# buffer, then B, L, C, G, S, H, wide_dilation, zero_empty and the stream.
ONEPASS = Kernel(
    "one_pass", "one_pass.cu", "pbt_onepass",
    [INT, INT] + [PTR] * 21 + [INT] * 8 + [PTR])
# The same with the int8 weights and their scales in place of the track's
# and the attention's weights.
ONEPASS_Q8 = Kernel(
    "one_pass_q8", "one_pass_q8.cu", "pbt_onepass_q8",
    [INT, INT] + [PTR] * 27 + [INT] * 8 + [PTR])

# What the CUDA kernel covers (beyond the local track's convs and K2's
# head dims): the widths of each activation dtype. The one-pass rule never
# admits float32 at C=512 (19·C² float32 weights alone are 19.9 MB against
# its 13 MiB), so the kernel has no such instantiation.
KERNEL_WIDTHS = {torch.bfloat16: (128, 256, 512), torch.float32: (128, 256)}


def onepass_oh_reference(
    track_params: Params, attn_params: Params, x: torch.Tensor,
    broadcast_seg: torch.Tensor, global_seg: torch.Tensor,
    seg_oh: torch.Tensor, real: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
    seg_masked: bool = True, zero_empty: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch one-pass layer in the one-hot form: seg_oh (B, L, S),
    real (B, L, 1), broadcast_seg (B, S, C), global_seg (B, S, G) →
    (local (B, L, C), attn (B, S, G)). The conv masks ignore `real`."""
    if seg_masked:
        local = local_track_segment_oh_reference(
            track_params, x, broadcast_seg, seg_oh, narrow_dilation,
            wide_dilation)
    else:
        local = local_track_reference(track_params, x, broadcast_seg[:, 0],
                                      narrow_dilation, wide_dilation)
    attn = attention_oh_reference(attn_params, local, global_seg,
                                  seg_oh.float() * real.float(), zero_empty)
    return local, attn


def onepass_oh_grad_reference(
    track_params: Params, attn_params: Params, x: torch.Tensor,
    broadcast_seg: torch.Tensor, global_seg: torch.Tensor,
    seg_oh: torch.Tensor, real: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
    seg_masked: bool = True, zero_empty: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Port of the JAX `onepass_oh_reference` (one_pass.py:197), the
    composition `fused_onepass`'s backward differentiates: the JAX
    references of the track and the attention, composed, in x's dtype."""
    if seg_masked:
        local = local_track_segment_oh_grad_reference(
            track_params, x, broadcast_seg, seg_oh, narrow_dilation,
            wide_dilation)
    else:
        local = local_track_grad_reference(
            track_params, x, broadcast_seg[:, 0], narrow_dilation,
            wide_dilation)
    attn = attention_oh_grad_reference(
        attn_params, local, global_seg, seg_oh.float() * real.float(),
        zero_empty)
    return local, attn


def onepass_attention_ids(segment_ids: Optional[torch.Tensor],
                          real: torch.Tensor, S: int) -> torch.Tensor:
    """Plain version of the mask ids #6's query pass writes: (B, L) int32,
    the segment id where `real` is nonzero and the id is in 1..S, else 0;
    dense rows (segment_ids None) take `real` itself (1 where real). As a
    one-hot (`ids_one_hot`) it is the JAX kernel's `seg_oh * real`."""
    real = real != 0
    if segment_ids is None:
        return real.to(torch.int32)
    inside = (segment_ids >= 1) & (segment_ids <= S)
    return torch.where(real & inside, segment_ids, 0).to(torch.int32)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float()


def onepass_query_reference(attn_params: Params, global_seg: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the query pass: q = round(tanh(round(g @ wq))),
    (B, S, H, 64) float32, from the OLD global rows (B, S, G)."""
    wq = _round(attn_params["wq"], dtype)
    return _round(torch.tanh(_round(torch.einsum(
        "bsg,hgk->bshk", _round(global_seg, dtype), wq), dtype)), dtype)


def onepass_projection_reference(attn_params: Params, local: torch.Tensor,
                                 q: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the projection pass over the rounded local rows
    (B, L, C): scores (B, H, S, L) float32 = round(tanh(round(local @
    wk))) · q / √64, unmasked, and V (B, L, H·v) = round(gelu(round(local
    @ wv))) in local's dtype."""
    dtype = local.dtype
    wk, wv = (_round(attn_params[n], dtype) for n in ("wk", "wv"))
    x = local.float()
    k = _round(torch.tanh(_round(torch.einsum("blc,hck->bhlk", x, wk),
                                 dtype)), dtype)
    v = _round(gelu(_round(torch.einsum("blc,hcv->blhv", x, wv), dtype)),
               dtype)
    scores = torch.einsum("bhlk,bshk->bhsl", k, q) / math.sqrt(q.shape[-1])
    B, L, H, vd = v.shape
    return scores, v.reshape(B, L, H * vd).to(dtype)


def onepass_softmax_reference(scores: torch.Tensor, v: torch.Tensor,
                              ids: torch.Tensor,
                              zero_empty: bool) -> torch.Tensor:
    """Plain version of the softmax pass: per (row, head, segment s) the
    softmax over l of the scores where ids == s + 1 (-1e30 elsewhere), its
    weights rounded to V's dtype, their sum of V rows in float32; an
    empty segment exactly 0 where zero_empty. → (B, S, H·v) in V's
    dtype."""
    B, H, S, L = scores.shape
    dtype = v.dtype
    mask = ids[:, None, None, :] == torch.arange(
        1, S + 1, device=ids.device)[None, None, :, None]
    weights = _round(torch.softmax(scores.masked_fill(~mask, MASK_VALUE),
                                   dim=-1), dtype)
    out = torch.einsum("bhsl,blhv->bshv", weights,
                       v.float().reshape(B, L, H, -1))
    if zero_empty:
        out = torch.where(mask.any(dim=-1).transpose(1, 2)[..., None], out,
                          torch.zeros((), device=out.device))
    return out.reshape(B, S, -1).to(dtype)


def onepass_passes_reference(
    track_params: Params, attn_params: Params, x: torch.Tensor,
    broadcast_seg: torch.Tensor, global_seg: torch.Tensor,
    segment_ids: Optional[torch.Tensor], real: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
    zero_empty: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """#6 as its bf16 passes compute it, each pass by its plain version:
    the query pass (q and the mask ids), the conv and finish passes (the
    local track's plain version), the projection, the softmax. Arguments
    as `fused_onepass`; → (local (B, L, C), attn (B, S, G))."""
    S = global_seg.shape[1]
    q = onepass_query_reference(attn_params, global_seg, x.dtype)
    ids = onepass_attention_ids(segment_ids, real, S)
    if segment_ids is None:
        local = local_track_reference(track_params, x, broadcast_seg[:, 0],
                                      narrow_dilation, wide_dilation)
    else:
        local = local_track_segment_oh_reference(
            track_params, x, broadcast_seg, segment_one_hot(segment_ids, S),
            narrow_dilation, wide_dilation)
    scores, v = onepass_projection_reference(attn_params, local, q)
    return local, onepass_softmax_reference(scores, v, ids, zero_empty)


@functools.lru_cache(maxsize=64)
def onepass_scratch_layout(B: int, L: int, C: int, S: int, H: int,
                           value_dim: int, quant: bool,
                           dtype: torch.dtype) -> tuple:
    """The scratches of one #6 call as parts of one byte buffer, in the
    order the C entry carves them (csrc/one_pass_sm90.cuh
    `onepass_scratch`): ((shape, dtype, byte offset), ...) and the
    buffer's bytes, each part 256-byte aligned. bf16 only (float32 runs
    one launch and takes none): on the int8 leg the dequantized nk, wk (9,
    C, C), dk (C, C), attention wk (H, C, 64) and wv (H, C, value_dim)
    bf16; then h (B, L, C) float32 (where the conv and finish passes
    meet), q (B, S, H, 64) float32, the mask ids (B, L) int32, scores (B,
    H, S, L) float32 and V (B, L, H·value_dim) bf16."""
    if dtype != torch.bfloat16:
        return (), 0
    k, bf16 = KERNEL_HEAD_DIM, torch.bfloat16
    parts = ([((KERNEL_TAPS, C, C), bf16)] * 2
             + [((C, C), bf16), ((H, C, k), bf16), ((H, C, value_dim), bf16)]
             if quant else [])
    parts += [((B, L, C), torch.float32), ((B, S, H, k), torch.float32),
              ((B, L), torch.int32), ((B, H, S, L), torch.float32),
              ((B, L, H * value_dim), bf16)]
    layout, offset = [], 0
    for shape, part_dtype in parts:
        layout.append((shape, part_dtype, offset))
        offset += -(-math.prod(shape) * part_dtype.itemsize // 256) * 256
    return tuple(layout), offset


def _rule_admits(track_params: Params, attn_params: Params, x: torch.Tensor,
                 S: int, G: int, narrow_dilation: int,
                 wide_dilation: int) -> bool:
    _, L, C = x.shape
    H, _, key_dim = weight_leaf(attn_params["wq"]).shape
    return budget.onepass_supported(
        C, G, L, S, key_dim, H, x.dtype,
        weight_leaf(track_params["narrow_conv"]["kernel"]).shape[0],
        weight_leaf(track_params["wide_conv"]["kernel"]).shape[0],
        wide_dilation, narrow_dilation)


def _on_ids(oh_fn):
    """`oh_fn` (the one-hot form) on `fused_onepass`'s arguments, the
    one-hots built from the ids."""
    def fn(track_params: Params, attn_params: Params, x: torch.Tensor,
           broadcast_seg: torch.Tensor, global_seg: torch.Tensor,
           segment_ids: Optional[torch.Tensor], real: torch.Tensor,
           narrow_dilation: int, wide_dilation: int, zero_empty: bool,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, L, _ = x.shape
        seg_oh = (torch.ones((B, L, 1), device=x.device)
                  if segment_ids is None
                  else segment_one_hot(segment_ids, global_seg.shape[1]))
        return oh_fn(
            track_params, attn_params, x, broadcast_seg, global_seg, seg_oh,
            real[..., None].float(), narrow_dilation, wide_dilation,
            segment_ids is not None, zero_empty)
    return fn


# #6's plain version and its backward reference on integer ids.
_onepass_reference = _on_ids(onepass_oh_reference)
_onepass_grad_reference = _on_ids(onepass_oh_grad_reference)


def check_onepass_shapes(
    track_params: Params, attn_params: Params, x: torch.Tensor,
    broadcast_seg: torch.Tensor, global_seg: torch.Tensor,
    segment_ids: Optional[torch.Tensor], real: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> None:
    """Raise ValueError unless #6 covers these operands: bf16/fp32 with C
    in `KERNEL_WIDTHS[dtype]`, k=9 convs (narrow dilation 1, wide ≤ 5),
    key_dim 64, value_dim 64 or 128 with G == H·value_dim, 1 <= S <= 16
    and L·S scores in shared memory."""
    B, L, C = x.shape
    S, G = global_seg.shape[1], global_seg.shape[2]
    H, _, key_dim = weight_leaf(attn_params["wq"]).shape
    value_dim = weight_leaf(attn_params["wv"]).shape[-1]
    check_track_shapes("fused_onepass", track_params, x, narrow_dilation,
                       wide_dilation, KERNEL_WIDTHS.get(x.dtype, ()))
    if (key_dim != KERNEL_HEAD_DIM or value_dim not in KERNEL_VALUE_DIMS
            or G != H * value_dim):
        raise ValueError(
            f"fused_onepass: the kernel covers key_dim {KERNEL_HEAD_DIM}, "
            f"value_dim in {KERNEL_VALUE_DIMS} with G == H·value_dim; got "
            f"key_dim {key_dim}, value_dim {value_dim}, G {G}, H {H}")
    if not 1 <= S <= KERNEL_MAX_SEGMENTS or L * S > KERNEL_MAX_SCORES:
        raise ValueError(f"fused_onepass: S={S}, L={L} outside the kernel's "
                         f"S <= {KERNEL_MAX_SEGMENTS}, "
                         f"L·S <= {KERNEL_MAX_SCORES}")
    if (tuple(broadcast_seg.shape) != (B, S, C)
            or tuple(real.shape) != (B, L)
            or (segment_ids is None and S != 1)
            or (segment_ids is not None
                and tuple(segment_ids.shape) != (B, L))):
        raise ValueError("fused_onepass: operand shapes do not match "
                         f"x {tuple(x.shape)} and global {(B, S, G)}")


def _onepass_kernel(
    track_params: Params, attn_params: Params, x: torch.Tensor,
    broadcast_seg: torch.Tensor, global_seg: torch.Tensor,
    segment_ids: Optional[torch.Tensor], real: torch.Tensor,
    narrow_dilation: int, wide_dilation: int, zero_empty: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of #6 on CUDA tensors — of its int8 leg when the weights
    are quant leaves; ValueError, before any launch, for what it does not
    cover (a shape, or in bf16 an x or weight that TMA or the 16-byte
    loads cannot read). One ctypes call launches every pass."""
    check_onepass_shapes(track_params, attn_params, x, broadcast_seg,
                         global_seg, segment_ids, real, narrow_dilation,
                         wide_dilation)
    B, L, C = x.shape
    S, G = global_seg.shape[1], global_seg.shape[2]
    H = weight_leaf(attn_params["wq"]).shape[0]
    quant = is_quant_leaf(track_params["narrow_conv"]["kernel"])
    if quant != is_quant_leaf(attn_params["wq"]):
        raise ValueError("fused_onepass: the track and attention weights "
                         "must both be int8 or both floating point")
    code, weights = _track_operands("fused_onepass", track_params, x,
                                    narrow_dilation, wide_dilation,
                                    KERNEL_WIDTHS[x.dtype])
    dtype = x.dtype
    x, bc, g = (t.to(dtype).contiguous()
                for t in (x, broadcast_seg, global_seg))
    attn_w = [t for n in ("wq", "wk", "wv")
              for t in weight_operands("fused_onepass", attn_params[n],
                                       dtype)]
    real = real.to(torch.int32).contiguous()
    # Dense rows pass `real` in the unused id slot: the kernel reads no ids.
    seg = (real if segment_ids is None
           else segment_ids.to(torch.int32).contiguous())
    local = torch.empty_like(x)
    attn = torch.empty((B, S, G), dtype=dtype, device=x.device)
    ops = (x, seg, real, bc, g, *weights, *attn_w, local, attn)
    if dtype == torch.bfloat16:
        # TMA reads x, the conv, dense, wk and wv weights; the query pass
        # and (int8 leg) the dequantize passes read wq, the int8 weights
        # and their scales in 16-byte loads.
        mats = ((0, 1, 3, 4, 8, 9) if quant else (0, 2, 6))
        check_tma("fused_onepass", x, *(weights[i] for i in mats), *attn_w)
    check_cuda("fused_onepass", *ops)
    layout, nbytes = onepass_scratch_layout(
        B, L, C, S, H, weight_leaf(attn_params["wv"]).shape[-1], quant,
        dtype)
    # One allocation for every scratch (each torch.empty costs the host
    # microseconds), held until the passes are enqueued; the caching
    # allocator orders its reuse on the stream.
    buf = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
           if nbytes else None)
    kernel = ONEPASS_Q8 if quant else ONEPASS
    with torch.cuda.device(x.device):
        kernel.launch(code, int(segment_ids is not None),
                      *(t.data_ptr() for t in ops),
                      None if buf is None else buf.data_ptr(),
                      B, L, C, G, S, H, wide_dilation, int(zero_empty),
                      stream_ptr(x.device))
    return local, attn


def fused_onepass(
    track_params: Params, attn_params: Params, x: torch.Tensor,
    broadcast_seg: torch.Tensor, global_seg: torch.Tensor,
    segment_ids: Optional[torch.Tensor], real: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
    zero_empty: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-pass layer of `onepass_oh_reference` with integer segment
    ids: segment_ids (B, L) for packed rows (0 = pad, ids above S count as
    pad) or None for dense rows (S = 1, unmasked convs); real (B, L)
    nonzero where the attention may look. CUDA → the kernel (or
    ValueError), CPU → the plain version; differentiable through
    `onepass_oh_grad_reference` either way. Quant leaves: #6's int8 leg,
    inference-only."""
    if is_quant_leaf(track_params["narrow_conv"]["kernel"]):
        return int8_leg("fused_onepass", x, _onepass_reference,
                        _onepass_kernel, track_params, attn_params, x,
                        broadcast_seg, global_seg, segment_ids, real,
                        narrow_dilation, wide_dilation, zero_empty)
    run = (_onepass_reference if _device_check("fused_onepass", x)
           else _onepass_kernel)
    return recompute_vjp(run, _onepass_grad_reference, track_params,
                         attn_params, x, broadcast_seg, global_seg,
                         segment_ids, real, narrow_dilation, wide_dilation,
                         zero_empty)


def fused_onepass_segments(
    track_params: Params, attn_params: Params, x: torch.Tensor,
    broadcast_seg: torch.Tensor, global_seg: torch.Tensor,
    segment_ids: torch.Tensor, real_mask: Optional[torch.Tensor] = None,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PACKED block layer: broadcast_seg (B, S, C) per-segment
    projected global vectors, global_seg (B, S, G), segment_ids (B, L)
    with 0 = pad, real_mask (B, L) the ragged-serving real-token mask
    (None = every in-segment position) → (local (B, L, C),
    attn (B, S, G))."""
    S, G = global_seg.shape[1], global_seg.shape[2]
    if x.device.type == "cuda" and not _rule_admits(
            track_params, attn_params, x, S, G, narrow_dilation,
            wide_dilation):
        local = fused_local_track_segments(track_params, x, broadcast_seg,
                                           segment_ids, narrow_dilation,
                                           wide_dilation)
        return local, fused_packed_attention(attn_params, local, global_seg,
                                             segment_ids, real_mask)
    real = (torch.ones_like(segment_ids, dtype=torch.bool)
            if real_mask is None else real_mask)
    return fused_onepass(track_params, attn_params, x, broadcast_seg,
                         global_seg, segment_ids, real, narrow_dilation,
                         wide_dilation, True)


def fused_onepass_dense(
    track_params: Params, attn_params: Params, x: torch.Tensor,
    broadcast: torch.Tensor, global_: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DENSE block layer: broadcast (B, C), global_ (B, G), pad_mask
    (B, L) True at real positions (the attention mask only) →
    (local (B, L, C), attn (B, G))."""
    B, L, _ = x.shape
    G = global_.shape[-1]
    if pad_mask is None:
        pad_mask = torch.ones((B, L), dtype=torch.bool, device=x.device)
    if x.device.type == "cuda" and not _rule_admits(
            track_params, attn_params, x, 1, G, narrow_dilation,
            wide_dilation):
        local = fused_local_track(track_params, x, broadcast,
                                  narrow_dilation, wide_dilation)
        return local, fused_global_attention(attn_params, local, global_,
                                             pad_mask)
    local, attn = fused_onepass(track_params, attn_params, x,
                                broadcast[:, None, :], global_[:, None, :],
                                None, pad_mask, narrow_dilation,
                                wide_dilation, False)
    return local, attn.reshape(B, G)


def onepass_flops(B: int, L: int, C: int, G: int, S: int, H: int,
                  key_dim: int, taps: int = 9) -> int:
    """The TPU kernel's own count (one_pass.py:362-366): the track's
    2·B·L·C²·(2·taps + 1) plus the attention's projections and
    score/weighted-sum products."""
    v_dim = G // H
    return (2 * B * L * C * C * (2 * taps + 1)
            + 2 * B * H * (L * C * (key_dim + v_dim) + S * G * key_dim
                           + L * S * (key_dim + v_dim)))
