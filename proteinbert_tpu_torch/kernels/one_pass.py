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
the backward recomputes the plain version, as the JAX `_bwd_onepass`
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

from typing import Dict, Optional, Tuple

import torch

from proteinbert_tpu_torch.kernels import budget
from proteinbert_tpu_torch.kernels.attention import (
    KERNEL_HEAD_DIM, KERNEL_MAX_SCORES, KERNEL_MAX_SEGMENTS,
    KERNEL_VALUE_DIMS, attention_oh_reference, fused_global_attention,
    fused_packed_attention, segment_one_hot,
)
from proteinbert_tpu_torch.kernels.autograd import recompute_vjp
from proteinbert_tpu_torch.kernels.build import (
    INT, PTR, Kernel, check_cuda, stream_ptr,
)
from proteinbert_tpu_torch.kernels.fused_block import (
    _device_check, _track_operands, check_track_shapes, fused_local_track,
    fused_local_track_segments, local_track_reference,
    local_track_segment_oh_reference,
)
from proteinbert_tpu_torch.kernels.quant_leaves import (
    int8_leg, is_quant_leaf, weight_leaf, weight_operands,
)

Params = Dict[str, torch.Tensor]

ONEPASS = Kernel(
    "one_pass", "one_pass.cu", "pbt_onepass",
    [INT, INT] + [PTR] * 20 + [INT] * 8 + [PTR])
ONEPASS_Q8 = Kernel(
    "one_pass_q8", "one_pass_q8.cu", "pbt_onepass_q8",
    [INT, INT] + [PTR] * 26 + [INT] * 8 + [PTR])

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


def _onepass_reference(
    track_params: Params, attn_params: Params, x: torch.Tensor,
    broadcast_seg: torch.Tensor, global_seg: torch.Tensor,
    segment_ids: Optional[torch.Tensor], real: torch.Tensor,
    narrow_dilation: int, wide_dilation: int, zero_empty: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """#6's plain version on `fused_onepass`'s arguments (the one-hots
    built here)."""
    B, L, _ = x.shape
    seg_oh = (torch.ones((B, L, 1), device=x.device) if segment_ids is None
              else segment_one_hot(segment_ids, global_seg.shape[1]))
    return onepass_oh_reference(
        track_params, attn_params, x, broadcast_seg, global_seg, seg_oh,
        real[..., None].float(), narrow_dilation, wide_dilation,
        segment_ids is not None, zero_empty)


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
    """One launch of #6 on CUDA tensors — of its int8 leg when the
    weights are quant leaves; ValueError for what it does not cover."""
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
    check_cuda("fused_onepass", *ops)
    kernel = ONEPASS_Q8 if quant else ONEPASS
    with torch.cuda.device(x.device):
        kernel.launch(code, int(segment_ids is not None),
                      *(t.data_ptr() for t in ops),
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
    ValueError), CPU → the plain version; differentiable through the
    plain version either way. Quant leaves: #6's int8 leg,
    inference-only."""
    if is_quant_leaf(track_params["narrow_conv"]["kernel"]):
        return int8_leg("fused_onepass", x, _onepass_reference,
                        _onepass_kernel, track_params, attn_params, x,
                        broadcast_seg, global_seg, segment_ids, real,
                        narrow_dilation, wide_dilation, zero_empty)
    run = (_onepass_reference if _device_check("fused_onepass", x)
           else _onepass_kernel)
    return recompute_vjp(run, _onepass_reference, track_params, attn_params,
                         x, broadcast_seg, global_seg, segment_ids, real,
                         narrow_dilation, wide_dilation, zero_empty)


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
