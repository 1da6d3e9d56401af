"""K1, #2, #3 and #4 — the fused local track over dense and packed rows:
plain PyTorch versions, CUDA wrappers and their gradients.

Port of `proteinbert_tpu/kernels/fused_block.py`: `_fused_kernel` (K1) and
`_fused_kernel_tiled` (#2), the two bodies of the entry
`fused_local_track`, and `_fused_segment_kernel` (#3) and
`_fused_segment_kernel_tiled` (#4), the two bodies of the entry
`fused_local_track_segments`. The local half of a ProteinBERT block:

    h  = x + gelu(narrow_conv(x)) + gelu(wide_conv(x)) + broadcast
    x1 = LN(h)
    y  = LN(x1 + gelu(dense(x1)))

Over PACKED rows (data/packing.py) the convs never cross a segment
boundary (tap t of row l is masked unless seg[l + off] == seg[l] and l is
in a segment) and each position adds its OWN segment's broadcast row, 0
at pad.

`fused_local_track` keeps one entry, as the JAX `_pallas_forward` does:
on a CUDA tensor it launches K1 (`csrc/local_track.cu`) for C in
{128, 256, 512} and #2 (`csrc/local_track_tiled.cu`) for 512 < C <= 2048
with C a multiple of 128, in bfloat16 and float32 (the JAX package has no
float32 tiled plan and answers through XLA there; the port has no such
route, so #2 covers float32 too). `fused_local_track_segments` routes
the same way: #3 (`csrc/local_track_segments.cu`) for C in {128, 256,
512} and #4 (`csrc/local_track_segments_tiled.cu`) for the tiled widths,
in bfloat16 and float32 (again no float32 tiled plan in the JAX package;
#4 covers float32 too). On a CPU tensor both entries run the plain
versions. A CUDA call the kernels do not cover (dtype, width, conv
geometry) raises ValueError; nothing falls back.

Both entries are differentiable (`kernels/autograd.recompute_vjp`): the
forward saves only its inputs and the backward recomputes the plain
version, as the JAX `_bwd` / `_bwd_segments` do.

int8 weights (`kernels/quant_leaves`, the int8 serving arm): for C <=
512 `fused_local_track_segments` runs #3's int8 leg
(`csrc/local_track_segments_q8.cu`, fused_block.py:414-420), which
dequantizes each weight tile on its way into shared memory; at the tiled
widths it dequantizes first and runs #4 (:421-423), and
`fused_local_track` always dequantizes first (K1 and #2 have no int8 leg;
the JAX dispatch dequantizes before them, one_pass.py:580). The int8 leg
is inference-only, as in the JAX package.

Rounding points are the TPU kernels', which the plain versions repeat:
the tap products, both conv outputs and the broadcast gather stay
float32 (fused_block.py:539-547, :1012-1016), x1 is rounded to the
activation dtype before the dense (:517), LN statistics are float32. In
float32 this is exactly the JAX `local_track_reference` /
`local_track_segment_oh_reference`; in bfloat16 the JAX references round
the conv outputs where the kernels do not. #2 computes the function K1
computes, so its plain version is K1's `local_track_reference`, and #4's
is #3's; only their float32 sums are taken in the TPU tiled kernels'
order (the two GELU terms first, then x and the broadcast,
fused_block.py:604-618 and :662-681) rather than K1's (x first), a
difference at the last float32 bit.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from proteinbert_tpu_torch.kernels.attention import segment_one_hot
from proteinbert_tpu_torch.kernels.autograd import recompute_vjp
from proteinbert_tpu_torch.kernels.build import (
    INT, PTR, Kernel, check_cuda, stream_ptr,
)
from proteinbert_tpu_torch.kernels.quant_leaves import (  # noqa: F401
    dequant_leaf, dequant_params, int8_leg, is_quant_leaf, weight_leaf,
    weight_operands,
)
from proteinbert_tpu_torch.ops.layers import (
    conv1d_apply, gelu, layer_norm_f32,
)

Params = Dict[str, Dict[str, torch.Tensor]]

TRACK_PARAMS = ("narrow_conv", "wide_conv", "local_ln1", "local_dense",
                "local_ln2")

LOCAL_TRACK = Kernel(
    "local_track", "local_track.cu", "pbt_local_track",
    [INT] + [PTR] * 13 + [INT] * 4 + [PTR])
LOCAL_TRACK_SEGMENTS = Kernel(
    "local_track_segments", "local_track_segments.cu",
    "pbt_local_track_segments", [INT] + [PTR] * 14 + [INT] * 5 + [PTR])
LOCAL_TRACK_TILED = Kernel(
    "local_track_tiled", "local_track_tiled.cu", "pbt_local_track_tiled",
    [INT] + [PTR] * 14 + [INT] * 4 + [PTR])
LOCAL_TRACK_SEGMENTS_TILED = Kernel(
    "local_track_segments_tiled", "local_track_segments_tiled.cu",
    "pbt_local_track_segments_tiled", [INT] + [PTR] * 15 + [INT] * 5 + [PTR])
LOCAL_TRACK_SEGMENTS_Q8 = Kernel(
    "local_track_segments_q8", "local_track_segments_q8.cu",
    "pbt_local_track_segments_q8", [INT] + [PTR] * 17 + [INT] * 5 + [PTR])

# What the CUDA kernels cover.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_WIDTHS = (128, 256, 512)           # K1, #3
TILED_WIDTHS = tuple(range(640, 2049, 128))  # #2, #4
KERNEL_TAPS = 9
MAX_WIDE_DILATION = 5  # the window's 20-row halo


def _finish(params: Params, h: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """The LN → dense(+GELU, residual) → LN tail on the float32 residual
    h, x1 rounded to `dtype` before the dense (fused_block.py:514-523)."""
    ln1, ln2, dn = (params["local_ln1"], params["local_ln2"],
                    params["local_dense"])
    x1 = layer_norm_f32(h, ln1["scale"].float(), ln1["bias"].float()
                        ).to(dtype).float()
    d = x1 @ dn["kernel"].to(dtype).float() + dn["bias"].float()
    return layer_norm_f32(x1 + gelu(d), ln2["scale"].float(),
                          ln2["bias"].float()).to(dtype)


def local_track_reference(
    params: Params, x: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Plain PyTorch local track at the kernel's rounding points: every
    product and sum in float32 on the activation-dtype operands, x1 and
    the output rounded to x's dtype."""
    dtype = x.dtype

    def conv(p, dilation):
        p32 = {"kernel": p["kernel"].to(dtype).float(),
               "bias": p["bias"].float()}
        return conv1d_apply(p32, x.float(), dilation)

    h = (x.float() + gelu(conv(params["narrow_conv"], narrow_dilation))
         + gelu(conv(params["wide_conv"], wide_dilation))
         + broadcast.to(dtype).float()[:, None, :])
    return _finish(params, h, dtype)


def _masked_conv(p, x: torch.Tensor, dilation: int,
                 tap_mask: Callable[[int], torch.Tensor]
                 ) -> torch.Tensor:
    """'SAME' dilated conv as shifted float32 tap products whose operand
    rows are multiplied by tap_mask(offset) (B, L, 1) — 0/1, so a masked
    contribution is an exact zero (the JAX `_segment_conv`)."""
    dtype = x.dtype
    kernel = p["kernel"].to(dtype).float()
    taps, L = kernel.shape[0], x.shape[1]
    total = (taps - 1) * dilation
    lo = total // 2
    xp = F.pad(x.float(), (0, 0, lo, total - lo))
    acc = None
    for t in range(taps):
        off = t * dilation
        part = (xp[:, off:off + L] * tap_mask(off)) @ kernel[t]
        acc = part if acc is None else acc + part
    return acc + p["bias"].float()


def local_track_segment_oh_reference(
    params: Params, x: torch.Tensor, broadcast_seg: torch.Tensor,
    seg_oh: torch.Tensor, narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Plain PyTorch segment-masked local track in the one-hot form the
    kernel's TPU original consumes: seg_oh (B, L, S) one-hot (all-zero at
    pad), broadcast_seg (B, S, C) per-segment broadcast rows. Tap masks
    are Σ_s oh[l]·oh[l+off]; the own-segment gather is oh @ broadcast_seg
    (exact 0 at pad)."""
    dtype = x.dtype
    oh = seg_oh.float()
    L = x.shape[1]

    def conv(p, dilation):
        total = (p["kernel"].shape[0] - 1) * dilation
        ohp = F.pad(oh, (0, 0, total // 2, total - total // 2))
        return _masked_conv(
            p, x, dilation,
            lambda off: (oh * ohp[:, off:off + L]).sum(-1, keepdim=True))

    bcast = torch.einsum("bls,bsc->blc", oh, broadcast_seg.to(dtype).float())
    h = (x.float() + gelu(conv(params["narrow_conv"], narrow_dilation))
         + gelu(conv(params["wide_conv"], wide_dilation)) + bcast)
    return _finish(params, h, dtype)


def local_track_segment_reference(
    params: Params, x: torch.Tensor, broadcast_pos: torch.Tensor,
    segment_ids: torch.Tensor, narrow_dilation: int = 1,
    wide_dilation: int = 5,
) -> torch.Tensor:
    """The same track in the integer-id form of the JAX
    `local_track_segment_reference`: tap t of row l counts when
    seg[l + off] == seg[l] > 0; broadcast_pos (B, L, C) is already
    per position (`gather_segment_broadcast`). Kernel rounding points."""
    dtype = x.dtype
    L = x.shape[1]

    def conv(p, dilation):
        total = (p["kernel"].shape[0] - 1) * dilation
        sp = F.pad(segment_ids, (total // 2, total - total // 2))
        return _masked_conv(
            p, x, dilation,
            lambda off: ((sp[:, off:off + L] == segment_ids)
                         & (segment_ids > 0)).float()[..., None])

    h = (x.float() + gelu(conv(params["narrow_conv"], narrow_dilation))
         + gelu(conv(params["wide_conv"], wide_dilation))
         + broadcast_pos.to(dtype).float())
    return _finish(params, h, dtype)


def gather_segment_broadcast(broadcast_seg: torch.Tensor,
                             segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, S, C) per-segment broadcast + (B, L) segment ids → (B, L, C)
    per-position broadcast, exact 0 at pad."""
    idx = (segment_ids.long() - 1).clamp_min(0)
    pos = torch.gather(broadcast_seg, 1,
                       idx[..., None].expand(-1, -1, broadcast_seg.shape[-1]))
    return torch.where((segment_ids > 0)[..., None], pos,
                       torch.zeros((), dtype=pos.dtype, device=pos.device))


def check_track_shapes(name: str, params: Params, x: torch.Tensor,
                       narrow_dilation: int, wide_dilation: int,
                       widths=KERNEL_WIDTHS) -> None:
    """Raise ValueError unless the local-track kernels cover these
    operands: bf16/fp32, C in `widths`, k=9 convs with narrow dilation 1
    and wide dilation <= 5."""
    C = x.shape[-1]
    nk = weight_leaf(params["narrow_conv"]["kernel"])
    wk = weight_leaf(params["wide_conv"]["kernel"])
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: no kernel for {x.dtype}")
    if C not in widths:
        raise ValueError(f"{name}: no kernel for C={C} in {x.dtype} "
                         f"(have {widths})")
    conv_shape = (KERNEL_TAPS, C, C)
    if (tuple(nk.shape) != conv_shape or tuple(wk.shape) != conv_shape
            or narrow_dilation != 1
            or not 1 <= wide_dilation <= MAX_WIDE_DILATION):
        raise ValueError(
            f"{name}: the kernel covers k=9 convs with narrow "
            f"dilation 1 and wide dilation <= {MAX_WIDE_DILATION}; got "
            f"{tuple(nk.shape)}/{tuple(wk.shape)}, dilations "
            f"{narrow_dilation}/{wide_dilation}")


def _track_operands(name: str, params: Params, x: torch.Tensor,
                    narrow_dilation: int, wide_dilation: int,
                    widths=KERNEL_WIDTHS):
    """Check what the local-track kernels cover (C in `widths`) and cast
    the weights to their launch types: (dtype code, conv/dense operands in
    x's dtype — or int8 values and float32 scales, for quant leaves —
    float32 bias and LN vectors), in the order the C entries take them."""
    check_track_shapes(name, params, x, narrow_dilation, wide_dilation,
                       widths)
    dtype = x.dtype
    ln1, ln2, dn = (params["local_ln1"], params["local_ln2"],
                    params["local_dense"])
    nk, wk, dk = (weight_operands(name, t, dtype)
                  for t in (params["narrow_conv"]["kernel"],
                            params["wide_conv"]["kernel"], dn["kernel"]))
    nb, wb, s1, b1, db, s2, b2 = (
        t.float().contiguous() for t in (
            params["narrow_conv"]["bias"], params["wide_conv"]["bias"],
            ln1["scale"], ln1["bias"], dn["bias"], ln2["scale"],
            ln2["bias"]))
    return KERNEL_DTYPES[dtype], (*nk, nb, *wk, wb, s1, b1, *dk, db, s2, b2)


def _device_check(name: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version); raise for a device
    the port does not run on; False for CUDA (launch)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def _local_track_kernel(
    params: Params, x: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int, wide_dilation: int,
) -> torch.Tensor:
    """One launch of K1 (C <= 512) or #2 (512 < C <= 2048) on CUDA
    tensors; ValueError for what neither covers."""
    B, L, C = x.shape
    code, weights = _track_operands(
        "fused_local_track", params, x, narrow_dilation, wide_dilation,
        KERNEL_WIDTHS + TILED_WIDTHS)
    if tuple(broadcast.shape) != (B, C):
        raise ValueError(f"fused_local_track: broadcast "
                         f"{tuple(broadcast.shape)} != {(B, C)}")
    x, bc = (t.to(x.dtype).contiguous() for t in (x, broadcast))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if C in KERNEL_WIDTHS:
            ops = (x, bc, *weights, out)
            check_cuda("fused_local_track", *ops)
            LOCAL_TRACK.launch(code, *(t.data_ptr() for t in ops),
                               B, L, C, wide_dilation, stream_ptr(x.device))
        else:
            # #2's two passes meet in a float32 (B, L, C) scratch.
            h = torch.empty((B, L, C), dtype=torch.float32, device=x.device)
            ops = (x, bc, *weights, h, out)
            check_cuda("fused_local_track", *ops)
            LOCAL_TRACK_TILED.launch(code, *(t.data_ptr() for t in ops),
                                     B, L, C, wide_dilation,
                                     stream_ptr(x.device))
    return out


def fused_local_track(
    params: Params, x: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Local track of one block. x (B, L, C) activations; broadcast (B, C)
    the projected global→local vector (gelu(dense(global))); params the
    block's narrow_conv, wide_conv, local_ln1, local_dense, local_ln2.
    CUDA → K1 or #2 by width (or ValueError), CPU → the plain version;
    differentiable through the plain version either way. Quant leaves are
    dequantized first: K1 and #2 have no int8 leg."""
    params = dequant_params(params)
    run = (local_track_reference if _device_check("fused_local_track", x)
           else _local_track_kernel)
    return recompute_vjp(run, local_track_reference, params, x, broadcast,
                         narrow_dilation, wide_dilation)


def _segments_reference(
    params: Params, x: torch.Tensor, broadcast_seg: torch.Tensor,
    segment_ids: torch.Tensor, narrow_dilation: int, wide_dilation: int,
) -> torch.Tensor:
    """#3's plain version on integer ids (the one-hot built here)."""
    return local_track_segment_oh_reference(
        params, x, broadcast_seg,
        segment_one_hot(segment_ids, broadcast_seg.shape[1]),
        narrow_dilation, wide_dilation)


def _segments_kernel(
    params: Params, x: torch.Tensor, broadcast_seg: torch.Tensor,
    segment_ids: torch.Tensor, narrow_dilation: int, wide_dilation: int,
) -> torch.Tensor:
    """One launch of #3 (C <= 512) or #4 (512 < C <= 2048) on CUDA
    tensors — of #3's int8 leg for quant leaves (C <= 512 only);
    ValueError for what none covers."""
    B, L, C = x.shape
    S = broadcast_seg.shape[1]
    quant = is_quant_leaf(params["narrow_conv"]["kernel"])
    widths = KERNEL_WIDTHS if quant else KERNEL_WIDTHS + TILED_WIDTHS
    code, weights = _track_operands(
        "fused_local_track_segments", params, x, narrow_dilation,
        wide_dilation, widths)
    if tuple(broadcast_seg.shape) != (B, S, C) or S < 1:
        raise ValueError(f"fused_local_track_segments: broadcast_seg "
                         f"{tuple(broadcast_seg.shape)} is not (B, S, C) "
                         f"with B={B}, C={C}")
    if tuple(segment_ids.shape) != (B, L):
        raise ValueError(f"fused_local_track_segments: segment_ids "
                         f"{tuple(segment_ids.shape)} != {(B, L)}")
    x, bc = (t.to(x.dtype).contiguous() for t in (x, broadcast_seg))
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if C in KERNEL_WIDTHS:
            ops = (x, seg, bc, *weights, out)
            kernel = (LOCAL_TRACK_SEGMENTS_Q8 if quant
                      else LOCAL_TRACK_SEGMENTS)
        else:
            # #4's two passes meet in a float32 (B, L, C) scratch.
            h = torch.empty((B, L, C), dtype=torch.float32, device=x.device)
            ops = (x, seg, bc, *weights, h, out)
            kernel = LOCAL_TRACK_SEGMENTS_TILED
        check_cuda("fused_local_track_segments", *ops)
        kernel.launch(code, *(t.data_ptr() for t in ops), B, L, C, S,
                      wide_dilation, stream_ptr(x.device))
    return out


def fused_local_track_segments(
    params: Params, x: torch.Tensor, broadcast_seg: torch.Tensor,
    segment_ids: torch.Tensor, narrow_dilation: int = 1,
    wide_dilation: int = 5,
) -> torch.Tensor:
    """Local track of one block over PACKED rows: broadcast_seg (B, S, C)
    the per-segment projected global vectors, segment_ids (B, L) with 0 =
    pad and 1..S a packed protein (ids above S count as pad). CUDA → #3
    or #4 by width (or ValueError), CPU → the plain version;
    differentiable through the plain version either way. Quant leaves:
    #3's int8 leg for C <= 512 (inference-only), else dequantized first
    and #4."""
    if is_quant_leaf(params["narrow_conv"]["kernel"]):
        if x.shape[-1] <= KERNEL_WIDTHS[-1]:
            return int8_leg("fused_local_track_segments", x,
                            _segments_reference, _segments_kernel, params,
                            x, broadcast_seg, segment_ids, narrow_dilation,
                            wide_dilation)
        params = dequant_params(params)
    run = (_segments_reference
           if _device_check("fused_local_track_segments", x)
           else _segments_kernel)
    return recompute_vjp(run, _segments_reference, params, x, broadcast_seg,
                         segment_ids, narrow_dilation, wide_dilation)


def local_track_flops(B: int, L: int, C: int, taps: int = KERNEL_TAPS) -> int:
    """The TPU kernel's own count (fused_block.py:779): two k-tap convs
    and the dense, 2·B·L·C²·(2·taps + 1)."""
    return 2 * B * L * C * C * (2 * taps + 1)
