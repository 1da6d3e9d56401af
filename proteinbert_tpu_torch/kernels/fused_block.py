"""K1, #2, #3 and #4 — the fused local track over dense, prehaloed and
packed rows: plain PyTorch versions, CUDA wrappers and their gradients.

Port of `proteinbert_tpu/kernels/fused_block.py`: `_fused_kernel` (K1) and
`_fused_kernel_tiled` (#2), the two bodies of the entries
`fused_local_track` and `fused_local_track_valid` (the prehaloed entry of
sequence parallelism), and `_fused_segment_kernel` (#3) and
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

In bfloat16 every entry (K1, its prehaloed entry, #3 and its int8 leg, #2,
#4) runs the two passes of `csrc/local_track_sm90.cuh` — a conv pass on
wgmma fed by TMA and a finish pass — which meet in a float32 (B, L, C)
scratch the wrapper allocates (`track_scratch_layout`, one buffer; on #3's
int8 leg the buffer also holds the per-call bf16 weights its dequantize
pass writes). TMA refuses an operand whose base is not 16-byte aligned, so
the wrappers raise ValueError for such an x or conv / dense kernel before
any launch (`check_tma`). float32 K1 and #3 keep their one-launch
CUDA-core kernel and need no scratch.

`fused_local_track_valid` takes a PREHALOED shard, xh (B, L + 2·halo, C)
whose first and last `track_halo` rows are a neighbour shard's real rows
(`parallel/halo.halo_exchange`), and returns the (B, L, C) centre. On a
CUDA tensor it launches K1's prehaloed entry (`csrc/local_track_valid.cu`)
for C in {128, 256, 512} and #2's (`csrc/local_track_tiled_valid.cu`) for
the tiled widths: the same device code, whose window reads the halo rows
instead of zeros. Its gate is `check_track_shapes` alone; the JAX
`pallas_supported` gate is a TPU VMEM budget that the port's row-streaming
kernels do not have.

All three entries are differentiable (`kernels/autograd.recompute_vjp`):
the forward saves only its inputs and the backward recomputes the port of
the JAX XLA reference (`local_track_grad_reference`,
`local_track_segment_oh_grad_reference`,
`local_track_valid_grad_reference`) in the activation dtype, as the JAX
`_bwd` / `_bwd_segments` / `_bwd_valid` do.

int8 weights (`kernels/quant_leaves`, the int8 serving arm): for C <=
512 `fused_local_track_segments` runs #3's int8 leg
(`csrc/local_track_segments_q8.cu`, fused_block.py:414-420), which in
bfloat16 dequantizes the weights once a call into scratches
(`track_dequant_reference` is that pass's plain version) and in float32
each weight tile on its way into shared memory; at the tiled
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
the conv outputs where the kernels do not. The `*_grad_reference`
functions are those JAX references themselves, ported at their own
rounding points, for the backward. #2 computes the function K1
computes, so its plain version is K1's `local_track_reference`, and #4's
is #3's; only their float32 sums are taken in the TPU tiled kernels'
order (the two GELU terms first, then x and the broadcast,
fused_block.py:604-618 and :662-681) rather than K1's (x first), a
difference at the last float32 bit.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from proteinbert_tpu_torch.kernels.attention import segment_one_hot
from proteinbert_tpu_torch.kernels.autograd import recompute_vjp
from proteinbert_tpu_torch.kernels.build import (
    INT, PTR, Kernel, check_cuda, check_tma, stream_ptr,
)
from proteinbert_tpu_torch.kernels.quant_leaves import (  # noqa: F401
    dequant_leaf, dequant_params, int8_leg, is_quant_leaf, weight_leaf,
    weight_operands,
)
from proteinbert_tpu_torch.ops.layers import (
    conv1d_apply, dense_apply, gelu, gelu_stepwise, layer_norm_apply,
    layer_norm_f32,
)

Params = Dict[str, Dict[str, torch.Tensor]]

TRACK_PARAMS = ("narrow_conv", "wide_conv", "local_ln1", "local_dense",
                "local_ln2")

# Every entry's C signature: dtype, x, [seg], bcast, the weights (int8 leg:
# each conv / dense kernel followed by its scales), biases and LN vectors,
# the scratches (`track_scratch_layout`'s parts), out, then B, L, C, [S],
# wide dilation and the stream.
LOCAL_TRACK = Kernel(
    "local_track", "local_track.cu", "pbt_local_track",
    [INT] + [PTR] * 14 + [INT] * 4 + [PTR])
LOCAL_TRACK_SEGMENTS = Kernel(
    "local_track_segments", "local_track_segments.cu",
    "pbt_local_track_segments", [INT] + [PTR] * 15 + [INT] * 5 + [PTR])
LOCAL_TRACK_TILED = Kernel(
    "local_track_tiled", "local_track_tiled.cu", "pbt_local_track_tiled",
    [INT] + [PTR] * 14 + [INT] * 4 + [PTR])
LOCAL_TRACK_SEGMENTS_TILED = Kernel(
    "local_track_segments_tiled", "local_track_segments_tiled.cu",
    "pbt_local_track_segments_tiled", [INT] + [PTR] * 15 + [INT] * 5 + [PTR])
LOCAL_TRACK_SEGMENTS_Q8 = Kernel(
    "local_track_segments_q8", "local_track_segments_q8.cu",
    "pbt_local_track_segments_q8", [INT] + [PTR] * 21 + [INT] * 5 + [PTR])
LOCAL_TRACK_VALID = Kernel(
    "local_track_valid", "local_track_valid.cu", "pbt_local_track_valid",
    [INT] + [PTR] * 14 + [INT] * 4 + [PTR])
LOCAL_TRACK_TILED_VALID = Kernel(
    "local_track_tiled_valid", "local_track_tiled_valid.cu",
    "pbt_local_track_tiled_valid", [INT] + [PTR] * 14 + [INT] * 4 + [PTR])

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


def _finish_grad_reference(params: Params, s: torch.Tensor) -> torch.Tensor:
    """The JAX references' LN → dense(+GELU, residual) → LN tail on the
    pre-LN sum s, in s's dtype with float32 LN statistics."""
    h = layer_norm_apply(params["local_ln1"], s)
    return layer_norm_apply(
        params["local_ln2"],
        h + gelu_stepwise(dense_apply(params["local_dense"], h)))


def local_track_grad_reference(
    params: Params, x: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Port of the JAX `local_track_reference` (fused_block.py:213-230),
    the composition `fused_local_track`'s backward differentiates: convs,
    dense and sums in x's dtype, float32 LN statistics only."""
    narrow = gelu_stepwise(conv1d_apply(params["narrow_conv"], x,
                                        narrow_dilation))
    wide = gelu_stepwise(conv1d_apply(params["wide_conv"], x,
                                      wide_dilation))
    return _finish_grad_reference(
        params, x + narrow + wide + broadcast[:, None, :])


def track_halo(params: Params, narrow_dilation: int = 1,
               wide_dilation: int = 5) -> int:
    """Context rows each side a shard needs for exact conv results (20 for
    the k=9/d=5 geometry) — the JAX `track_halo`."""
    nt = weight_leaf(params["narrow_conv"]["kernel"]).shape[0]
    wt = weight_leaf(params["wide_conv"]["kernel"]).shape[0]
    return max((nt - 1) // 2 * narrow_dilation,
               (wt - 1) // 2 * wide_dilation)


def _valid_conv(p, xh: torch.Tensor, dilation: int, halo: int,
                L: int) -> torch.Tensor:
    """The 'SAME' conv's L centre rows of a prehaloed xh (B, L + 2·halo,
    C), as a VALID conv (`lax.conv_general_dilated` padding="VALID") in
    xh's dtype: VALID output row m starts at input row m, and centre row
    l of the 'SAME' conv at window start l + halo - (k-1)/2·d."""
    k = p["kernel"].shape[0]
    w = p["kernel"].to(xh.dtype).permute(2, 1, 0)  # (Cout, Cin, K)
    y = F.conv1d(xh.transpose(1, 2), w, dilation=dilation).transpose(1, 2)
    off = halo - (k - 1) // 2 * dilation
    return y[:, off:off + L] + p["bias"].to(xh.dtype)


def local_track_valid_reference(
    params: Params, xh: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Plain PyTorch local track of a PREHALOED shard at the kernel's
    rounding points: xh (B, L + 2·halo, C) carries `track_halo` real
    neighbour rows each side; → the (B, L, C) centre. Equals rows
    [halo, halo + L) of `local_track_reference` on the stitched row."""
    dtype = xh.dtype
    H = track_halo(params, narrow_dilation, wide_dilation)
    L = xh.shape[1] - 2 * H

    def conv(p, dilation):
        p32 = {"kernel": p["kernel"].to(dtype).float(),
               "bias": p["bias"].float()}
        return _valid_conv(p32, xh.float(), dilation, H, L)

    h = (xh[:, H:H + L].float()
         + gelu(conv(params["narrow_conv"], narrow_dilation))
         + gelu(conv(params["wide_conv"], wide_dilation))
         + broadcast.to(dtype).float()[:, None, :])
    return _finish(params, h, dtype)


def local_track_valid_grad_reference(
    params: Params, xh: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Port of the JAX `local_track_valid_reference` (fused_block.py:
    445-485), the composition `fused_local_track_valid`'s backward
    differentiates: VALID convs, dense and sums in xh's dtype, float32 LN
    statistics only."""
    H = track_halo(params, narrow_dilation, wide_dilation)
    L = xh.shape[1] - 2 * H
    narrow = gelu_stepwise(_valid_conv(params["narrow_conv"], xh,
                                       narrow_dilation, H, L))
    wide = gelu_stepwise(_valid_conv(params["wide_conv"], xh, wide_dilation,
                                     H, L))
    return _finish_grad_reference(
        params, xh[:, H:H + L] + narrow + wide + broadcast[:, None, :])


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


def local_track_segment_oh_grad_reference(
    params: Params, x: torch.Tensor, broadcast_seg: torch.Tensor,
    seg_oh: torch.Tensor, narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Port of the JAX `local_track_segment_oh_reference` (fused_block.py:
    299-350), the composition `fused_local_track_segments`' backward
    differentiates: masked tap products, their sum, the one-hot gather and
    the dense in x's dtype, float32 LN statistics only."""
    dtype = x.dtype
    oh = seg_oh.to(dtype)
    L = x.shape[1]

    def conv(p, dilation):
        kernel = p["kernel"].to(dtype)
        total = (kernel.shape[0] - 1) * dilation
        lo = total // 2
        xp = F.pad(x, (0, 0, lo, total - lo))
        ohp = F.pad(oh, (0, 0, lo, total - lo))
        acc = None
        for t in range(kernel.shape[0]):
            off = t * dilation
            mask = (oh * ohp[:, off:off + L]).sum(-1, keepdim=True)
            part = (xp[:, off:off + L] * mask) @ kernel[t]
            acc = part if acc is None else acc + part
        return acc + p["bias"].to(dtype)

    bcast = torch.einsum("bls,bsc->blc", oh, broadcast_seg.to(dtype))
    narrow = gelu_stepwise(conv(params["narrow_conv"], narrow_dilation))
    wide = gelu_stepwise(conv(params["wide_conv"], wide_dilation))
    return _finish_grad_reference(params, x + narrow + wide + bcast)


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


@functools.lru_cache(maxsize=64)
def track_scratch_layout(B: int, L: int, C: int, quant: bool) -> tuple:
    """The scratches of one bf16 local-track call (and of #2 / #4 in
    float32) as parts of one byte buffer, in the C entry's order: ((shape,
    dtype, byte offset), ...) and the buffer's bytes, each part 256-byte
    aligned. On #3's int8 leg the dequantized nk, wk (9, C, C) and dk (C,
    C) bf16 its dequantize pass writes, then the float32 (B, L, C) h where
    the conv pass and the finish pass meet (csrc/local_track_sm90.cuh)."""
    parts = ([((KERNEL_TAPS, C, C), torch.bfloat16)] * 2
             + [((C, C), torch.bfloat16)] if quant else [])
    parts.append(((B, L, C), torch.float32))
    layout, offset = [], 0
    for shape, dtype in parts:
        layout.append((shape, dtype, offset))
        offset += -(-math.prod(shape) * dtype.itemsize // 256) * 256
    return tuple(layout), offset


def _scratch(B: int, L: int, C: int, quant: bool, needed: bool,
             device: torch.device):
    """One fresh buffer for `track_scratch_layout`'s parts (each
    torch.empty costs the host several microseconds) and the parts'
    addresses; (None, [None, ...]) where the launch needs no scratch
    (float32 K1 and #3). The caller keeps the buffer until it has
    launched."""
    layout, nbytes = track_scratch_layout(B, L, C, quant)
    if not needed:
        return None, [None] * len(layout)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return buf, [buf.data_ptr() + off for _, _, off in layout]


def track_dequant_reference(q: torch.Tensor, scale: torch.Tensor,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """Plain version of #3-int8's dequantize pass
    (csrc/local_track_sm90.cuh `dequant_track_kernel`): int8 q (..., C_in,
    C_out) with float32 scales (..., C_out), one per (tap, output column)
    → q·scale in float32, cast to `dtype`: the operand the floating-point
    leg loads from the dequantized weights."""
    return dequant_leaf({"q": q, "scale": scale}).to(dtype)


def _device_check(name: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version); raise for a device
    the port does not run on; False for CUDA (launch)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def _launch_track(
    name: str, params: Params, x: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int, wide_dilation: int, halo: int,
) -> torch.Tensor:
    """One launch of K1 (C <= 512) or #2 (512 < C <= 2048) on CUDA
    tensors — of their prehaloed entries when halo > 0, x then (B, L +
    2·halo, C); ValueError, before any launch, for what neither covers (a
    shape, or in bf16 an x, nk, wk or dk TMA cannot read)."""
    B, Lx, C = x.shape
    L = Lx - 2 * halo
    code, weights = _track_operands(
        name, params, x, narrow_dilation, wide_dilation,
        KERNEL_WIDTHS + TILED_WIDTHS)
    if L < 1:
        raise ValueError(f"{name}: {Lx} rows hold no centre inside a "
                         f"{halo}-row halo")
    if tuple(broadcast.shape) != (B, C):
        raise ValueError(f"{name}: broadcast {tuple(broadcast.shape)} != "
                         f"{(B, C)}")
    x, bc = (t.to(x.dtype).contiguous() for t in (x, broadcast))
    out = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    if C in KERNEL_WIDTHS:
        kernel = LOCAL_TRACK_VALID if halo else LOCAL_TRACK
    else:
        kernel = LOCAL_TRACK_TILED_VALID if halo else LOCAL_TRACK_TILED
    bf16 = x.dtype == torch.bfloat16
    if bf16:  # the conv pass reads x, nk, wk by TMA, the finish pass dk
        check_tma(name, x, weights[0], weights[2], weights[6])
    check_cuda(name, x, bc, *weights, out)
    # The two passes (bf16, and #2 in float32) meet in a float32 scratch.
    _buf, (h,) = _scratch(B, L, C, False, bf16 or C not in KERNEL_WIDTHS,
                          x.device)
    with torch.cuda.device(x.device):
        kernel.launch(code, *(t.data_ptr() for t in (x, bc, *weights)), h,
                      out.data_ptr(), B, L, C, wide_dilation,
                      stream_ptr(x.device))
    return out


def _local_track_kernel(
    params: Params, x: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int, wide_dilation: int,
) -> torch.Tensor:
    return _launch_track("fused_local_track", params, x, broadcast,
                         narrow_dilation, wide_dilation, 0)


def _local_track_valid_kernel(
    params: Params, xh: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int, wide_dilation: int,
) -> torch.Tensor:
    return _launch_track("fused_local_track_valid", params, xh, broadcast,
                         narrow_dilation, wide_dilation,
                         track_halo(params, narrow_dilation, wide_dilation))


def fused_local_track(
    params: Params, x: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Local track of one block. x (B, L, C) activations; broadcast (B, C)
    the projected global→local vector (gelu(dense(global))); params the
    block's narrow_conv, wide_conv, local_ln1, local_dense, local_ln2.
    CUDA → K1 or #2 by width (or ValueError), CPU → the plain version;
    differentiable through `local_track_grad_reference` either way. Quant
    leaves are dequantized first: K1 and #2 have no int8 leg."""
    params = dequant_params(params)
    run = (local_track_reference if _device_check("fused_local_track", x)
           else _local_track_kernel)
    return recompute_vjp(run, local_track_grad_reference, params, x,
                         broadcast, narrow_dilation, wide_dilation)


def fused_local_track_valid(
    params: Params, xh: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Local track of one PREHALOED sequence shard: xh (B, L + 2·halo, C)
    whose first and last `track_halo(params, ...)` rows are the
    neighbours' real rows (zeros at the ends of the sequence) → the (B, L,
    C) centre. CUDA → K1's or #2's prehaloed entry by width (or
    ValueError), CPU → the plain version; differentiable through
    `local_track_valid_grad_reference` either way. Quant leaves are
    dequantized first."""
    params = dequant_params(params)
    run = (local_track_valid_reference
           if _device_check("fused_local_track_valid", xh)
           else _local_track_valid_kernel)
    return recompute_vjp(run, local_track_valid_grad_reference, params, xh,
                         broadcast, narrow_dilation, wide_dilation)


def _segments_reference(
    params: Params, x: torch.Tensor, broadcast_seg: torch.Tensor,
    segment_ids: torch.Tensor, narrow_dilation: int, wide_dilation: int,
) -> torch.Tensor:
    """#3's plain version on integer ids (the one-hot built here)."""
    return local_track_segment_oh_reference(
        params, x, broadcast_seg,
        segment_one_hot(segment_ids, broadcast_seg.shape[1]),
        narrow_dilation, wide_dilation)


def _segments_grad_reference(
    params: Params, x: torch.Tensor, broadcast_seg: torch.Tensor,
    segment_ids: torch.Tensor, narrow_dilation: int, wide_dilation: int,
) -> torch.Tensor:
    """#3's backward reference on integer ids (the one-hot built here)."""
    return local_track_segment_oh_grad_reference(
        params, x, broadcast_seg,
        segment_one_hot(segment_ids, broadcast_seg.shape[1]),
        narrow_dilation, wide_dilation)


def _segments_kernel(
    params: Params, x: torch.Tensor, broadcast_seg: torch.Tensor,
    segment_ids: torch.Tensor, narrow_dilation: int, wide_dilation: int,
) -> torch.Tensor:
    """One launch of #3 (C <= 512) or #4 (512 < C <= 2048) on CUDA
    tensors — of #3's int8 leg for quant leaves (C <= 512 only);
    ValueError, before any launch, for what none covers (a shape, or in
    bf16 an x or conv / dense kernel that TMA, or the int8 leg's 16-byte
    loads, cannot read)."""
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
    if C in KERNEL_WIDTHS:
        kernel = LOCAL_TRACK_SEGMENTS_Q8 if quant else LOCAL_TRACK_SEGMENTS
    else:
        kernel = LOCAL_TRACK_SEGMENTS_TILED
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        # The conv pass reads x, nk, wk by TMA, the finish pass dk; the
        # int8 leg's dequantize pass reads int8 nq, wq, dq and their scales
        # in 16-byte loads.
        check_tma("fused_local_track_segments", x,
                  *(weights[i] for i in ((0, 1, 3, 4, 8, 9) if quant
                                         else (0, 2, 6))))
    check_cuda("fused_local_track_segments", x, seg, bc, *weights, out)
    _buf, scratch = _scratch(B, L, C, quant, bf16 or C not in KERNEL_WIDTHS,
                             x.device)
    with torch.cuda.device(x.device):
        kernel.launch(code, *(t.data_ptr() for t in (x, seg, bc, *weights)),
                      *scratch, out.data_ptr(), B, L, C, S, wide_dilation,
                      stream_ptr(x.device))
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
    differentiable through `local_track_segment_oh_grad_reference` either
    way. Quant leaves:
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
    return recompute_vjp(run, _segments_grad_reference, params, x,
                         broadcast_seg, segment_ids, narrow_dilation,
                         wide_dilation)


def local_track_flops(B: int, L: int, C: int, taps: int = KERNEL_TAPS) -> int:
    """The TPU kernel's own count (fused_block.py:779): two k-tap convs
    and the dense, 2·B·L·C²·(2·taps + 1)."""
    return 2 * B * L * C * C * (2 * taps + 1)
