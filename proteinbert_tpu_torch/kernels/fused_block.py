"""K1 — the fused local track: plain PyTorch version and CUDA wrapper.

Port of `proteinbert_tpu/kernels/fused_block.py` (`_fused_kernel`, entry
`fused_local_track`). The local half of a ProteinBERT block:

    h  = x + gelu(narrow_conv(x)) + gelu(wide_conv(x)) + broadcast
    x1 = LN(h)
    y  = LN(x1 + gelu(dense(x1)))

`fused_local_track` runs the hand-written Hopper kernel
(`csrc/local_track.cu`) on a CUDA tensor and the plain version
`local_track_reference` on a CPU tensor. A CUDA call the kernel does not
cover (dtype, width, conv geometry) raises ValueError; nothing falls
back.

Rounding points are the TPU kernel's, which the plain version repeats:
the tap products and both conv outputs stay float32 (fused_block.py
:539-547), x1 is rounded to the activation dtype before the dense
(:517), LN statistics are float32. In float32 this is exactly the JAX
`local_track_reference`; in bfloat16 the JAX reference rounds the conv
outputs where the kernel does not.
"""

from __future__ import annotations

from typing import Dict

import torch

from proteinbert_tpu_torch.kernels.build import (
    INT, PTR, Kernel, check_cuda, stream_ptr,
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

# What the CUDA kernel covers.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_WIDTHS = (128, 256, 512)
KERNEL_TAPS = 9
MAX_WIDE_DILATION = 5  # the window's 20-row halo


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
    ln1, ln2, dn = (params["local_ln1"], params["local_ln2"],
                    params["local_dense"])
    x1 = layer_norm_f32(h, ln1["scale"].float(), ln1["bias"].float()
                        ).to(dtype).float()
    d = x1 @ dn["kernel"].to(dtype).float() + dn["bias"].float()
    return layer_norm_f32(x1 + gelu(d), ln2["scale"].float(),
                          ln2["bias"].float()).to(dtype)


def fused_local_track(
    params: Params, x: torch.Tensor, broadcast: torch.Tensor,
    narrow_dilation: int = 1, wide_dilation: int = 5,
) -> torch.Tensor:
    """Local track of one block. x (B, L, C) activations; broadcast (B, C)
    the projected global→local vector (gelu(dense(global))); params the
    block's narrow_conv, wide_conv, local_ln1, local_dense, local_ln2.
    CUDA → the kernel (or ValueError), CPU → the plain version."""
    if x.device.type == "cpu":
        return local_track_reference(params, x, broadcast, narrow_dilation,
                                     wide_dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_local_track: unsupported device {x.device}")
    B, L, C = x.shape
    dtype = x.dtype
    nk = params["narrow_conv"]["kernel"]
    wk = params["wide_conv"]["kernel"]
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_local_track: no kernel for {dtype}")
    if C not in KERNEL_WIDTHS:
        raise ValueError(f"fused_local_track: no kernel for C={C} "
                         f"(have {KERNEL_WIDTHS})")
    conv_shape = (KERNEL_TAPS, C, C)
    if (tuple(nk.shape) != conv_shape or tuple(wk.shape) != conv_shape
            or narrow_dilation != 1
            or not 1 <= wide_dilation <= MAX_WIDE_DILATION):
        raise ValueError(
            "fused_local_track: the kernel covers k=9 convs with narrow "
            f"dilation 1 and wide dilation <= {MAX_WIDE_DILATION}; got "
            f"{tuple(nk.shape)}/{tuple(wk.shape)}, dilations "
            f"{narrow_dilation}/{wide_dilation}")
    if tuple(broadcast.shape) != (B, C):
        raise ValueError(f"fused_local_track: broadcast {tuple(broadcast.shape)}"
                         f" != {(B, C)}")
    ln1, ln2, dn = (params["local_ln1"], params["local_ln2"],
                    params["local_dense"])
    x, bc, nk, wk, dk = (t.to(dtype).contiguous() for t in (
        x, broadcast, nk, wk, dn["kernel"]))
    nb, wb, s1, b1, db, s2, b2 = (
        t.float().contiguous() for t in (
            params["narrow_conv"]["bias"], params["wide_conv"]["bias"],
            ln1["scale"], ln1["bias"], dn["bias"], ln2["scale"],
            ln2["bias"]))
    out = torch.empty_like(x)
    ops = (x, bc, nk, nb, wk, wb, s1, b1, dk, db, s2, b2, out)
    check_cuda("fused_local_track", *ops)
    with torch.cuda.device(x.device):
        LOCAL_TRACK.launch(KERNEL_DTYPES[dtype],
                           *(t.data_ptr() for t in ops),
                           B, L, C, wide_dilation, stream_ptr(x.device))
    return out


def local_track_flops(B: int, L: int, C: int, taps: int = KERNEL_TAPS) -> int:
    """The TPU kernel's own count (fused_block.py:779): two k-tap convs
    and the dense, 2·B·L·C²·(2·taps + 1)."""
    return 2 * B * L * C * C * (2 * taps + 1)
