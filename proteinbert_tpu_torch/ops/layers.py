"""Core layers: dense, LayerNorm, dilated Conv1d, embedding, GELU.

Port of `proteinbert_tpu/ops/layers.py`: plain functions of a params
dict and a tensor, in the JAX package's layouts — feature-last (B, L, C)
activations, (in, out) dense kernels, (K, Cin, Cout) conv kernels —
computing in the dtype of the activation they are given (weights are
cast to it, as `dense_apply`/`conv1d_apply` do in JAX).

Numerics follow the JAX layers: LayerNorm takes float32 statistics with
the biased variance and eps 1e-5 over the feature axis only, then casts
back; GELU is the tanh approximation (`jax.nn.gelu`'s default).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (approximate=True): the tanh form, not torch's erf
    default."""
    return F.gelu(x, approximate="tanh")


def gelu_stepwise(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (approximate=True) written out op by op in x's dtype,
    so each product and sum rounds to that dtype as XLA's do. In bfloat16
    `F.gelu` computes in float32 and rounds once, a one-ulp difference at
    about 40% of inputs; the ports of the JAX XLA references (the kernels'
    backward) use this form."""
    k0 = torch.tensor(0.7978845608028654, dtype=x.dtype)  # sqrt(2 / pi)
    return x * (0.5 * (1.0 + torch.tanh(k0 * (x + 0.044715 * (x * x * x)))))


def dense_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ b), contracting the last axis of x."""
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def layer_norm_f32(x32: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LN of a float32 tensor over its last axis (biased variance)."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale + bias


def layer_norm_apply(params: Params, x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-position LN over the feature axis; fp32 statistics, result in
    x's dtype."""
    y = layer_norm_f32(x.float(), params["scale"].float(),
                       params["bias"].float(), eps)
    return y.to(x.dtype)


def conv1d_apply(params: Params, x: torch.Tensor,
                 dilation: int = 1) -> torch.Tensor:
    """'SAME'-padded dilated 1D convolution in (B, L, C) layout with a
    (K, Cin, Cout) kernel — `lax.conv_general_dilated` with
    dimension_numbers ("NWC", "WIO", "NWC")."""
    w = params["kernel"].to(x.dtype).permute(2, 1, 0)  # (Cout, Cin, K)
    y = F.conv1d(x.transpose(1, 2), w, padding="same", dilation=dilation)
    return y.transpose(1, 2) + params["bias"].to(x.dtype)


def embedding_apply(params: Params, ids: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    table = params["embedding"]
    if dtype is not None:
        table = table.to(dtype)
    return table[ids]
