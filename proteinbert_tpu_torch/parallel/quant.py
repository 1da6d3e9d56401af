"""int8 serving weights — port of the serving half of
`proteinbert_tpu/parallel/quant.py` (:95, :476-564, :599-773).

The int8 arm quantizes a trunk ONCE at load (`quantize_params`:
symmetric, one float32 scale per output channel, round to nearest even)
and serves it through the quantized entries below. Each entry takes the
quantized tree and runs the fp32 arm's own entry body (`inference.py`) on
`partial_dequantize_params(qparams)`: the block weights the kernels take
natively stay int8 (`_INKERNEL_QUANT_KEYS`) and go to the int8 legs of
#3, K2 and #6, which dequantize on the card; every other weight is
dequantized per call. So the quantized arm cannot drift from the fp32
arm's semantics.

Task heads: `_q_trunk_batch` / `_q_packed_trunk_batch` are the shared
trunk of `predict_task` on the int8 arm (the trunk through the int8 legs
of K2 and #3, or K1 on dequantized track weights); the head tails that
read the trunk's output stay float32.

`quantize_rows_int8` / `dequantize_rows_int8` are copies of the JAX
host-numpy row quantizers (`parallel/quant.py:567-600`) that the
neighbour index builder (`index/store.py`) quantizes its residual vectors
with. The reduce-scatter half (distribution) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from proteinbert_tpu_torch import inference
from proteinbert_tpu_torch.configs import ModelConfig
from proteinbert_tpu_torch.data.vocab import PAD_ID
from proteinbert_tpu_torch.heads import apply as heads_apply
from proteinbert_tpu_torch.kernels.quant_leaves import (
    dequant_leaf, dequant_params, is_quant_leaf,
)
from proteinbert_tpu_torch.models import proteinbert
from proteinbert_tpu_torch.ops.layers import dense_apply

# Serving quantization modes (configs.ServeConfig.quant): fp32 = the
# ordinary entries; int8 = int8 weights; int8_act = int8 weights + dynamic
# int8 fake-quant of the trunk's output activations (bucketed only).
SERVE_QUANT_MODES = ("fp32", "int8", "int8_act")


def _quant(w: torch.Tensor):
    """One leaf → {"q": int8, "scale": float32}, the scale reduced over
    axis -2 — `quantize_params`' formula, operation for operation."""
    w = w.float()
    amax = w.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _quantize_blocks(blocks: List[Any]) -> List[Any]:
    """The blocks as the JAX package quantizes its stacked (num_blocks,
    ...) block tensors: a leaf of two or more dims per block gets its own
    per-channel scales; a block's VECTOR (bias, LN scale) is a (blocks,
    C) stack there, so it is quantized too, with each channel's scale
    taken over all the blocks and shared by them."""

    def walk(leaves: List[Any]):
        if isinstance(leaves[0], dict):
            return [dict(zip(leaves[0], vals)) for vals in zip(*(
                walk([leaf[k] for leaf in leaves]) for k in leaves[0]))]
        if not leaves[0].is_floating_point():
            return leaves
        if leaves[0].dim() >= 2:
            return [_quant(leaf) for leaf in leaves]
        stacked = _quant(torch.stack(leaves))
        return [{"q": stacked["q"][i], "scale": stacked["scale"]}
                for i in range(len(leaves))]

    return walk(list(blocks))


def quantize_params(params: Any) -> Any:
    """Symmetric per-output-channel int8 quantization of a trunk at load
    time, bit for bit the JAX `quantize_params` on the same weights: every
    float leaf with two or more dims (dense/conv kernels, embeddings,
    attention projections) becomes {"q": int8, "scale": float32}, scale =
    amax over the input axis (-2) / 127 (1.0 where the amax is 0), q =
    round(w / scale) clipped to ±127; in the blocks, whose leaves the JAX
    package stacks, the vectors too (`_quantize_blocks`). Other 1-D leaves
    stay float32."""
    if isinstance(params, dict) and "blocks" in params:
        out = {k: quantize_params(v) for k, v in params.items()
               if k != "blocks"}
        out["blocks"] = _quantize_blocks(params["blocks"])
        return out

    def leaf(t):
        return _quant(t) if t.dim() >= 2 and t.is_floating_point() else t

    return _tree_map(leaf, params)


def dequantize_params(qparams: Any) -> Any:
    """Quantized tree → float32 params (q·scale)."""
    return dequant_params(qparams)


# The block weights the kernels take natively: the int8 legs of #3, K2
# and #6 dequantize them on the card. Everything else (embeddings, heads,
# the block's global-side denses, the vectors) is dequantized per call.
_INKERNEL_QUANT_KEYS = (
    ("narrow_conv", "kernel"),
    ("wide_conv", "kernel"),
    ("local_dense", "kernel"),
    ("attention", "wq"),
    ("attention", "wk"),
    ("attention", "wv"),
)


def partial_dequantize_params(qparams: Any) -> Any:
    """Quantized tree → the form the int8 arm runs: every quant leaf
    dequantized EXCEPT the block weights of `_INKERNEL_QUANT_KEYS`, which
    stay {"q", "scale"} for the int8 legs. (The JAX function's
    `use_pallas=False` branch, a full dequantize, has no counterpart: on
    the card the port always runs its kernels.)"""

    def walk(tree, path):
        if is_quant_leaf(tree):
            if "blocks" in path and path[-2:] in _INKERNEL_QUANT_KEYS:
                return tree
            return dequant_leaf(tree)
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,))
                              for i, v in enumerate(tree))
        return tree

    return walk(qparams, ())


def param_bytes(params: Any) -> int:
    """numel · element_size summed over the tensors of a tree (a quant
    leaf counts q and scale; a tensor that several leaves share, once): the
    resident weight bytes."""
    seen = {}

    def add(t):
        seen[id(t)] = t.numel() * t.element_size()
        return t

    _tree_map(add, params)
    return sum(seen.values())


class QuantConfigError(ValueError):
    """A quantization knob was combined with input it cannot honor (the
    JAX package's typed error; here: a row batch that is not 2-D)."""


def quantize_rows_int8(x) -> Tuple["np.ndarray", "np.ndarray"]:
    """Symmetric per-channel int8 quantization of a ROW BATCH on the host
    — the JAX function's arithmetic exactly (amax/127 scales, `np.rint`
    round-to-nearest-even, zero-range channels pinned to scale 1.0), so
    an index built by either package has the same bytes. Host numpy on
    purpose: re-runs of the index builder must write byte-identical
    blocks. Returns (codes int8 (n, d), scales fp32 (d,))."""
    import numpy as np
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 2:
        raise QuantConfigError(
            f"quantize_rows_int8 expects (rows, channels), got shape "
            f"{x.shape}")
    amax = np.max(np.abs(x), axis=0) if x.shape[0] else \
        np.zeros(x.shape[1], np.float32)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return codes, scale


def dequantize_rows_int8(codes, scale) -> "np.ndarray":
    """Inverse of quantize_rows_int8 (up to rounding): codes * scale,
    fp32 — the offline reference of the scorer's dequantize."""
    import numpy as np
    return (np.asarray(codes, np.float32)
            * np.asarray(scale, np.float32)[None, :])


def fake_quant_act(x: torch.Tensor) -> torch.Tensor:
    """Dynamic per-tensor symmetric int8 fake-quantization (the opt-in
    activation arm): quantize-dequantize, cast back to x's dtype."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return (torch.clamp(torch.round(xf / scale), -127, 127) * scale).to(
        x.dtype)


# ------------------------------------------------ the quantized entries
#
# Thin wrappers over the fp32 arm's entry bodies. The act variants
# re-compose encode + output heads with the trunk's output activations
# fake-quantized in between. They take `partial_dequantize_params` as the
# weight-only ones do, so the card runs the int8 legs on both arms (the
# JAX `_q_act_*` dequantize fully; the int8 legs give bit for bit the
# floating-point legs' output on the dequantized weights).


@torch.inference_mode()
def _q_encode_batch(qparams, tokens, annotations, cfg: ModelConfig):
    return inference._encode_batch(partial_dequantize_params(qparams),
                                   tokens, annotations, cfg)


@torch.inference_mode()
def _q_go_probs_batch(qparams, tokens, annotations, cfg: ModelConfig):
    return inference._go_probs_batch(partial_dequantize_params(qparams),
                                     tokens, annotations, cfg)


@torch.inference_mode()
def _q_residue_probs_batch(qparams, tokens, annotations, cfg: ModelConfig):
    return inference._residue_probs_batch(
        partial_dequantize_params(qparams), tokens, annotations, cfg)


def _act_logits(params, tokens, annotations, cfg: ModelConfig):
    """models/proteinbert.apply with the trunk outputs fake-quantized
    before the output heads (the activation arm's cut point)."""
    local, global_ = proteinbert.encode(params, tokens, annotations, cfg)
    local = fake_quant_act(local)
    global_ = fake_quant_act(global_)
    local_logits = dense_apply(params["local_head"], local).float()
    global_logits = dense_apply(params["global_head"], global_).float()
    return local, global_, local_logits, global_logits


@torch.inference_mode()
def _q_act_encode_batch(qparams, tokens, annotations, cfg: ModelConfig):
    params = partial_dequantize_params(qparams)
    local, global_, _, _ = _act_logits(params, tokens, annotations, cfg)
    mask = (tokens != PAD_ID).float()[:, :, None]
    local = local.float()
    return {"local_mean": (local * mask).sum(1) / mask.sum(1).clamp_min(1.0),
            "global": global_.float()}


@torch.inference_mode()
def _q_act_go_probs_batch(qparams, tokens, annotations, cfg: ModelConfig):
    params = partial_dequantize_params(qparams)
    _, _, _, gl = _act_logits(params, tokens, annotations, cfg)
    return torch.sigmoid(gl)


@torch.inference_mode()
def _q_act_residue_probs_batch(qparams, tokens, annotations,
                               cfg: ModelConfig):
    params = partial_dequantize_params(qparams)
    _, _, ll, _ = _act_logits(params, tokens, annotations, cfg)
    return torch.softmax(ll, -1)


@torch.inference_mode()
def _q_packed_encode_batch(qparams, tokens, segment_ids, annotations,
                           cfg: ModelConfig):
    return inference._packed_encode_batch(
        partial_dequantize_params(qparams), tokens, segment_ids, annotations,
        cfg)


@torch.inference_mode()
def _q_packed_go_probs_batch(qparams, tokens, segment_ids, annotations,
                             cfg: ModelConfig):
    return inference._packed_go_probs_batch(
        partial_dequantize_params(qparams), tokens, segment_ids, annotations,
        cfg)


@torch.inference_mode()
def _q_packed_residue_probs_batch(qparams, tokens, segment_ids, annotations,
                                  cfg: ModelConfig):
    return inference._packed_residue_probs_batch(
        partial_dequantize_params(qparams), tokens, segment_ids, annotations,
        cfg)


@torch.inference_mode()
def _q_trunk_batch(qparams, tokens, annotations, cfg: ModelConfig):
    return heads_apply.trunk_batch(partial_dequantize_params(qparams),
                                   tokens, annotations, cfg)


@torch.inference_mode()
def _q_packed_trunk_batch(qparams, tokens, segment_ids, annotations,
                          cfg: ModelConfig):
    return heads_apply.packed_trunk_batch(
        partial_dequantize_params(qparams), tokens, segment_ids, annotations,
        cfg)


def quant_entry(kind: str, act: bool = False):
    """The quantized entry for one request kind (bucketed path);
    activation fake-quant with `act`."""
    table = {
        ("embed", False): _q_encode_batch,
        ("predict_go", False): _q_go_probs_batch,
        ("predict_residues", False): _q_residue_probs_batch,
        ("embed", True): _q_act_encode_batch,
        ("predict_go", True): _q_act_go_probs_batch,
        ("predict_residues", True): _q_act_residue_probs_batch,
    }
    try:
        return table[(kind, act)]
    except KeyError:
        raise ValueError(f"no quantized entry for request kind {kind!r} "
                         f"(act={act})") from None


def quant_packed_entry(kind: str):
    """The quantized packed entry for one request kind (ragged path)."""
    table = {
        "embed": _q_packed_encode_batch,
        "predict_go": _q_packed_go_probs_batch,
        "predict_residues": _q_packed_residue_probs_batch,
    }
    try:
        return table[kind]
    except KeyError:
        raise ValueError(f"no quantized packed entry for request kind "
                         f"{kind!r}") from None
