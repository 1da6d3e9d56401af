"""ProteinBERT dual-track model — port of
`proteinbert_tpu/models/proteinbert.py` (dense and packed rows).

Parameters are a plain nested dict in the JAX pytree's layout, with the
blocks as a list (the JAX package stacks them for `lax.scan`; its flat
export unstacks them to `blocks/<i>/...`, which is what `weights.py`
reads). Activations run in `cfg.dtype`, parameters are float32.

Block dataflow (reference modules.py:201-231):
  local:  x = LN(x + narrow_conv(x)·gelu + wide_conv(x)·gelu
                 + broadcast(gelu(dense(g))))
          x = LN(x + gelu(dense(x)))
  global: g = LN(g + gelu(dense(g)) + attention(x, g))
          g = LN(g + gelu(dense(g)))

Both tracks of a block go through the one-pass dispatch
(`kernels/one_pass.fused_onepass_dense` / `fused_onepass_segments`), the
JAX `use_pallas` branch, whose routes are JAX's decisions on the same
shape (`cfg.use_pallas` is ignored): kernel #6 where the reference's
rule admits the shape, else the composition — K1 / #2 (dense) or #3 / #4
(packed) then K2, each leg on the port of the JAX XLA reference where
the JAX gate refuses the shape and no port kernel covers it (the `tiny`
preset's local track, C=32; K2 covers its attention). The attention
reads the NEW local track and the OLD global track either way. On CUDA
the kernels run; on the CPU their plain versions. PACKED rows
(data/packing.py) carry `segment_ids` (B, L) and a per-segment global
track (B, S, G): the convs never cross a segment, each position gets its
own segment's broadcast, and attention runs per segment, so a packed row
is numerically a batch of independent proteins. The small products
outside the kernels (global→local and the global-track denses) are plain
matmuls, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import ModelConfig
from proteinbert_tpu_torch.data.vocab import PAD_ID
from proteinbert_tpu_torch.kernels import (
    TRACK_PARAMS, fused_onepass_dense, fused_onepass_segments, is_quant_leaf,
)
from proteinbert_tpu_torch.kernels.path_counter import quiet
from proteinbert_tpu_torch.ops.layers import (
    dense_apply, embedding_apply, gelu, layer_norm_apply,
)

Params = Dict[str, Any]

LN_NAMES = ("local_ln1", "local_ln2", "global_ln1", "global_ln2")


def check_remat_policy(cfg: ModelConfig) -> None:
    """JAX's `remat_wrap` refusal, word for word: the port has no block
    remat (the kernels' backward already saves only their inputs), but a
    config the JAX model refuses is refused here too."""
    if cfg.remat_policy not in ("full", "convs"):
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; have 'full', 'convs'"
        )


def activation_dtype(cfg: ModelConfig) -> torch.dtype:
    dtype = getattr(torch, cfg.dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown activation dtype {cfg.dtype!r}")
    return dtype


# ----------------------------------------------------------------- init

def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """jax.nn.initializers.lecun_normal: a normal truncated at ±2σ whose
    variance is 1/fan_in after the truncation."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                       generator=gen)


def _dense_init(gen, in_dim: int, out_dim: int) -> Params:
    return {"kernel": _lecun_normal((in_dim, out_dim), in_dim, gen),
            "bias": torch.zeros(out_dim)}


def _conv_init(gen, k: int, in_dim: int, out_dim: int) -> Params:
    return {"kernel": _lecun_normal((k, in_dim, out_dim), k * in_dim, gen),
            "bias": torch.zeros(out_dim)}


def _ln_init(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    C, G, k, H = cfg.local_dim, cfg.global_dim, cfg.key_dim, cfg.num_heads
    v = cfg.value_dim
    return {
        "narrow_conv": _conv_init(gen, cfg.narrow_kernel, C, C),
        "wide_conv": _conv_init(gen, cfg.wide_kernel, C, C),
        "global_to_local": _dense_init(gen, G, C),
        "local_ln1": _ln_init(C),
        "local_dense": _dense_init(gen, C, C),
        "local_ln2": _ln_init(C),
        "global_dense1": _dense_init(gen, G, G),
        "attention": {"wq": _lecun_normal((H, G, k), G, gen),
                      "wk": _lecun_normal((H, C, k), C, gen),
                      "wv": _lecun_normal((H, C, v), C, gen)},
        "global_ln1": _ln_init(G),
        "global_dense2": _dense_init(gen, G, G),
        "global_ln2": _ln_init(G),
    }


def init(cfg: ModelConfig, generator: torch.Generator,
         device: DeviceLike = None) -> Params:
    """Random full-model parameters drawn from `generator` (on the CPU,
    so a seed gives the same weights on every device), then placed on
    `device` (None → "cuda")."""
    return to_device(_init_tree(cfg, generator), resolve_device(device))


def abstract_params(cfg: ModelConfig) -> Params:
    """The params tree's shapes and dtypes on the meta device, nothing
    allocated or drawn (the JAX package's `jax.eval_shape` of `init`)."""
    with torch.device("meta"):
        return _init_tree(cfg, torch.Generator())


def _init_tree(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return {
        "embedding": {"embedding": torch.randn(
            (cfg.vocab_size, cfg.local_dim), generator=generator)},
        "global_in": _dense_init(generator, cfg.num_annotations,
                                 cfg.global_dim),
        "blocks": [block_init(generator, cfg)
                   for _ in range(cfg.num_blocks)],
        "local_head": _dense_init(generator, cfg.local_dim, cfg.vocab_size),
        "global_head": _dense_init(generator, cfg.global_dim,
                                   cfg.num_annotations),
    }


def to_device(tree, device: torch.device):
    """Every tensor of a params tree on `device`; a tensor that several
    leaves share (an int8 tree's block-vector scales) stays shared."""
    return _move(tree, device, {})


def _move(t, device: torch.device, moved: dict):
    # Module-level recursion: a self-calling closure would be a reference
    # cycle holding `moved` (every moved tensor) until a gc pass.
    if isinstance(t, dict):
        return {k: _move(v, device, moved) for k, v in t.items()}
    if isinstance(t, list):
        return [_move(v, device, moved) for v in t]
    if id(t) not in moved:
        moved[id(t)] = t.to(device)
    return moved[id(t)]


# ---------------------------------------------------------------- apply

def cast_block(block: Params, dtype: torch.dtype) -> Params:
    """Every non-LN leaf in the activation dtype, once per forward (the
    JAX `_cast_blocks`); LN leaves stay float32, and int8 quant leaves
    ({"q", "scale"}, the int8 serving arm) pass through untouched: the
    int8 legs of the kernels take them as they are."""
    return {name: (sub if name in LN_NAMES
                   else {k: v if is_quant_leaf(v) else v.to(dtype)
                         for k, v in sub.items()})
            for name, sub in block.items()}


def block_apply(
    params: Params, local: torch.Tensor, global_: torch.Tensor,
    pad_mask: Optional[torch.Tensor], cfg: ModelConfig,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block. local (B, L, C), global_ (B, G), pad_mask (B, L) bool
    True at real positions. PACKED rows: segment_ids (B, L) and global_
    (B, S, G); pad_mask is then the real-token mask of the attention
    (in-span <pad> of a ragged serving span still feeds the convs)."""
    broadcast = gelu(dense_apply(params["global_to_local"], global_))
    track = {k: params[k] for k in TRACK_PARAMS}
    if segment_ids is not None:
        local, attn = fused_onepass_segments(
            track, params["attention"], local, broadcast, global_,
            segment_ids, pad_mask, 1, cfg.wide_dilation)
    else:
        local, attn = fused_onepass_dense(
            track, params["attention"], local, broadcast, global_, pad_mask,
            1, cfg.wide_dilation)
    dense1 = gelu(dense_apply(params["global_dense1"], global_))
    global_ = layer_norm_apply(params["global_ln1"], global_ + dense1 + attn)
    global_ = layer_norm_apply(
        params["global_ln2"],
        global_ + gelu(dense_apply(params["global_dense2"], global_)))
    return local, global_


def encode(
    params: Params, tokens: torch.Tensor, annotations: torch.Tensor,
    cfg: ModelConfig, pad_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None, tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trunk forward: embeddings + N blocks → (local (B, L, C),
    global (B, G)) in the activation dtype. PACKED rows: segment_ids
    (B, L) and annotations (B, S, A); global comes back (B, S, G).
    `tp` (`parallel.tensor_parallel.TensorParallel`): `global_in` holds
    this model rank's rows and runs row-parallel."""
    dtype = activation_dtype(cfg)
    if pad_mask is None:
        pad_mask = (segment_ids > 0 if segment_ids is not None
                    else tokens != PAD_ID)
    local = embedding_apply(params["embedding"], tokens, dtype)
    global_ = gelu(dense_apply(params["global_in"], annotations.to(dtype))
                   if tp is None else
                   tp.global_in(params["global_in"], annotations, dtype))
    check_remat_policy(cfg)
    for i, blk in enumerate(params["blocks"]):
        # JAX traces a scanned block stack's body once: one route decision
        # a family per forward under cfg.scan_blocks, else one a block.
        with quiet() if cfg.scan_blocks and i else contextlib.nullcontext():
            local, global_ = block_apply(cast_block(blk, dtype), local,
                                         global_, pad_mask, cfg, segment_ids)
    return local, global_


def encode_trunk(
    params: Params, tokens: torch.Tensor, cfg: ModelConfig,
    annotations: Optional[torch.Tensor] = None,
    pad_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """{"local", "global", "pad_mask"} — the shared representation;
    `annotations` defaults to the all-zero "no annotations known"
    input."""
    if pad_mask is None:
        pad_mask = tokens != PAD_ID
    if annotations is None:
        annotations = torch.zeros((tokens.shape[0], cfg.num_annotations),
                                  device=tokens.device)
    local, global_ = encode(params, tokens, annotations, cfg, pad_mask)
    return {"local": local, "global": global_, "pad_mask": pad_mask}


def apply(
    params: Params, tokens: torch.Tensor, annotations: torch.Tensor,
    cfg: ModelConfig, pad_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None, tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass → (local_logits (B, L, V), global_logits (B, A)),
    float32 LOGITS; global_logits is (B, S, A) for packed rows. `tp`:
    the GO head's tensor parallelism (`encode`); `global_head` then
    holds this model rank's columns and the logits come back whole."""
    local, global_ = encode(params, tokens, annotations, cfg, pad_mask,
                            segment_ids, tp)
    local_logits = dense_apply(params["local_head"], local).float()
    global_logits = (dense_apply(params["global_head"], global_).float()
                     if tp is None else
                     tp.global_head(params["global_head"], global_))
    return local_logits, global_logits
