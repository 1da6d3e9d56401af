"""Migrate reference (PyTorch) checkpoints into the port — the port of
`proteinbert_tpu/interop.py`.

A user of the reference repo holds `torch.save`d artifacts in one of
three forms: the periodic pretraining checkpoint dict (key
`model_state_dict`), a bare state_dict, or the final pickled
`nn.Module`. This module turns any of them into the port's params, torch
to torch, with the JAX module's key map and layout rules:

  local_embedding.weight                  → embedding.embedding      (V, C)
  global_linear_layer.0.{weight,bias}     → global_in                (A→G, .T)
  proteinBERT_blocks.{i}.
    local_narrow_conv_layer.0.*           → blocks.narrow_conv       (Cout,Cin,K)→(K,Cin,Cout)
    local_wide_conv_layer.0.*             → blocks.wide_conv         ditto
    global_to_local_linear_layer.0.*      → blocks.global_to_local   (.T)
    local_linear_layer.0.*                → blocks.local_dense       (.T)
    global_linear_layer_1.0.*             → blocks.global_dense1     (.T)
    global_linear_layer_2.0.*             → blocks.global_dense2     (.T)
    local_norm_{1,2}.*                    → blocks.local_ln{1,2}     (see below)
    global_norm_{1,2}.*                   → blocks.global_ln{1,2}
  pretraining_local_output.0.*            → local_head               (.T)
  pretraining_global_output.0.*           → global_head              (.T)

The two decisions the JAX module documents hold here too:

1. The reference's local LayerNorms carry a per-(position, feature)
   (L, C) affine; the model's LayerNorm is per feature, so the affine is
   averaged over positions (exact while it is position-independent).
2. The reference's attention projections are never saved (a plain Python
   list), so converted models keep a fresh attention init — drawn here
   from the port's `models.proteinbert.init` with the caller's generator,
   so those three leaves a block differ from the JAX package's fresh
   init; every converted leaf is the same float32 array in both.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import ModelConfig
from proteinbert_tpu_torch.models import proteinbert
from proteinbert_tpu_torch.models.proteinbert import to_device
from proteinbert_tpu_torch.weights import params_from_flat, params_to_flat

Params = Dict[str, Any]

_BLOCK_PREFIX = "proteinBERT_blocks."

# torch Sequential submodule → the block's param name, with the transform
# each weight needs ("linear" transposes, "conv" goes (Cout,Cin,K)→(K,Cin,Cout)).
_BLOCK_MAP = {
    "local_narrow_conv_layer.0": ("narrow_conv", "conv"),
    "local_wide_conv_layer.0": ("wide_conv", "conv"),
    "global_to_local_linear_layer.0": ("global_to_local", "linear"),
    "local_linear_layer.0": ("local_dense", "linear"),
    "global_linear_layer_1.0": ("global_dense1", "linear"),
    "global_linear_layer_2.0": ("global_dense2", "linear"),
    "local_norm_1": ("local_ln1", "norm"),
    "local_norm_2": ("local_ln2", "norm"),
    "global_norm_1": ("global_ln1", "norm"),
    "global_norm_2": ("global_ln2", "norm"),
}


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _weight(kind: str, w: np.ndarray) -> np.ndarray:
    if kind == "linear":  # torch (out, in) → (in, out)
        return w.T
    if kind == "conv":  # torch (Cout, Cin, K) → (K, Cin, Cout)
        return w.transpose(2, 1, 0)
    return w


def _norm_affine(w: np.ndarray) -> np.ndarray:
    """(L, C) joint-LN affine → per-feature (C,) (module docstring #1)."""
    return w.mean(axis=0) if w.ndim == 2 else w


def convert_reference_state_dict(
    state_dict: Mapping[str, Any], cfg: ModelConfig,
    generator: Optional[torch.Generator] = None, device: DeviceLike = None,
) -> Params:
    """Reference `model_state_dict` → the port's params on `device` (None
    → "cuda").

    `cfg` must match the torch model's geometry (local/global dims,
    blocks, annotations); mismatched shapes raise ValueError. The
    parameters the reference never saved (attention, docstring #2) keep
    the fresh init drawn from `generator` (default: seed 0)."""
    device = resolve_device(device)
    gen = generator if generator is not None else (
        torch.Generator().manual_seed(0))
    flat = params_to_flat(proteinbert.init(cfg, gen, device="cpu"))
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    consumed = set()

    def take(key: str, target: str, transform=lambda w: w) -> None:
        if key not in sd:
            raise ValueError(
                f"torch state_dict is missing {key!r} (config mismatch? "
                f"e.g. more blocks configured than the checkpoint has)")
        w = transform(sd[key])
        if w.shape != flat[target].shape:
            raise ValueError(
                f"{key}: converted shape {w.shape} != expected "
                f"{flat[target].shape} (config mismatch?)")
        consumed.add(key)
        flat[target] = np.ascontiguousarray(w, dtype=np.float32)

    take("local_embedding.weight", "embedding/embedding")
    for name, tkey in (("global_in", "global_linear_layer.0"),
                       ("local_head", "pretraining_local_output.0"),
                       ("global_head", "pretraining_global_output.0")):
        take(f"{tkey}.weight", f"{name}/kernel", lambda w: w.T)
        take(f"{tkey}.bias", f"{name}/bias")

    for i in range(cfg.num_blocks):
        for sub, (ours, kind) in _BLOCK_MAP.items():
            wkey = f"{_BLOCK_PREFIX}{i}.{sub}.weight"
            bkey = f"{_BLOCK_PREFIX}{i}.{sub}.bias"
            at = f"blocks/{i}/{ours}"
            if kind == "norm":
                take(wkey, f"{at}/scale", _norm_affine)
                take(bkey, f"{at}/bias", _norm_affine)
            else:
                take(wkey, f"{at}/kernel", lambda w, k=kind: _weight(k, w))
                take(bkey, f"{at}/bias")
        # The reference's learned k-dim contraction of its tiled-query
        # attention has no counterpart (one query per head): skip it.
        consumed.add(f"{_BLOCK_PREFIX}{i}.global_attention_layer.W_parameter")

    leftover = set(sd) - consumed
    if leftover:
        raise ValueError(
            f"unrecognized torch keys (wrong architecture?): "
            f"{sorted(leftover)[:5]}{'...' if len(leftover) > 5 else ''}")
    return to_device(params_from_flat(flat, cfg, device="cpu"), device)


def load_reference_checkpoint(
    path: str, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[Params, int]:
    """Load a reference torch artifact (checkpoint dict, bare state_dict
    or pickled module) and convert it. Returns (params, step): the
    periodic checkpoint's `current_batch_iteration`, else 0."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    step = 0
    if hasattr(obj, "state_dict"):  # the final whole-module save
        sd = obj.state_dict()
    elif isinstance(obj, Mapping) and "model_state_dict" in obj:
        sd = obj["model_state_dict"]  # the periodic checkpoint
        step = int(obj.get("current_batch_iteration", 0))
    elif isinstance(obj, Mapping):
        sd = obj
    else:
        raise ValueError(f"unrecognized torch artifact in {path}: {type(obj)}")
    return convert_reference_state_dict(sd, cfg, generator, device), step
