"""Carry weights between the JAX package's flat layout and the port.

The flat layout is the one `proteinbert_tpu/export.py` writes
(`flatten_params` / `pbt export`): slash-joined pytree paths such as
`embedding/embedding` or `blocks/<i>/narrow_conv/kernel`, one float32
array each, blocks unstacked. Conv kernels are (K, Cin, Cout), dense
kernels (in, out), `attention/wq|wk|wv` (H, ·, ·) — the layouts the port
keeps — so the mapping is a rename, never a transpose, and the round
trip is bit-exact.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import ModelConfig
from proteinbert_tpu_torch.models.proteinbert import Params, to_device


def expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Flat key → shape of every parameter of a `cfg` model."""
    C, G, A, V = (cfg.local_dim, cfg.global_dim, cfg.num_annotations,
                  cfg.vocab_size)
    H, k, v = cfg.num_heads, cfg.key_dim, cfg.value_dim
    shapes = {"embedding/embedding": (V, C),
              "global_in/kernel": (A, G), "global_in/bias": (G,),
              "local_head/kernel": (C, V), "local_head/bias": (V,),
              "global_head/kernel": (G, A), "global_head/bias": (A,)}
    block = {"narrow_conv/kernel": (cfg.narrow_kernel, C, C),
             "narrow_conv/bias": (C,),
             "wide_conv/kernel": (cfg.wide_kernel, C, C),
             "wide_conv/bias": (C,),
             "global_to_local/kernel": (G, C), "global_to_local/bias": (C,),
             "local_ln1/scale": (C,), "local_ln1/bias": (C,),
             "local_dense/kernel": (C, C), "local_dense/bias": (C,),
             "local_ln2/scale": (C,), "local_ln2/bias": (C,),
             "global_dense1/kernel": (G, G), "global_dense1/bias": (G,),
             "attention/wq": (H, G, k), "attention/wk": (H, C, k),
             "attention/wv": (H, C, v),
             "global_ln1/scale": (G,), "global_ln1/bias": (G,),
             "global_dense2/kernel": (G, G), "global_dense2/bias": (G,),
             "global_ln2/scale": (G,), "global_ln2/bias": (G,)}
    for i in range(cfg.num_blocks):
        for key, shape in block.items():
            shapes[f"blocks/{i}/{key}"] = shape
    return shapes


def params_from_flat(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                     device: DeviceLike = None) -> Params:
    """Flat {path: array} → the port's params on `device` (None →
    "cuda"). Every key of a `cfg` model must be present with its shape;
    extra keys raise too, so a mismatched checkpoint cannot load."""
    device = resolve_device(device)
    want = expected_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"flat params do not match the config: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    tree: Dict = {}
    for key, shape in want.items():
        arr = np.asarray(flat[key], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{key}: shape {arr.shape} != {shape}")
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(arr.copy())
    blocks = tree.pop("blocks")
    tree["blocks"] = [blocks[str(i)] for i in range(cfg.num_blocks)]
    return to_device(tree, device)


def params_to_flat(params: Params) -> Dict[str, np.ndarray]:
    """Inverse of `params_from_flat`: float32 numpy arrays under the
    flat keys."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            flat["/".join(path)] = node.detach().to("cpu",
                                                    torch.float32).numpy()

    walk(params, ())
    return flat


def load_npz(path: str, cfg: ModelConfig,
             device: DeviceLike = None) -> Params:
    """Load a `pbt export` NPZ straight into the port."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_flat(flat, cfg, device)
