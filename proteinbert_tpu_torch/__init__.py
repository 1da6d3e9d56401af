"""proteinbert_tpu_torch — the PyTorch/CUDA port of proteinbert_tpu.

The JAX package (`proteinbert_tpu/`) stays the reference; this package
mirrors its module names so each counterpart is easy to find, and never
imports it (nor JAX). Parameters are plain nested dicts of tensors in
the JAX pytree layout (conv kernels (K, Cin, Cout), dense (in, out),
attention projections (H, ·, ·)), with the blocks as a list.

Device rule: every entry point takes `device=None`, which means
"cuda". Without a CUDA device the caller must ask for `device="cpu"`
explicitly; nothing falls back to the CPU silently. On a CUDA tensor
the kernel wrappers launch the hand-written Hopper kernels
(`csrc/`) or raise; on a CPU tensor they run the kernels' plain
PyTorch versions.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DeviceLike", "resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` → "cuda". Raises when CUDA is asked for (explicitly or by
    default) and no CUDA device exists, and on device types the port
    does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; the port runs on "
                         "'cuda' or 'cpu'")
    return dev
