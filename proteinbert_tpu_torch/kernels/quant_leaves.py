"""int8 weight leaves as the kernel wrappers take them.

Port of the quant-leaf helpers of `proteinbert_tpu/kernels/fused_block.py`
(:177-210). `parallel/quant.quantize_params` turns a weight into
{"q": int8, "scale": float32} — symmetric, one scale per output channel
(the scale reduced over the leaf's input axis, -2). The int8 serving arm
keeps the block weights that the kernels take natively in that form
(`parallel/quant.partial_dequantize_params`), and the int8 legs of #3, K2
and #6 load the int8 values and dequantize them on the card. Routes
without an int8 leg (K1, #2, #4) dequantize first, as the JAX dispatch
does. Re-exported by `kernels/fused_block.py`; a module of its own because
`attention.py`, which `fused_block.py` imports, needs it too.

The int8 legs are inference-only, as in the JAX package (its quantized
dispatches skip the custom VJP): `int8_leg` refuses an input that requires
grad.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch


def is_quant_leaf(x) -> bool:
    """Whether `x` is a quantized weight ({"q": int8, "scale": float32})
    rather than a plain tensor."""
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def weight_leaf(x):
    """The tensor that carries a (possibly quantized) weight's SHAPE."""
    return x["q"] if is_quant_leaf(x) else x


def dequant_leaf(x):
    """q·scale in float32 for a quant leaf (anything else passes through):
    the scale broadcasts over the input axis (-2), or elementwise where it
    has q's shape (a block's vector, quantized across the blocks)."""
    if not is_quant_leaf(x):
        return x
    q, scale = x["q"], x["scale"]
    if scale.dim() < q.dim():
        scale = scale.unsqueeze(-2)
    return q.float() * scale


def dequant_params(tree: Any) -> Any:
    """Every quant leaf of a params subtree (dicts, lists, tuples)
    dequantized; everything else as it was."""
    if is_quant_leaf(tree):
        return dequant_leaf(tree)
    if isinstance(tree, dict):
        return {k: dequant_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(dequant_params(v) for v in tree)
    return tree


def weight_operands(name: str, leaf, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, ...]:
    """A weight as a kernel launch takes it: (its values in the activation
    dtype,) or, for a quant leaf, (int8 values, float32 scales), each
    contiguous. Raises ValueError for a malformed quant leaf."""
    if not is_quant_leaf(leaf):
        return (leaf.to(dtype).contiguous(),)
    q, scale = leaf["q"], leaf["scale"]
    want = tuple(q.shape[:-2]) + tuple(q.shape[-1:])
    if q.dtype != torch.int8 or tuple(scale.shape) != want:
        raise ValueError(f"{name}: a quant leaf needs int8 q and a float32 "
                         f"scale of shape {want}; got {q.dtype} "
                         f"{tuple(q.shape)} and {tuple(scale.shape)}")
    return q.contiguous(), scale.float().contiguous()


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def int8_leg(name: str, x: torch.Tensor, plain: Callable, kernel: Callable,
             *args):
    """Run an int8 leg on `args` (x is its activation operand): `kernel` on
    a CUDA tensor (launch or raise), `plain` on the dequantized weights on
    a CPU tensor. Inference-only: ValueError if an input requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in _tensors(args)):
        raise ValueError(f"{name}: the int8 leg is inference-only (the "
                         "quantized serving arm never differentiates); an "
                         "input requires grad")
    if x.device.type == "cpu":
        return plain(*dequant_params(args))
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return kernel(*args)
