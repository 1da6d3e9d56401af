"""Gradients of the kernel wrappers under the JAX package's memory contract.

Each kernel the port replaces is a `jax.custom_vjp` in the JAX package
(fused_block.py `_fwd`/`_bwd`, `_fwd_segments`/`_bwd_segments` and
`_fwd_valid`/`_bwd_valid`, attention.py `_fwd_attention`/`_bwd_attention`,
one_pass.py `_fwd_onepass`/`_bwd_onepass`): the forward runs the kernel
and saves only its inputs; the backward recomputes the XLA reference
composition and differentiates it, like a rematerialised
(`jax.checkpoint`) block. There is no backward kernel, so the backward's
products and convolutions are plain PyTorch, as the JAX package leaves
them to XLA.

`recompute_vjp(run, backward_ref, *args)` is that contract as one
`torch.autograd.Function`. `run` is the forward it executes — the
hand-written kernel for CUDA tensors, the kernel-rounding plain version
for CPU tensors. `backward_ref` is the port of the JAX XLA reference the
JAX VJP differentiates (`local_track_grad_reference` and its kin): it
runs its convs and products in the activation dtype, with float32
LayerNorm statistics only, so a bf16 step's gradients are the JAX
step's, not those of a float32 recompute. (The kernel-rounding plain
versions widen every operand to float32; in float32 the two agree.)
`args` may nest tensors in dicts, lists and tuples (the params trees) and
carry ints, bools and None; the tensors become the Function's inputs and
everything else rides along unchanged. Integer tensors (segment ids) and
tensors that need no gradient (one-hots, masks) get None.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


class _Leaf:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _strip(t: Any, leaves: List[torch.Tensor]) -> Any:
    if isinstance(t, torch.Tensor):
        leaves.append(t)
        return _Leaf(len(leaves) - 1)
    if isinstance(t, dict):
        return {k: _strip(v, leaves) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_strip(v, leaves) for v in t)
    return t


def _put(s: Any, new_leaves: List[torch.Tensor]) -> Any:
    if isinstance(s, _Leaf):
        return new_leaves[s.index]
    if isinstance(s, dict):
        return {k: _put(v, new_leaves) for k, v in s.items()}
    if isinstance(s, (list, tuple)):
        return type(s)(_put(v, new_leaves) for v in s)
    return s


def _split(tree: Any) -> Tuple[List[torch.Tensor], Callable]:
    """(tensor leaves, fill) where fill(new_leaves) rebuilds `tree` with
    the leaves replaced in order. The recursion is module-level: a nested
    function that calls itself is a reference cycle, which would keep the
    leaves it captured alive until the garbage collector runs."""
    leaves: List[torch.Tensor] = []
    skeleton = _strip(tree, leaves)
    return leaves, lambda new_leaves: _put(skeleton, new_leaves)


class _Recompute(torch.autograd.Function):
    """Forward: `run` on the inputs, saving only the inputs. Backward:
    `backward_ref` recomputed on detached inputs under grad mode,
    differentiated with `torch.autograd.grad` for the inputs that need a
    gradient."""

    @staticmethod
    def forward(ctx, run, backward_ref, fill, *leaves):
        ctx.backward_ref, ctx.fill = backward_ref, fill
        ctx.save_for_backward(*leaves)
        return run(*fill(leaves))

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.backward_ref(*ctx.fill(inputs))
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True))
        return (None, None, None) + tuple(next(got) if n else None
                                          for n in need)


def recompute_vjp(run: Callable, backward_ref: Callable, *args):
    """`run(*args)`, differentiable through `backward_ref(*args)`
    recomputed in the backward. `run` and `backward_ref` take the same
    arguments and compute the same function (a tensor or a tuple of
    tensors), `backward_ref` at the rounding points of the JAX XLA
    reference. With grad mode off (serving runs under
    `torch.inference_mode`) there is no graph to build, so `run` is
    called directly, without the Function's host cost."""
    if not torch.is_grad_enabled():
        return run(*args)
    leaves, fill = _split(args)
    return _Recompute.apply(run, backward_ref, fill, *leaves)
