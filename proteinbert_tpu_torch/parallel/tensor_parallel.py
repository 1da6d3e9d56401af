"""The GO head's tensor parallelism over the mesh's `model` axis — what
the JAX rules ask of XLA when `model` divides the annotation dim A
(`sharding.leaf_spec`: `global_head` column-sharded, `global_in`'s
kernel row-sharded), done by hand over `torch.distributed`.

Model rank m holds columns [m·A/M, (m+1)·A/M) of the annotation dim:

- `global_in` runs row-parallel: the rank contracts its slice of the
  annotation columns with its rows of the kernel. The partial sums stay
  float32 (the products of the activation-dtype operands, exact in
  float32), are all-reduced over the model group, and only the sum is
  cast to the activation dtype before the bias is added — the points at
  which the single JAX matmul rounds. A partial rounded on each rank
  would round where JAX does not. The all-reduce's backward is the
  identity: every model rank receives the same output gradient.
- `global_head` runs column-parallel: the rank computes its columns of
  the logits and they are all-gathered, float32, over the model group,
  so the loss and the eval metrics read (B, A) as on one card. The
  gather's backward keeps this rank's columns. The head's input gradient
  is then this rank's columns' share, so the input passes through an
  identity whose backward all-reduces it over the model group
  (`_ToModelRanks`). The product runs in float32 on the
  activation-dtype operands and its result is cast once, so that share
  too stays float32 until the sum, which is cast once: where the single
  JAX matmul rounds, forward and backward.

Where `model` does not divide A (the `large` preset's own model=4 at A =
8943) the rules shard nothing over `model` and `TensorParallel.for_layout`
gives None: the model ranks then compute the same thing on the same rows,
as the JAX partitioner does.

The collectives go through the counted wrappers of `parallel/zero.py`.
"""

from __future__ import annotations

from typing import Optional

import torch

from proteinbert_tpu_torch.parallel.zero import all_gather, all_reduce


class _SumOverModel(torch.autograd.Function):
    """Forward: Σ over the model group (float32). Backward: identity."""

    @staticmethod
    def forward(ctx, x, tp):
        out = x.clone()
        all_reduce(out, tp.group, tp.registry)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToModelRanks(torch.autograd.Function):
    """Forward: identity. Backward: Σ of the gradient over the model
    group (each rank's columns contribute a share)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, ctx.tp.group, ctx.tp.registry)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """Forward: every rank's columns (last dim) into the whole. Backward:
    this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        n = tp.extent
        x = x.contiguous()
        out = x.new_empty(n * x.numel())
        all_gather(out, x.reshape(-1), tp.group, tp.registry)
        out = out.view((n,) + tuple(x.shape))
        return out.movedim(0, -2).reshape(*x.shape[:-1], n * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        cols = g.shape[-1] // tp.extent
        return g.narrow(-1, tp.index * cols, cols).contiguous(), None


class TensorParallel:
    """This rank's slice of the annotation dim and the model group."""

    def __init__(self, group, index: int, extent: int, num_annotations: int,
                 registry=None):
        self.group = group
        self.index = index
        self.extent = extent
        self.registry = registry
        self.cols = num_annotations // extent

    @classmethod
    def for_layout(cls, layout) -> Optional["TensorParallel"]:
        """The split of a `fsdp.MeshLayout` — None unless the rules shard
        `global_head` over `model`."""
        for p in layout.plans:
            if p.path[0] == "global_head" and p.store \
                    and p.store[0] == "model":
                mesh = layout.mesh
                return cls(mesh.model_group, mesh.coords["model"],
                           mesh.shape["model"], p.full_shape[-1],
                           layout.registry)
        return None

    def global_in(self, params, annotations: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
        """(…, A) annotations → (…, G) in `dtype`: this rank's columns
        against its rows of the kernel, the float32 partials summed over
        the model group, cast once, then the bias."""
        x = annotations.narrow(-1, self.index * self.cols, self.cols)
        w = params["kernel"].to(dtype).float()
        partial = x.to(dtype).float() @ w
        y = _SumOverModel.apply(partial, self).to(dtype)
        return y + params["bias"].to(dtype)

    def global_head(self, params, global_: torch.Tensor) -> torch.Tensor:
        """(…, G) → float32 (…, A) logits: this rank's columns, gathered
        over the model group."""
        dtype = global_.dtype
        g = _ToModelRanks.apply(global_.float(), self)
        w = params["kernel"].to(dtype).float()
        local = (g @ w).to(dtype) + params["bias"].to(dtype)
        return _GatherColumns.apply(local.float(), self)
