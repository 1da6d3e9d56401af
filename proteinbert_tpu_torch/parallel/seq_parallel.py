"""Explicit sequence-parallel model and train step over
`torch.distributed` — port of `proteinbert_tpu/parallel/seq_parallel.py`.

Each rank of the seq process group holds the same params and the same
batch, and runs the model on its L/world slice of every row:

- local track: one halo exchange a block (`parallel/halo.halo_exchange`,
  20 rows each side for the k=9/d=5 wide conv), then the prehaloed
  local-track kernel (`kernels.fused_local_track_valid`: K1's or #2's
  prehaloed entry on CUDA, its plain version on the CPU), called
  unconditionally as the JAX `_seq_block_apply` calls it on its Pallas
  path;
- global←local attention: a distributed softmax (`sharded_global_attention`).
  Each rank scores its own positions; the stop-gradient max is gathered
  with `all_gather`, and the exp-sum and exp·V are summed with an
  `all_reduce` that has a backward. The JAX function is plain einsums,
  not Pallas, so it stays plain PyTorch here;
- global track: replicated, computed identically on every rank.

Gradients — each is counted exactly once. Rank r's share of the loss is
`pretrain_loss(all local logits, global logits) / world`: the shares sum
to the loss. Every collective then has the adjoint of a sum over ranks
(`_AllReduceSum`: an all_reduce of the gradients; `_GatherSeq`: an
all_reduce of the gathered gradient, then this rank's slice; the halo
exchange: the halo gradients back to their owners), so rank r's backward
yields the gradient of its share with respect to every param it used.
The param gradients are then summed over the group with one all_reduce:
the params are tied across ranks, so the gradient of the loss is that
sum. (The alternative — every rank back-propagating the whole loss
through gathers whose backward sums — counts the local-track gradients
world times.) The JAX package gets the same gradients from shard_map's
transpose; `tests/test_torch_seq_parallel.py` holds both at world 2 and
4.

The seq × data mesh (JAX :216-299 on a `MeshConfig(data=d, seq=s)`
mesh): pass the `parallel.mesh.Mesh` too. Each data replica's seq group
then runs this step on that replica's rows (corrupted with the replica's
generator, the same on its seq ranks); the halo exchange and the
distributed softmax stay inside the seq group. The loss share keeps both
divisions — 1/seq for the seq ranks' shares, and the weight masses summed
across the replica group (data·fsdp) — so each gradient is still counted
once along both axes. The seq-summed gradients are then summed over the
data group (one flat all-reduce), or reduce-scattered over it under
`cfg.parallel.zero_update` when the replica extent is above 1 (ZeRO-1,
`parallel/zero.py`; "bf16" there is JAX's numerics-only cast, and "int8"
is refused with JAX's `QuantConfigError`).

On a mesh whose fsdp or model axis is above 1 as well (`mesh.sharded`;
JAX :187-299 on e.g. `MeshConfig(fsdp=2, seq=2)`, whose shard_map takes
the rules' sharded state as `P()` and splits the rows over data·fsdp),
the step keeps the state on the layout of `parallel/fsdp.py`
(`MeshLayout`, `step.layout_for`): each step cuts a full-shape state to
this rank's shards, corrupts the replica's rows, runs the model on the
params gathered whole (the FSDP shards over the fsdp group, the model
shards over the model group: no tensor parallelism inside the seq step),
sums the stored tensors' gradients over the seq group (the fsdp
reduce-scatter has already run in the gather's backward), reduces them
over the replica axis (`MeshLayout.reduce`, ZeRO-1's pieces under
`zero_update`, bf16 as JAX's cast of the reduced gradients) and updates
this rank's pieces (`fsdp.apply_update`).

Divergences from the JAX package: the caller's process groups select
this path (`pretrain(..., seq_group=g)` or a mesh with seq > 1); the
implicit-SPMD path has no counterpart, though the refusals keep the JAX
step's text word for word (the packed and int8 ones name
`model.use_pallas` and the implicit-SPMD jit). A group of size 1 (or
None) is allowed and makes no collective call. On the sharded layout
the FSDP and model shards are gathered by explicit collectives once a
step (the JAX partitioner places them for the shard_map), and the
gradient pieces come back through the fsdp reduce-scatter, the seq sum
and `MeshLayout.reduce` rather than the shard_map's transpose.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from proteinbert_tpu_torch.configs import ModelConfig, PretrainConfig
from proteinbert_tpu_torch.data.vocab import PAD_ID
from proteinbert_tpu_torch.kernels import (
    TRACK_PARAMS, fused_local_track_valid, track_halo,
)
from proteinbert_tpu_torch.models.proteinbert import (
    activation_dtype, cast_block, check_remat_policy,
)
from proteinbert_tpu_torch.ops.layers import (
    dense_apply, embedding_apply, gelu, layer_norm_apply,
)
from proteinbert_tpu_torch.parallel.halo import group_size, halo_exchange
from proteinbert_tpu_torch.parallel.quant import QuantConfigError
from proteinbert_tpu_torch.parallel.zero import (
    all_reduce_flat, layout_for, zero_extent, zero_gradient_update,
)
from proteinbert_tpu_torch.train import train_state as ts
from proteinbert_tpu_torch.train.loss import pretrain_loss_terms
from proteinbert_tpu_torch.train.schedule import (
    effective_lr, global_norm, make_optimizer, needs_loss_value,
)

Params = Dict[str, Any]


class _AllReduceSum(torch.autograd.Function):
    """Σ over the group, on every rank; the backward sums the gradients
    the same way (each rank's copy of the sum fed its own loss share)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherSeq(torch.autograd.Function):
    """The (B, L_shard, ...) slices of all ranks, concatenated in rank
    order along dim 1; the backward takes this rank's slice of the
    gradient summed over the group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(dist.get_world_size(ctx.group), dim=1)[
            dist.get_rank(ctx.group)], None


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The full-length tensor from every rank's (B, L_shard, ...) slice
    (differentiable, see `_GatherSeq`)."""
    return x if group_size(group) == 1 else _GatherSeq.apply(x, group)


def sharded_global_attention(
    params: Params, local: torch.Tensor, global_: torch.Tensor,
    pad_mask: torch.Tensor, group=None,
) -> torch.Tensor:
    """The dense global attention (`ops/attention.global_attention_apply`)
    over a seq-sharded local track, as a distributed softmax: local
    (B, L_shard, C), global_ (B, G), pad_mask (B, L_shard) → (B, G) in
    local's dtype, the same on every rank. Rounding points of the JAX
    `sharded_global_attention` (seq_parallel.py:62-100)."""
    dtype = local.dtype
    wq, wk, wv = (params[n].to(dtype) for n in ("wq", "wk", "wv"))
    key_dim = wq.shape[-1]

    q = torch.tanh(torch.einsum("bg,hgk->bhk", global_, wq))
    k = torch.tanh(torch.einsum("blc,hck->bhlk", local, wk))
    v = gelu(torch.einsum("blc,hcv->bhlv", local, wv))

    scores = torch.einsum("bhk,bhlk->bhl", q, k) / torch.tensor(
        math.sqrt(key_dim), dtype=dtype)
    scores = scores.float().masked_fill(~pad_mask[:, None, :], -1e30)

    # The global max stabilizer carries no gradient (shift-invariant).
    m = scores.detach().amax(dim=-1)  # (B, H)
    if group_size(group) > 1:
        maxes = [torch.empty_like(m) for _ in range(dist.get_world_size(group))]
        dist.all_gather(maxes, m, group=group)
        m = torch.stack(maxes).amax(dim=0)
    e = torch.exp(scores - m[..., None])                       # (B, H, Ls)
    denom = _all_reduce_sum(e.sum(dim=-1), group)              # (B, H)
    num = _all_reduce_sum(
        torch.einsum("bhl,bhlv->bhv", e.to(dtype), v), group)  # (B, H, v)
    out = num / denom[..., None].clamp_min(1e-30).to(dtype)
    b, h, vd = out.shape
    return out.reshape(b, h * vd)


def _seq_block_apply(
    params: Params, local: torch.Tensor, global_: torch.Tensor,
    pad_mask: torch.Tensor, cfg: ModelConfig, group,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """models/proteinbert.block_apply on one seq shard."""
    track = {k: params[k] for k in TRACK_PARAMS}
    broadcast = gelu(dense_apply(params["global_to_local"], global_))
    H = track_halo(track, 1, cfg.wide_dilation)
    xh = halo_exchange(local, H, group)
    local = fused_local_track_valid(track, xh, broadcast, 1,
                                    cfg.wide_dilation)

    dense1 = gelu(dense_apply(params["global_dense1"], global_))
    attn = sharded_global_attention(params["attention"], local, global_,
                                    pad_mask, group)
    global_ = layer_norm_apply(params["global_ln1"], global_ + dense1 + attn)
    global_ = layer_norm_apply(
        params["global_ln2"],
        global_ + gelu(dense_apply(params["global_dense2"], global_)))
    return local, global_


def seq_parallel_apply(
    group, params: Params, tokens: torch.Tensor, annotations: torch.Tensor,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass of this rank's sequence shard — the JAX
    `_shard_forward` body, which `seq_parallel_apply` runs under
    shard_map there: tokens (B, L_shard), the rank's slice of the rows in
    rank order, annotations (B, A) → (local_logits (B, L_shard, V),
    global_logits (B, A)), float32. The attention mask is tokens !=
    PAD_ID, as in the JAX function."""
    dtype = activation_dtype(cfg)
    pad_mask = tokens != PAD_ID
    local = embedding_apply(params["embedding"], tokens, dtype)
    global_ = gelu(dense_apply(params["global_in"], annotations.to(dtype)))
    check_remat_policy(cfg)
    for blk in params["blocks"]:
        local, global_ = _seq_block_apply(cast_block(blk, dtype), local,
                                          global_, pad_mask, cfg, group)
    local_logits = dense_apply(params["local_head"], local).float()
    global_logits = dense_apply(params["global_head"], global_).float()
    return local_logits, global_logits


def seq_parallel_loss_and_grads(
    group, params: Params, X, Y, W, cfg: PretrainConfig, replica_group=None,
    registry=None,
    forward_params: Optional[Callable[[Params], Params]] = None,
):
    """This rank's forward on its slice of the corrupted dense rows (X, Y,
    W — the replica's rows, the same on every rank of the seq group), the
    port's `pretrain_loss` terms on the gathered local logits, the
    backward of this rank's share and the sum of the param gradients over
    the seq group → (grads aligned with `tree_leaves(params)`, the loss
    metrics). With a `replica_group` the share's weight masses, and the
    metrics, are the global batch's (summed over the replicas, data·fsdp).
    `forward_params(params)` gives the tree the model reads (the sharded
    layout's gathered params); the gradients are then those of `params`.
    ValueError if L % world != 0."""
    world = group_size(group)
    L = X["local"].shape[1]
    if L % world:
        raise ValueError(f"sequence length {L} does not split over "
                         f"{world} seq ranks")
    rank = 0 if group is None else dist.get_rank(group)
    rows = slice(rank * L // world, (rank + 1) * L // world)
    out = {}

    def share():
        local_logits, global_logits = seq_parallel_apply(
            group, params if forward_params is None
            else forward_params(params), X["local"][:, rows], X["global"],
            cfg.model)
        nums, dens = pretrain_loss_terms(gather_seq(local_logits, group),
                                         global_logits, Y, W)
        loss, out["metrics"] = ts.global_loss_share(nums, dens,
                                                    replica_group, registry)
        return loss / world, {}

    grads, _ = ts.grads_of(params, share)
    if world > 1:
        grads = all_reduce_flat(grads, group, registry)
    return grads, {k: v.detach() for k, v in out["metrics"].items()}


def make_seq_parallel_train_step(
    group, cfg: PretrainConfig, mesh=None, registry=None,
) -> Callable[..., Tuple[ts.TrainState, Dict[str, torch.Tensor]]]:
    """`step(state, batch) → (state, metrics)`, the pretraining step whose
    forward runs `seq_parallel_apply` on this rank's slice. Every rank of
    the seq group passes the same state and the same CLEAN dense rows:
    the step corrupts them once (with the state's generator, or under a
    `mesh` with data replicas the replica's generator — identically on
    the group), then `seq_parallel_loss_and_grads`, then the gradients'
    sum over the mesh's data group (or ZeRO-1's reduce-scatter) and the
    update. On a `mesh.sharded` mesh the state lives on the layout of
    `parallel/fsdp.py` (module docstring): the step takes a full-shape
    state on its first call and returns this rank's, and
    `step.layout_for(state)` gives the layout. The metrics are the
    global batch's, the same on every rank; `registry` receives the
    gradient reductions' comm accounting. Refuses packed batches
    (NotImplementedError), an int8 ZeRO reduction (QuantConfigError, as
    the JAX step does) and L % world != 0 (ValueError)."""
    if cfg.parallel.zero_update and cfg.parallel.grad_reduce_dtype == "int8":
        raise QuantConfigError(
            "grad_reduce_dtype='int8' is not supported by the explicit "
            "sequence-parallel Pallas step: the quantized reduce-"
            "scatter needs per-replica partial gradients from its own "
            "data-parallel shard_map, which this hand-sharded path "
            "cannot provide. Disable model.use_pallas (the implicit-"
            "SPMD jit cannot quantize either — use a data/fsdp mesh), "
            "or keep grad_reduce_dtype to 'fp32'/'bf16' here.")
    zero_on = (mesh is not None and cfg.parallel.zero_update
               and zero_extent(mesh) > 1)
    if mesh is not None and mesh.sharded:
        return _sharded_step(group, cfg, mesh, zero_on, registry)
    data_group = None if mesh is None else mesh.data_group
    cache: Dict[str, Any] = {}

    def step(state: ts.TrainState, batch: Dict[str, Any]):
        _refuse_packed(batch)
        X, Y, W, _ = ts.corrupt_for_step(
            state, batch, cfg,
            None if mesh is None else ts.replica_generator(state, mesh))
        grads, metrics = seq_parallel_loss_and_grads(
            group, state.params, X, Y, W, cfg,
            None if mesh is None else mesh.replica_group, registry)
        if zero_on:
            opt_state, metrics["grad_norm"] = zero_gradient_update(
                layout_for(cache, mesh, state.params), cfg.optimizer, grads,
                state.opt_state, metrics["loss"],
                grad_reduce_dtype=cfg.parallel.grad_reduce_dtype,
                registry=registry)
            params = state.params
        else:
            grads = all_reduce_flat(grads, data_group, registry)
            metrics["grad_norm"] = global_norm(grads)
            params, opt_state = ts.gradient_update(
                make_optimizer(cfg.optimizer), state.params, grads,
                state.opt_state, metrics["loss"],
                needs_loss_value(cfg.optimizer))
        metrics["lr"] = effective_lr(cfg.optimizer, opt_state, state.step)
        return ts.TrainState(state.step + 1, params, opt_state,
                             state.generator), metrics

    return step


def _refuse_packed(batch: Dict[str, Any]) -> None:
    if "segment_ids" in batch:
        # The JAX step's text, word for word.
        raise NotImplementedError(
            "packed batches (data.packing) are not supported by the "
            "explicit sequence-parallel Pallas step: the fused kernel "
            "has no segment-boundary support yet (its guard falls "
            "back to XLA, which this hand-sharded path cannot use). "
            "Disable model.use_pallas (the implicit-SPMD jit "
            "seq-shards the boundary-masked packed model fine) or "
            "turn packing off.")


def _sharded_step(group, cfg: PretrainConfig, mesh, zero_on: bool,
                  registry=None):
    """The step of `make_seq_parallel_train_step` on a `mesh.sharded`
    mesh (module docstring): the state on `fsdp.MeshLayout`, the params
    gathered whole for the forward, the gradients summed over the seq
    group, then `MeshLayout.reduce` and `fsdp.apply_update`."""
    from proteinbert_tpu_torch.parallel.fsdp import (
        apply_update, layout_getter,
    )

    layout_for = layout_getter(mesh, zero_on, registry)
    cast_bf16 = zero_on and cfg.parallel.grad_reduce_dtype == "bf16"

    def step(state: ts.TrainState, batch: Dict[str, Any]):
        _refuse_packed(batch)
        layout = layout_for(state)
        state = layout.shard_state(state)
        X, Y, W, _ = ts.corrupt_for_step(state, batch, cfg,
                                         ts.replica_generator(state, mesh))
        grads, metrics = seq_parallel_loss_and_grads(
            group, state.params, X, Y, W, cfg, mesh.replica_group, registry,
            lambda p: layout.forward_params(p, gather_model=True))
        pieces, norm = layout.reduce(grads, cast_bf16)
        return apply_update(layout, cfg, state, pieces, norm, metrics)

    step.layout_for = layout_for
    return step
