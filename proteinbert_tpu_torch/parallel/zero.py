"""ZeRO-1 cross-replica sharded weight update (arXiv:2004.13336) — port of
`proteinbert_tpu/parallel/zero.py` over `torch.distributed`.

Data parallelism replicates the params and both Adam moments on every
data rank and runs the same update d times. ZeRO-1 shards the update:

  reduce-scatter the per-rank partial gradients over the data group
                                 (each rank receives the sum of ITS shard)
  apply the optimizer to that 1/d shard      (mu / nu persist at 1/d)
  all-gather the updated params IN PLACE     (the params keep their
                                 storage: served and captured paths bake
                                 tensor addresses)

Which dim of a leaf is sharded is the JAX rule (`sharding.zero_dim`,
from `zero_update_spec`); a leaf the rule leaves whole is all-reduced and
updated whole on every rank. `ZeroLayout` lays the sharded leaves out in
one flat buffer in which rank r's slice of every leaf is contiguous, so
each step makes ONE `reduce_scatter_tensor` and ONE
`all_gather_into_tensor`, plus one small all-reduce (the whole leaves
and the shards' sum of squares).

The clip norm is the true global norm: the squares of the reduced shards
summed, all-reduced, plus the squares of the whole leaves once (JAX
quant.py:405-417); `metrics["grad_norm"]` is that norm. The optimizer
is the port's own `schedule.Optimizer` on the shards, given that norm;
weight decay reads the params' shard; the plateau scalars are
replicated (every rank observes the same global loss).

Checkpoints stay interchangeable with the replicated mode (JAX
zero.py:48-51): the `Checkpointer` gathers the moments to full shape
before a write (`gather_full`) and slices the full moments to this
rank's shard on restore, so a step file is the same whoever wrote it.

Comm accounting: the port has no HLO to read, so every collective of the
training steps goes through the counted wrappers below, which add the
call's output bytes and its per-rank wire bytes (the ring factors of the
JAX `collective_wire_bytes_from_hlo`) to a metrics registry as
`collective_bytes{kind=...}` and `collective_wire_bytes{kind=...}` —
the names the JAX `record_comm_metrics` exports.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from proteinbert_tpu_torch.parallel.sharding import leaf_paths, zero_dim
from proteinbert_tpu_torch.train.schedule import (
    OptState, effective_lr, make_optimizer, needs_loss_value, tree_leaves,
)

ZERO_AXES = ("data", "fsdp")

_REDUCE_DTYPES = ("fp32", "bf16")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def zero_extent(mesh) -> int:
    """Replicas the weight update is sharded across (data x fsdp)."""
    n = 1
    for ax in ZERO_AXES:
        n *= mesh.shape.get(ax, 1)
    return n


# ------------------------------------------------------- comm accounting

def wire_bytes(kind: str, out_bytes: int, n: int) -> int:
    """Per-rank wire bytes of one collective over `n` ranks whose output
    is `out_bytes` (ring algorithm; the JAX formulas):

      all-reduce      2(n-1)/n x out
      reduce-scatter  (n-1)   x out
      all-gather      (n-1)/n x out
      all-to-all      (n-1)/n x out
      collective-permute       out"""
    if kind == "all-reduce":
        return 2 * out_bytes * (n - 1) // max(n, 1)
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * (n - 1) // max(n, 1)
    return out_bytes


def count_collective(registry, kind: str, out_bytes: int, n: int) -> None:
    """Add one call to `registry`'s collective_bytes / collective_wire_bytes
    counters (no-op for None)."""
    if registry is None:
        return
    registry.counter("collective_bytes", kind=kind).inc(out_bytes)
    registry.counter("collective_wire_bytes", kind=kind).inc(
        wire_bytes(kind, out_bytes, n))


def comm_bytes(registry) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(output bytes, wire bytes) by kind, each with a "total", as counted
    in `registry` so far."""
    out = {k: registry.counter("collective_bytes", kind=k).value
           for k in COLLECTIVES}
    wire = {k: registry.counter("collective_wire_bytes", kind=k).value
            for k in COLLECTIVES}
    out["total"] = sum(out[k] for k in COLLECTIVES)
    wire["total"] = sum(wire[k] for k in COLLECTIVES)
    return out, wire


def grad_reduce_wire_bytes(wire: Dict[str, float]) -> float:
    """The gradient-reduction share of a wire-bytes breakdown (the
    collectives a gradient reduction makes: reduce-scatter, all-reduce,
    all-to-all) — the number the int8-vs-fp32 ratio compares."""
    return (wire["reduce-scatter"] + wire["all-reduce"]
            + wire["all-to-all"])


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, registry=None) -> torch.Tensor:
    """Σ over `group`, in place (no-op without a group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
        count_collective(registry, "all-reduce", t.nbytes, _size(group))
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group,
                   registry=None) -> torch.Tensor:
    dist.reduce_scatter_tensor(out, inp, group=group)
    count_collective(registry, "reduce-scatter", out.nbytes, _size(group))
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor, group,
               registry=None) -> torch.Tensor:
    dist.all_gather_into_tensor(out, inp, group=group)
    count_collective(registry, "all-gather", out.nbytes, _size(group))
    return out


def all_to_all(out: torch.Tensor, inp: torch.Tensor, group,
               registry=None) -> torch.Tensor:
    dist.all_to_all_single(out, inp, group=group)
    count_collective(registry, "all-to-all", out.nbytes, _size(group))
    return out


def all_reduce_flat(tensors: Sequence[torch.Tensor], group,
                    registry=None) -> List[torch.Tensor]:
    """Σ over `group` of every tensor, in place, with ONE all-reduce of one
    flat float32 buffer; returns the tensors. The sums are copied back
    into the inputs, so what follows reads the same tensors as a one-rank
    run (a reduction over a view of another alignment may round
    differently)."""
    tensors = list(tensors)
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce(flat, group, registry)
    for t, f in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(f.view_as(t))
    return tensors


# --------------------------------------------------------------- layout

def _split_dim(shard: Sequence[int], full: Sequence[int]) -> Optional[int]:
    diff = [i for i, (a, b) in enumerate(zip(shard, full)) if a != b]
    return diff[0] if diff else None


def _gather_into(dsts: Sequence[torch.Tensor], shards: Sequence[torch.Tensor],
                 dims: Sequence[int], group, registry=None) -> None:
    """Write every rank's shard of each leaf into the full tensors `dsts`
    (dst i is sharded along dims[i]) with one all_gather_into_tensor of a
    flat buffer in which each rank's shards are contiguous."""
    d = _size(group)
    moved = [s.movedim(dim, 0) for s, dim in zip(shards, dims)]
    sizes = [s.numel() for s in shards]
    seg = torch.cat([m.reshape(-1).float() for m in moved])
    big = seg.new_empty(d * seg.numel())
    all_gather(big, seg, group, registry)
    rows = big.view(d, -1)
    off = 0
    for dst, m, n, dim in zip(dsts, moved, sizes, dims):
        src = rows[:, off:off + n].reshape(d, *m.shape)
        dst.movedim(dim, 0).unflatten(0, (d, m.shape[0])).copy_(src)
        off += n


def gather_full(shards: Sequence[torch.Tensor],
                full_shapes: Sequence[Sequence[int]], group,
                registry=None) -> List[torch.Tensor]:
    """Each tensor at its full shape: a tensor whose shape equals its full
    shape is returned as is; the others are this rank's shards along the
    one dim where the shapes differ, gathered from the group (collective:
    every rank calls it with the same shapes)."""
    out = list(shards)
    idx = [i for i, (s, f) in enumerate(zip(shards, full_shapes))
           if tuple(s.shape) != tuple(f)]
    if not idx:
        return out
    dims = [_split_dim(shards[i].shape, full_shapes[i]) for i in idx]
    dsts = [shards[i].new_empty(tuple(full_shapes[i])) for i in idx]
    _gather_into(dsts, [shards[i] for i in idx], dims, group, registry)
    for i, t in zip(idx, dsts):
        out[i] = t
    return out


def shard_of(full: torch.Tensor, shard_shape: Sequence[int], index: int,
             d: int) -> torch.Tensor:
    """Rank `index`'s contiguous shard (of `d`) of `full` along the one dim
    where `shard_shape` differs — `full` itself when no dim differs or the
    differing dim is not d shards of `shard_shape`'s."""
    dim = _split_dim(shard_shape, full.shape)
    if dim is None or full.shape[dim] != d * shard_shape[dim]:
        return full
    n = shard_shape[dim]
    return full.narrow(dim, index * n, n).clone(
        memory_format=torch.contiguous_format)


class ZeroLayout:
    """How one params tree shards over the replica axis of `mesh`: each
    leaf's ZeRO dim (or None), this rank's views of the params (its shard
    of a sharded leaf, the whole of the others), and the flat layout of
    the reduce-scatter, in which rank r's slice of every sharded leaf is
    contiguous."""

    def __init__(self, mesh, params):
        self.params = params
        self.group = mesh.replica_group
        self.d = mesh.data_extent
        self.index = mesh.data_index
        leaves = list(leaf_paths(params))
        self.leaves = [t for _, t in leaves]
        self.dims = [zero_dim(path, tuple(t.shape), mesh.shape)
                     for path, t in leaves]
        self.sharded = [i for i, dim in enumerate(self.dims)
                        if dim is not None]
        self.whole = [i for i, dim in enumerate(self.dims) if dim is None]
        self.views = list(self.leaves)
        self.moved_shape = {}
        self.offsets = {}
        off = 0
        for i in self.sharded:
            t, dim = self.leaves[i], self.dims[i]
            n = t.shape[dim] // self.d
            self.views[i] = t.narrow(dim, self.index * n, n)
            self.moved_shape[i] = (n,) + tuple(
                s for j, s in enumerate(t.shape) if j != dim)
            self.offsets[i] = off
            off += t.numel() // self.d
        self.seg_numel = off

    def slices(self, g: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's full-shape tensor `g` as (d, m): row r is rank r's
        slice, flattened in the moved layout."""
        return g.movedim(self.dims[i], 0).reshape(self.d, -1)

    def shard_view(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's shard from a flat segment in the moved layout, as a
        view shaped like this rank's params view of the leaf."""
        off = self.offsets[i]
        n = self.leaves[i].numel() // self.d
        return flat[off:off + n].view(self.moved_shape[i]).movedim(
            0, self.dims[i])

    def shard_opt_state(self, opt_state: OptState) -> OptState:
        """The moments at this rank's shard shape (a fresh or restored
        state carries them whole; already-sharded ones pass through)."""
        def cut(ts):
            return [shard_of(t, v.shape, self.index, self.d)
                    for t, v in zip(ts, self.views)]

        return OptState(opt_state.count, cut(opt_state.mu),
                        cut(opt_state.nu), opt_state.plateau)

    def reduce_scatter(self, partials: Sequence[torch.Tensor],
                       registry=None, cast_bf16: bool = False):
        """fp32 reduce-scatter of per-rank partial gradients → (gradients
        aligned with `views` — this rank's summed shards and the summed
        whole leaves —, the global norm). `cast_bf16` rounds the reduced
        gradients to bf16 and back (JAX's numerics-only bf16 reduction,
        zero.py:126-128)."""
        buf = torch.empty(self.d, self.seg_numel, dtype=torch.float32,
                          device=partials[0].device)
        for i in self.sharded:
            off = self.offsets[i]
            buf[:, off:off + self.leaves[i].numel() // self.d].copy_(
                self.slices(partials[i], i))
        seg = buf.new_empty(self.seg_numel)
        reduce_scatter(seg, buf.view(-1), self.group, registry)
        shards = {i: self.shard_view(seg, i) for i in self.sharded}
        return self.finish(partials, shards, registry, cast_bf16)

    def finish(self, partials, shards: Dict[int, torch.Tensor],
               registry=None, cast_bf16: bool = False):
        """The reduction's common tail: one all-reduce of the whole leaves
        and the shards' sum of squares → (gradients, the global norm)."""
        sq = torch.zeros(1, dtype=torch.float32, device=partials[0].device)
        for s in shards.values():
            sq += (s.float() ** 2).sum()
        *whole, sq = all_reduce_flat([partials[i] for i in self.whole]
                                     + [sq], self.group, registry)
        whole = dict(zip(self.whole, whole))
        for g in whole.values():
            sq = sq + (g ** 2).sum()
        norm = torch.sqrt(sq[0])
        grads = [shards[i] if i in shards else whole[i]
                 for i in range(len(self.leaves))]
        if cast_bf16:
            grads = [g.bfloat16().float() for g in grads]
        return grads, norm

    def all_gather_params(self, registry=None) -> None:
        """Every rank's updated shards into the params, in place."""
        if self.sharded:
            _gather_into([self.leaves[i] for i in self.sharded],
                         [self.views[i] for i in self.sharded],
                         [self.dims[i] for i in self.sharded],
                         self.group, registry)


def layout_for(cache: Dict[str, Any], mesh, params) -> ZeroLayout:
    """The layout of `params`, rebuilt when the step is handed another
    params tree than last time."""
    lay = cache.get("layout")
    if lay is None or lay.params is not params:
        lay = cache["layout"] = ZeroLayout(mesh, params)
    return lay


def zero_apply(layout: ZeroLayout, opt_cfg, grads: List[torch.Tensor],
               opt_state: OptState, value: Any, grad_norm: torch.Tensor,
               registry=None) -> OptState:
    """The optimizer on this rank's shards (clipped by the known global
    norm), then the params all-gathered in place → the sharded state."""
    opt_state = layout.shard_opt_state(opt_state)
    tx = make_optimizer(opt_cfg)
    with torch.no_grad():
        updates, opt_state = tx.update(
            grads, opt_state, layout.views,
            value=value if needs_loss_value(opt_cfg) else None,
            grad_norm=grad_norm)
        torch._foreach_add_(layout.views, updates)
    layout.all_gather_params(registry)
    return opt_state


def zero_gradient_update(
    layout: ZeroLayout, opt_cfg, partials: Sequence[torch.Tensor],
    opt_state: OptState, value: Any = None, *,
    grad_reduce_dtype: str = "fp32", registry=None,
) -> Tuple[OptState, torch.Tensor]:
    """ZeRO-1 update from per-rank PARTIAL gradients (Σ over the replica
    group = the gradient) → (the sharded opt_state, the global norm). The
    params of `layout` are updated in place. grad_reduce_dtype "bf16"
    rounds the reduced gradients (numerics only: the wire moves fp32 —
    the explicit seq-parallel step's route, as in JAX); the wire-
    compressing reduction is `quant.make_quant_zero_train_step`."""
    if grad_reduce_dtype not in _REDUCE_DTYPES:
        raise ValueError(
            f"unknown grad_reduce_dtype {grad_reduce_dtype!r}; "
            f"expected one of {_REDUCE_DTYPES}")
    grads, norm = layout.reduce_scatter(
        partials, registry, cast_bf16=grad_reduce_dtype == "bf16")
    opt_state = zero_apply(layout, opt_cfg, grads, opt_state, value, norm,
                           registry)
    return opt_state, norm


def make_zero_train_step(mesh, cfg, registry=None):
    """`step(state, batch, plateau_value=None) → (state, metrics)`: the
    data-parallel step (`train_state.corrupt_replica_grads`) with the
    ZeRO-1 update — the trainer's choice when cfg.parallel.zero_update
    and zero_extent(mesh) > 1. grad_reduce_dtype "bf16" / "int8" routes
    to the quantized reduce-scatter (`quant.make_quant_zero_train_step`).
    The params are updated in place and the moments kept at the shard
    shape; `registry` receives the comm accounting."""
    if cfg.parallel.grad_reduce_dtype != "fp32":
        from proteinbert_tpu_torch.parallel.quant import (
            make_quant_zero_train_step,
        )

        return make_quant_zero_train_step(mesh, cfg, registry=registry)
    from proteinbert_tpu_torch.train import train_state as ts

    cache: Dict[str, Any] = {}

    def step(state, batch, plateau_value=None):
        partials, metrics = ts.corrupt_replica_grads(state, batch, cfg, mesh,
                                                     registry)
        value = ts.plateau_observation(cfg.optimizer, metrics, plateau_value)
        opt_state, metrics["grad_norm"] = zero_gradient_update(
            layout_for(cache, mesh, state.params), cfg.optimizer, partials,
            state.opt_state, value, registry=registry)
        metrics["lr"] = effective_lr(cfg.optimizer, opt_state, state.step)
        return ts.TrainState(state.step + 1, state.params, opt_state,
                             state.generator), metrics

    return step


def per_chip_state_bytes(mesh, state, zero_update: bool = False
                         ) -> Dict[str, int]:
    """Per-rank persistent bytes of the train state under the rules —
    {'params', 'opt_state', 'other', 'total'}, from shapes alone (the JAX
    function's 'params' and 'opt_state' moments): each param at its
    storage shard (`sharding.param_spec`: its fsdp or model shard), each
    Adam moment at its ZeRO-1 shard under `zero_update`
    (`zero_update_spec`), else at the param's; plus the plateau scalars.
    A sharded state (`TrainState.layout`) is read at its full shapes."""
    from proteinbert_tpu_torch.parallel.sharding import (
        param_spec, shard_shape, zero_update_spec,
    )

    layout = getattr(state, "layout", None)
    params = state.params if layout is None else layout.full_meta()
    sizes = {"params": 0, "opt_state": 0, "other": 0}
    for path, t in leaf_paths(params):
        shape = tuple(t.shape)
        store = param_spec(path, shape, mesh.shape)
        moment = (zero_update_spec(path, shape, mesh.shape) if zero_update
                  else store)
        for part, spec, times in (("params", store, 1),
                                  ("opt_state", moment, 2)):
            n = 1
            for d in shard_shape(shape, spec, mesh.shape):
                n *= d
            sizes[part] += times * n * t.element_size()
    plateau = state.opt_state.plateau or {}
    sizes["opt_state"] += sum(v.numel() * v.element_size()
                              for v in plateau.values())
    sizes["total"] = sizes["params"] + sizes["opt_state"] + sizes["other"]
    return sizes


def moments_full(opt_state: OptState, params, group,
                 registry=None) -> OptState:
    """The moments at the params' shapes (sharded ones gathered from
    `group`; collective) — what a checkpoint holds."""
    shapes = [tuple(t.shape) for t in tree_leaves(params)]
    return OptState(opt_state.count,
                    gather_full(opt_state.mu, shapes, group, registry),
                    gather_full(opt_state.nu, shapes, group, registry),
                    opt_state.plateau)
