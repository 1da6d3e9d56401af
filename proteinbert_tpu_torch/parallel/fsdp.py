"""FSDP placement and the sharded training step on a data × fsdp × model
mesh — what XLA's SPMD partitioner does for the JAX package when the
`fsdp` or `model` axis of the mesh is above 1 (`proteinbert_tpu/parallel/
sharding.py`'s rules under `jax.jit`), done by hand over
`torch.distributed`.

`MeshLayout` plans every leaf of the params tree from the rules
(`sharding.param_spec`, `zero_update_spec`) and this rank's coordinates:

- storage: between steps a rank keeps only its shard of a leaf the rule
  lays out — its `fsdp` shard (a contiguous 1/fsdp of one dim) or its
  `model` shard (a 1/model of the annotation dim, `tensor_parallel.py`);
  the other leaves whole;
- the forward all-gathers the FSDP shards over the fsdp group, once a
  step and all leaves together (`_FsdpGather`, one flat
  `all_gather_into_tensor`); its backward reduce-scatters the gradients
  back to the shards (one flat `reduce_scatter_tensor`). The gathered
  params live from the forward to the end of the backward, as autograd
  keeps what the matmuls and convs saved;
- the gradients: an FSDP shard's, already summed over `fsdp`, is summed
  over `data`; a whole or model-sharded leaf's over the joint replica
  axis (data·fsdp); then every leaf the model axis does not shard is
  averaged over `model` (one flat all-reduce, divided by `model`): the
  model ranks see the same rows and compute the same gradients up to the
  card's nondeterministic reductions (cuDNN's conv backward), and the
  average keeps their replicated leaves bit for bit the same;
- ZeRO-1 (`cfg.parallel.zero_update`): the moments sit at the
  `zero_update_spec` shard — the fsdp shard cut again over `data` where
  the rule widens 'fsdp' to the joint axis or adds 'data'; a whole or
  model-sharded leaf cut over the joint axis where the rule puts it
  there. The gradient reduction then reduce-scatters into that piece,
  the optimizer updates it, and an all-gather writes the pieces back
  into the stored shard in place. A piece of an fsdp shard is cut from
  THIS rank's shard (rank (d, f) holds piece f·data + d of the dim, where
  the JAX joint axis orders it d·fsdp + f): the same shard size, and no
  byte moves that the shard does not hold;
- the clip norm: every element of every full gradient counted once (the
  ranks whose other coordinates are 0 add their piece's squares), one
  scalar all-reduce over the mesh, the same on every rank;
- a `seq` axis (the sequence-parallel step of `parallel/seq_parallel.py`
  on this layout): the rules ignore it, so the seq ranks of a coordinate
  store the same shards. That step reads the params with the model
  shards gathered too (`forward_params(gather_model=True)`, as the JAX
  shard_map takes them whole, `P()`), sums the stored tensors' gradients
  over the seq group before `reduce`, and the norm counts a piece on the
  seq rank 0 only.

Every collective goes through the counted wrappers of `parallel/zero.py`
(`collective_bytes{kind}`, `collective_wire_bytes{kind}`). The step's
state carries the layout (`TrainState.layout`): the checkpointer gathers
a full-shape state through it before rank 0 writes, and slices a
full-shape step file through it on restore (`full_state`, `local_of`,
`piece_of`), so a step file is the same whatever layout wrote it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from proteinbert_tpu_torch.parallel.sharding import (
    JOINT, leaf_paths, param_spec, zero_update_spec,
)
from proteinbert_tpu_torch.parallel.zero import (
    _gather_into, _size, all_reduce, all_reduce_flat, reduce_scatter,
)
from proteinbert_tpu_torch.train.schedule import OptState


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Where one leaf lives on this rank.

    store: ("fsdp" | "model", dim) — the mesh axis its storage shard is
      cut over — or None (whole).
    zero: (group name, dim, extent, index) of its ZeRO-1 piece inside the
      stored tensor — group "data" or "replica" — or None.
    zero_slice: the piece is cut after an all-reduce (the rule puts
      'data' alone on a leaf summed over the joint axis) instead of
      reduce-scattered into.
    """
    path: Tuple
    full_shape: Tuple[int, ...]
    store: Optional[Tuple[str, int]]
    store_extent: int
    store_index: int
    zero: Optional[Tuple[str, int, int, int]]
    zero_slice: bool

    @property
    def local_shape(self) -> Tuple[int, ...]:
        shape = list(self.full_shape)
        if self.store is not None:
            shape[self.store[1]] //= self.store_extent
        return tuple(shape)

    @property
    def owners(self) -> Tuple[str, ...]:
        """The mesh axes whose coordinate picks this rank's piece."""
        axes = () if self.store is None else (self.store[0],)
        if self.zero is not None:
            axes += ("data",) if self.zero[0] == "data" else JOINT
        return axes


def plan_leaf(path, shape: Sequence[int], mesh_shape: Dict[str, int],
              coords: Dict[str, int], zero_update: bool) -> LeafPlan:
    """The `LeafPlan` of one leaf on the rank at `coords`."""
    shape = tuple(shape)
    spec = param_spec(path, shape, mesh_shape)
    store, extent, index = None, 1, 0
    for dim, entry in enumerate(spec):
        if entry in ("fsdp", "model"):
            store = (entry, dim)
            extent, index = mesh_shape[entry], coords[entry]
    zero, zero_slice = None, False
    if zero_update and mesh_shape["data"] * mesh_shape["fsdp"] > 1:
        zspec = zero_update_spec(path, shape, mesh_shape)
        full = list(spec) + [None] * (len(shape) - len(spec))
        for dim, entry in enumerate(zspec):
            if entry == full[dim]:
                continue
            d, f = coords["data"], coords["fsdp"]
            if entry == JOINT and full[dim] == "fsdp":
                zero = ("data", dim, mesh_shape["data"], d)
            elif entry == JOINT:
                zero = ("replica", dim,
                        mesh_shape["data"] * mesh_shape["fsdp"],
                        d * mesh_shape["fsdp"] + f)
            else:   # 'data' alone
                zero = ("data", dim, mesh_shape["data"], d)
                zero_slice = (store is None or store[0] != "fsdp") \
                    and mesh_shape["fsdp"] > 1
    return LeafPlan(tuple(path), shape, store, extent, index, zero,
                    zero_slice)


def _narrow(t: torch.Tensor, dim: int, extent: int,
            index: int) -> torch.Tensor:
    n = t.shape[dim] // extent
    return t.narrow(dim, index * n, n)


def _reduce_scatter_into(fulls: Sequence[torch.Tensor], dims: Sequence[int],
                         group, registry=None) -> List[torch.Tensor]:
    """Σ over `group` of each tensor, of which this rank keeps its
    contiguous 1/n along dims[i]: ONE reduce_scatter_tensor of a float32
    buffer in which each rank's slices are contiguous."""
    n = _size(group)
    if n == 1 or not fulls:
        return [f.float() for f in fulls]
    moved = [f.movedim(dim, 0) for f, dim in zip(fulls, dims)]
    rows = [m.reshape(n, -1).float() for m in moved]
    buf = torch.cat(rows, dim=1)
    seg = buf.new_empty(buf.shape[1])
    reduce_scatter(seg, buf.reshape(-1), group, registry)
    out, off = [], 0
    for m, r, dim in zip(moved, rows, dims):
        k = r.shape[1]
        shape = (m.shape[0] // n,) + tuple(m.shape[1:])
        out.append(seg[off:off + k].view(shape).movedim(0, dim))
        off += k
    return out


def _all_gather_into(dsts: Sequence[torch.Tensor],
                     shards: Sequence[torch.Tensor], dims: Sequence[int],
                     group, registry=None) -> None:
    """Every rank's shard of each tensor into `dsts` (shard i cut along
    dims[i]); a copy without a group."""
    if not dsts:
        return
    if _size(group) == 1:
        for d, s in zip(dsts, shards):
            d.copy_(s)
        return
    _gather_into(dsts, shards, dims, group, registry)


class _ModelGather(torch.autograd.Function):
    """Forward: the model shards → the full leaves (one all-gather over
    the model group). Backward: this rank's slice of each full gradient —
    the model ranks see the same rows, so the slice is the shard's
    gradient, and no collective runs."""

    @staticmethod
    def forward(ctx, layout, *shards):
        ctx.layout = layout
        fulls = [s.new_empty(layout.plans[i].full_shape)
                 for s, i in zip(shards, layout.model_leaves)]
        _all_gather_into(fulls, [s.detach() for s in shards],
                         [layout.plans[i].store[1]
                          for i in layout.model_leaves],
                         layout.mesh.model_group, layout.registry)
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        layout = ctx.layout
        out = []
        for g, i in zip(grads, layout.model_leaves):
            p = layout.plans[i]
            out.append(torch.zeros(p.local_shape, device=layout.device)
                       if g is None else _narrow(
                           g, p.store[1], p.store_extent,
                           p.store_index).contiguous())
        return (None, *out)


class _FsdpGather(torch.autograd.Function):
    """Forward: the FSDP shards → the full leaves (one all-gather over
    the fsdp group). Backward: the full leaves' gradients → each rank's
    shard of their sum over the group (one reduce-scatter)."""

    @staticmethod
    def forward(ctx, layout, *shards):
        ctx.layout = layout
        fulls = [s.new_empty(layout.plans[i].full_shape)
                 for s, i in zip(shards, layout.fsdp_leaves)]
        _all_gather_into(fulls, [s.detach() for s in shards],
                         [layout.plans[i].store[1]
                          for i in layout.fsdp_leaves],
                         layout.mesh.fsdp_group, layout.registry)
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        layout = ctx.layout
        grads = [torch.zeros(layout.plans[i].full_shape,
                             device=layout.device) if g is None else g
                 for g, i in zip(grads, layout.fsdp_leaves)]
        shards = _reduce_scatter_into(
            grads, [layout.plans[i].store[1] for i in layout.fsdp_leaves],
            layout.mesh.fsdp_group, layout.registry)
        return (None, *shards)


def _build(tree, leaves):
    """`tree`'s structure with `leaves` in `tree_leaves` order."""
    return _put(tree, iter(leaves))


def _put(t, it):
    # Module-level recursion: a self-calling closure would be a reference
    # cycle holding the leaves (gathered full params) until a gc pass.
    if isinstance(t, dict):
        return {k: _put(v, it) for k, v in t.items()}
    if isinstance(t, list):
        return [_put(v, it) for v in t]
    return next(it)


class MeshLayout:
    """How one params tree lies on a data × fsdp × model mesh (module
    docstring): a `LeafPlan` a leaf, the forward's gathered params, the
    gradient reduction, the ZeRO-1 update, and the moves between the
    full-shape state and this rank's."""

    def __init__(self, mesh, params, zero_update: bool = False,
                 registry=None):
        self.mesh = mesh
        self.registry = registry
        leaves = list(leaf_paths(params))
        # The tree's structure only: holding the (full) params here would
        # keep them alive beside the shards.
        self.tree = _build(params, [None] * len(leaves))
        self.device = leaves[0][1].device
        self.plans = [plan_leaf(path, t.shape, mesh.shape, mesh.coords,
                                zero_update) for path, t in leaves]
        self.fsdp_leaves = [i for i, p in enumerate(self.plans)
                            if p.store and p.store[0] == "fsdp"]
        self.model_leaves = [i for i, p in enumerate(self.plans)
                             if p.store and p.store[0] == "model"]
        self.groups = {"data": mesh.data_group,
                       "replica": mesh.replica_group,
                       "fsdp": mesh.fsdp_group, "model": mesh.model_group}
        from proteinbert_tpu_torch.parallel.tensor_parallel import (
            TensorParallel,
        )

        self.tp = TensorParallel.for_layout(self)

    # ------------------------------------------------------------ shapes

    @property
    def full_shapes(self) -> List[Tuple[int, ...]]:
        return [p.full_shape for p in self.plans]

    def full_meta(self):
        """The params tree at full shape on the meta device (shapes for
        `per_chip_state_bytes` without an allocation)."""
        return _build(self.tree, [torch.empty(p.full_shape, device="meta")
                                  for p in self.plans])

    # ----------------------------------------------- full ↔ this rank's

    def local_of(self, full: torch.Tensor, i: int) -> torch.Tensor:
        p = self.plans[i]
        t = full if p.store is None else _narrow(
            full, p.store[1], p.store_extent, p.store_index)
        return t.clone(memory_format=torch.contiguous_format)

    def piece_of(self, local: torch.Tensor, i: int) -> torch.Tensor:
        z = self.plans[i].zero
        t = local if z is None else _narrow(local, z[1], z[2], z[3])
        return t.clone(memory_format=torch.contiguous_format)

    def shard_state(self, state):
        """A full-shape TrainState → this rank's: the params at their
        storage shard, the moments at their ZeRO piece (or storage shard);
        a state that already carries this layout passes through."""
        from proteinbert_tpu_torch.train.schedule import tree_leaves
        from proteinbert_tpu_torch.train.train_state import TrainState

        if getattr(state, "layout", None) is self:
            return state
        params = [self.local_of(t, i)
                  for i, t in enumerate(tree_leaves(state.params))]
        o = state.opt_state
        mu = [self.piece_of(self.local_of(t, i), i)
              for i, t in enumerate(o.mu)]
        nu = [self.piece_of(self.local_of(t, i), i)
              for i, t in enumerate(o.nu)]
        return TrainState(state.step, _build(self.tree, params),
                          OptState(o.count, mu, nu, o.plateau),
                          state.generator, layout=self)

    def _gather_locals(self, tensors: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """This rank's stored tensors → full shape (collective: one
        all-gather over the fsdp group and one over the model group)."""
        out = list(tensors)
        for axis in ("fsdp", "model"):
            idx = [i for i, p in enumerate(self.plans)
                   if p.store and p.store[0] == axis]
            dsts = [tensors[i].new_empty(self.plans[i].full_shape)
                    for i in idx]
            _all_gather_into(dsts, [tensors[i] for i in idx],
                             [self.plans[i].store[1] for i in idx],
                             self.groups[axis], self.registry)
            for i, d in zip(idx, dsts):
                out[i] = d
        return out

    def _gather_pieces(self, pieces: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """ZeRO pieces → this rank's stored tensors (collective)."""
        out = list(pieces)
        for name in ("data", "replica"):
            idx = [i for i, p in enumerate(self.plans)
                   if p.zero and p.zero[0] == name]
            dsts = [pieces[i].new_empty(self.plans[i].local_shape)
                    for i in idx]
            _all_gather_into(dsts, [pieces[i] for i in idx],
                             [self.plans[i].zero[1] for i in idx],
                             self.groups[name], self.registry)
            for i, d in zip(idx, dsts):
                out[i] = d
        return out

    def full_params(self, params) -> Any:
        """The params tree at full shape (collective)."""
        from proteinbert_tpu_torch.train.schedule import tree_leaves

        return _build(self.tree, self._gather_locals(tree_leaves(params)))

    def full_state(self, state):
        """This rank's TrainState → the full-shape one, params and moments
        (collective: every rank of the mesh calls it)."""
        from proteinbert_tpu_torch.train.train_state import TrainState

        o = state.opt_state
        mu = self._gather_locals(self._gather_pieces(list(o.mu)))
        nu = self._gather_locals(self._gather_pieces(list(o.nu)))
        return TrainState(state.step, self.full_params(state.params),
                          OptState(o.count, mu, nu, o.plateau),
                          state.generator)

    # ------------------------------------------------------------ forward

    def forward_params(self, params, gather_model: bool = False) -> Any:
        """The tree the model reads: the FSDP leaves gathered (through
        `_FsdpGather`, so their gradients come back reduce-scattered to
        the shards), the whole leaves as stored, and the model shards as
        stored (the tensor-parallel head) or, with `gather_model`,
        gathered whole (through `_ModelGather`, each rank's gradient its
        slice)."""
        from proteinbert_tpu_torch.train.schedule import tree_leaves

        leaves = list(tree_leaves(params))
        for idx, fn in ((self.fsdp_leaves, _FsdpGather),
                        (self.model_leaves if gather_model else [],
                         _ModelGather)):
            if idx:
                fulls = fn.apply(self, *[leaves[i] for i in idx])
                for i, f in zip(idx, fulls):
                    leaves[i] = f
        return _build(self.tree, leaves)

    # ------------------------------------------------------------- update

    def reduce(self, grads: List[torch.Tensor], cast_bf16: bool = False
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Each rank's partial gradients of its stored tensors → (the
        summed gradient of each leaf's piece, the global norm).
        `cast_bf16` rounds the summed pieces to bf16 and back after the
        norm is taken (JAX's numerics-only bf16 reduction, zero.py:
        126-128; the wire stays float32)."""
        grads = [g.float() for g in grads]
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        whole: Dict[str, List[int]] = {"data": [], "replica": []}
        scatter: Dict[str, List[int]] = {"data": [], "replica": []}
        for i, p in enumerate(self.plans):
            sum_over = ("data" if p.store and p.store[0] == "fsdp"
                        else "replica")
            if p.zero is not None and not p.zero_slice:
                scatter[sum_over].append(i)
            else:
                whole[sum_over].append(i)
        for name, idx in whole.items():
            if not idx:
                continue
            for i, g in zip(idx, all_reduce_flat(
                    [grads[i] for i in idx], self.groups[name],
                    self.registry)):
                z = self.plans[i].zero
                out[i] = g if z is None else _narrow(g, z[1], z[2], z[3])
        for name, idx in scatter.items():
            pieces = _reduce_scatter_into(
                [grads[i] for i in idx],
                [self.plans[i].zero[1] for i in idx], self.groups[name],
                self.registry)
            for i, g in zip(idx, pieces):
                out[i] = g
        model = self.mesh.shape["model"]
        if model > 1:
            idx = [i for i, p in enumerate(self.plans)
                   if not (p.store and p.store[0] == "model")]
            synced = all_reduce_flat([out[i].contiguous() for i in idx],
                                     self.groups["model"], self.registry)
            for i, g in zip(idx, synced):
                out[i] = g.div_(model)
        norm = self.global_norm(out)
        if cast_bf16:
            out = [g.bfloat16().float() for g in out]
        return out, norm

    def global_norm(self, pieces: List[torch.Tensor]) -> torch.Tensor:
        """sqrt of Σ x² over every element of every full gradient, each
        counted once: a rank adds a piece's squares when its coordinates
        on the axes that do not pick the piece are 0 (`seq` never picks
        one: the seq ranks hold the same pieces). One scalar all-reduce
        over the mesh, the same on every rank."""
        coords = self.mesh.coords
        sq = torch.zeros(1, dtype=torch.float32, device=self.device)
        for p, g in zip(self.plans, pieces):
            if all(coords[ax] == 0 for ax in ("data", "fsdp", "model", "seq")
                   if ax not in p.owners):
                sq += (g.float() ** 2).sum()
        all_reduce(sq, dist.group.WORLD if self.mesh.size > 1 else None,
                   self.registry)
        return torch.sqrt(sq[0])

    def views(self, params) -> List[torch.Tensor]:
        """The params the optimizer updates: each stored tensor, or a
        view of its ZeRO piece."""
        from proteinbert_tpu_torch.train.schedule import tree_leaves

        out = []
        for t, p in zip(tree_leaves(params), self.plans):
            z = p.zero
            out.append(t if z is None else _narrow(t, z[1], z[2], z[3]))
        return out

    def gather_updated(self, params) -> None:
        """Every rank's updated ZeRO pieces into the stored tensors, in
        place (one all-gather a ZeRO group)."""
        from proteinbert_tpu_torch.train.schedule import tree_leaves

        leaves = tree_leaves(params)
        views = self.views(params)
        for name in ("data", "replica"):
            idx = [i for i, p in enumerate(self.plans)
                   if p.zero and p.zero[0] == name]
            _all_gather_into([leaves[i] for i in idx],
                             [views[i] for i in idx],
                             [self.plans[i].zero[1] for i in idx],
                             self.groups[name], self.registry)


def layout_getter(mesh, zero_update: bool, registry=None):
    """`layout_for(state) → MeshLayout`: the state's own layout, or the
    one built once from the first full-shape state it is given."""
    cache: Dict[str, MeshLayout] = {}

    def layout_for(state) -> MeshLayout:
        lay = getattr(state, "layout", None)
        if lay is None:
            lay = cache.get("layout")
            if lay is None:
                lay = cache["layout"] = MeshLayout(mesh, state.params,
                                                   zero_update, registry)
        return lay

    return layout_for


def apply_update(layout: MeshLayout, cfg, state, pieces, norm, metrics,
                 plateau_value=None):
    """The sharded steps' common tail: Adam on this rank's pieces
    (clipped by the global `norm`), the pieces gathered back into the
    stored tensors in place → (the next state, the metrics with
    grad_norm and lr)."""
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.schedule import (
        effective_lr, make_optimizer, needs_loss_value,
    )

    metrics["grad_norm"] = norm
    value = ts.plateau_observation(cfg.optimizer, metrics, plateau_value)
    views = layout.views(state.params)
    with torch.no_grad():
        updates, opt_state = make_optimizer(cfg.optimizer).update(
            pieces, state.opt_state, views,
            value=value if needs_loss_value(cfg.optimizer) else None,
            grad_norm=norm)
        torch._foreach_add_(views, updates)
    layout.gather_updated(state.params)
    metrics["lr"] = effective_lr(cfg.optimizer, opt_state, state.step)
    return ts.TrainState(state.step + 1, state.params, opt_state,
                         state.generator, layout=layout), metrics


def make_sharded_train_step(mesh, cfg, registry=None):
    """`step(state, batch, plateau_value=None) → (state, metrics)` on a
    mesh with an fsdp or a model axis above 1 — the trainer's choice
    there, with ZeRO-1 when cfg.parallel.zero_update (and then, for
    grad_reduce_dtype "bf16" / "int8", `quant.make_quant_fsdp_train_step`).
    The step takes a full-shape state on its first call and returns this
    rank's (`TrainState.layout` set); `step.layout_for(state)` gives the
    layout of a state. `registry` receives the comm accounting."""
    from proteinbert_tpu_torch.train import train_state as ts

    if cfg.parallel.grad_reduce_dtype != "fp32" and cfg.parallel.zero_update:
        # The quantized reduce-scatter over data·fsdp (QuantConfigError on
        # a model or seq axis, or a batch that does not split); without
        # ZeRO-1 the payload has no effect, as in JAX (the trainer warns).
        from proteinbert_tpu_torch.parallel.quant import (
            make_quant_fsdp_train_step,
        )

        return make_quant_fsdp_train_step(mesh, cfg, registry=registry)
    layout_for = layout_getter(mesh, cfg.parallel.zero_update, registry)

    def step(state, batch, plateau_value=None):
        layout = layout_for(state)
        state = layout.shard_state(state)
        X, Y, W, seg = ts.corrupt_for_step(
            state, batch, cfg, ts.replica_generator(state, mesh))
        out = {}

        def share():
            params = layout.forward_params(state.params)
            ll, gl = ts.forward_logits(params, X, W, cfg, seg, tp=layout.tp)
            nums, dens = ts.loss_terms(ll, gl, Y, W, seg)
            loss, out["metrics"] = ts.global_loss_share(
                nums, dens, mesh.replica_group, registry)
            return loss, {}

        grads, _ = ts.grads_of(state.params, share)
        metrics = {k: v.detach() for k, v in out["metrics"].items()}
        pieces, norm = layout.reduce(grads)
        return apply_update(layout, cfg, state, pieces, norm, metrics,
                            plateau_value)

    step.layout_for = layout_for
    return step
