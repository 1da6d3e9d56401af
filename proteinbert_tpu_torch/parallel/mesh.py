"""The (data, fsdp, model, seq) mesh over `torch.distributed` — port of
`proteinbert_tpu/parallel/mesh.py` (`make_mesh`, `mesh_for_devices`) —
and the one-process serving mesh (`serve_mesh`).

A JAX mesh is a device array; the port's is the default process group
read as that array: one rank a card, ranks laid out data-major as
`np.arange(world).reshape(data, fsdp, model, seq)` lays out the JAX
mesh's devices, so rank r sits at
`r = ((d·fsdp + f)·model + m)·seq + s`. `Mesh` carries the axis sizes
(`shape`, a dict, as `jax.sharding.Mesh.shape` is), this rank's
coordinates and one process group per axis in use:

- `seq_group`: the ranks of this rank's row along `seq` (its replica's
  sequence shards, `parallel/seq_parallel.py`);
- `data_group`: the ranks along `data` — the gradient sum of data
  parallelism;
- `fsdp_group`: the ranks along `fsdp` — the all-gather of the params'
  FSDP shards and the reduce-scatter of their gradients
  (`parallel/fsdp.py`);
- `model_group`: the ranks along `model` — the GO head's tensor
  parallelism (`parallel/tensor_parallel.py`);
- `replica_group`: the joint ('data', 'fsdp') replica axis, the ranks
  that hold different rows — the loss's weight masses, the eval pool and
  ZeRO-1 sum over it. A rank's index in it is `data_index`
  (d·fsdp + f), the order of the JAX joint axis.

An axis whose ranks are the whole world uses `dist.group.WORLD`, so a
one-rank run still makes its collectives (as a one-device JAX mesh runs
its psums); an axis of extent 1 inside a larger world has no group
(None: no collective). Every rank creates every group, in the same order
(`dist.new_group` is collective over the world).

Every combination of the four axes is laid out, `seq` together with
`fsdp` or `model` included: the seq ranks of one (data, fsdp, model)
coordinate share that coordinate's rows and params, so each of the other
groups holds the ranks of one seq index (`parallel/seq_parallel.py`'s
step on the sharded layout of `parallel/fsdp.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.configs import MeshConfig

AXES = ("data", "fsdp", "model", "seq")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: `shape` ({axis: extent}), `rank`,
    `coords` ({axis: index}) and the groups of the axes in use."""
    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    data_group: Any = None
    seq_group: Any = None
    fsdp_group: Any = None
    model_group: Any = None
    replica_group: Any = None

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def sharded(self) -> bool:
        """Whether the params are laid out over the mesh (an fsdp or a
        model axis above 1): the step of `parallel/fsdp.py`."""
        return self.shape["fsdp"] > 1 or self.shape["model"] > 1

    @property
    def data_index(self) -> int:
        """This rank's index along the joint replica axis (data-major)."""
        return self.coords["data"] * self.shape["fsdp"] + self.coords["fsdp"]

    @property
    def data_extent(self) -> int:
        return self.shape["data"] * self.shape["fsdp"]


def _axis_groups(grid: np.ndarray, axes, rank: int, world: int):
    """Create the groups along `axes` (one axis or several, read jointly
    in mesh order) of the rank grid (every rank calls this, creating
    every group) → this rank's group."""
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    extent = int(np.prod([grid.shape[a] for a in axes]))
    if extent == world:
        return dist.group.WORLD
    if extent == 1:
        return None
    last = tuple(range(grid.ndim - len(axes), grid.ndim))
    lines = np.moveaxis(grid, axes, last).reshape(-1, extent)
    mine = None
    for line in lines:
        g = dist.new_group([int(r) for r in line])
        if rank in line:
            mine = g
    return mine


def make_mesh(cfg: MeshConfig) -> Mesh:
    """This rank's mesh of `cfg` over the default process group (without
    one: world 1, rank 0, no groups). ValueError when the mesh's device
    count is not the world size (the JAX message). Collective: every
    rank of the group calls it, with the same `cfg`."""
    live = dist.is_initialized()
    world = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    if cfg.num_devices != world:
        raise ValueError(
            f"mesh {cfg.shape} wants {cfg.num_devices} devices, have "
            f"{world}")
    grid = np.arange(world).reshape(cfg.shape)
    coords = dict(zip(AXES, (int(i) for i in np.argwhere(grid == rank)[0])))
    groups = {}
    if live:
        # The same order on every rank; the joint replica axis is the
        # data or the fsdp group when the other extent is 1.
        for name in ("seq", "data", "fsdp", "model"):
            groups[name] = _axis_groups(grid, AXES.index(name), rank, world)
        groups["replica"] = (
            groups["data"] if cfg.fsdp == 1 else groups["fsdp"]
            if cfg.data == 1 else _axis_groups(grid, (0, 1), rank, world))
    return Mesh(shape=dict(zip(AXES, cfg.shape)), rank=rank, coords=coords,
                data_group=groups.get("data"), seq_group=groups.get("seq"),
                fsdp_group=groups.get("fsdp"),
                model_group=groups.get("model"),
                replica_group=groups.get("replica"))


def mesh_for_devices(n: int, data: Optional[int] = None, **axes) -> Mesh:
    """Convenience: an n-rank mesh, defaulting all parallelism to data."""
    return make_mesh(MeshConfig(data=data if data is not None else n,
                                **axes))


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A one-process device mesh for serving: `shape` ({axis: extent}, as
    `jax.sharding.Mesh.shape`) and `devices`, the device grid of that
    shape laid out data-major (an object array of `torch.device`)."""
    shape: Dict[str, int]
    devices: np.ndarray

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_extent(self) -> int:
        """data·fsdp: the replicas a served batch's rows split over."""
        return self.shape["data"] * self.shape["fsdp"]

    @property
    def replica_devices(self) -> List[torch.device]:
        """The device at (d, f, model 0, seq 0) of each replica, in the
        joint axis's order (d·fsdp + f)."""
        return [self.devices[d, f, 0, 0] for d in range(self.shape["data"])
                for f in range(self.shape["fsdp"])]


def serve_mesh(cfg: MeshConfig,
               devices: Optional[Sequence[DeviceLike]] = None) -> ServeMesh:
    """The serving mesh of `cfg` over `devices` (None: cuda:0 …
    cuda:{device_count - 1}, raising without CUDA), the counterpart of
    JAX's `make_mesh(cfg, devices)` in one process. ValueError when the
    mesh's device count is not len(devices) (the JAX message)."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if cfg.num_devices != len(devices):
        raise ValueError(
            f"mesh {cfg.shape} wants {cfg.num_devices} devices, have "
            f"{len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return ServeMesh(shape=dict(zip(AXES, cfg.shape)),
                     devices=grid.reshape(cfg.shape))
