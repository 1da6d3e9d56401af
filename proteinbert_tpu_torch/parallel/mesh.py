"""The (data, fsdp, model, seq) mesh over `torch.distributed` — port of
`proteinbert_tpu/parallel/mesh.py` (`make_mesh`, `mesh_for_devices`).

A JAX mesh is a device array; the port's is the default process group
read as that array: one rank a card, ranks laid out data-major as
`np.arange(world).reshape(data, fsdp, model, seq)` lays out the JAX
mesh's devices, so rank r sits at
`r = ((d·fsdp + f)·model + m)·seq + s`. `Mesh` carries the axis sizes
(`shape`, a dict, as `jax.sharding.Mesh.shape` is), this rank's
coordinates and one process group per axis in use:

- `seq_group`: the ranks of this rank's row along `seq` (its data
  replica's sequence shards, `parallel/seq_parallel.py`);
- `data_group`: the ranks along `data` — the gradient sum of data
  parallelism, and (`fsdp` being 1 here) the joint ('data', 'fsdp')
  replica axis that ZeRO-1 reduce-scatters over (`replica_group`).

An axis whose ranks are the whole world uses `dist.group.WORLD`, so a
one-rank run still makes its collectives (as a one-device JAX mesh runs
its psums); an axis of extent 1 inside a larger world has no group
(None: no collective). Every rank creates every group, in the same order
(`dist.new_group` is collective over the world).

Not ported (ROADMAP A11c): the `fsdp` and `model` axes — FSDP placement
and the GO head's tensor parallelism. `make_mesh` refuses them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch.distributed as dist

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

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def replica_group(self):
        """The joint ('data', 'fsdp') axis: the data group while fsdp is
        1 (the only extent this port takes)."""
        return self.data_group

    @property
    def data_index(self) -> int:
        """This rank's index along the joint replica axis (data-major)."""
        return self.coords["data"] * self.shape["fsdp"] + self.coords["fsdp"]

    @property
    def data_extent(self) -> int:
        return self.shape["data"] * self.shape["fsdp"]


def _axis_groups(grid: np.ndarray, axis: int, rank: int, world: int):
    """Create the groups along `axis` of the rank grid (every rank calls
    this, creating every group) → this rank's group."""
    extent = grid.shape[axis]
    if extent == world:
        return dist.group.WORLD
    if extent == 1:
        return None
    lines = np.moveaxis(grid, axis, -1).reshape(-1, extent)
    mine = None
    for line in lines:
        g = dist.new_group([int(r) for r in line])
        if rank in line:
            mine = g
    return mine


def make_mesh(cfg: MeshConfig) -> Mesh:
    """This rank's mesh of `cfg` over the default process group (without
    one: world 1, rank 0, no groups). ValueError for an `fsdp` or `model`
    axis (ROADMAP A11c) and when the mesh's device count is not the
    world size (the JAX message). Collective: every rank of the group
    calls it, with the same `cfg`."""
    live = dist.is_initialized()
    world = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    for ax in ("fsdp", "model"):
        if getattr(cfg, ax) > 1:
            raise ValueError(
                f"mesh axis {ax}={getattr(cfg, ax)}: FSDP placement and "
                "tensor parallelism are not ported yet (ROADMAP A11c); "
                "the port's meshes are data x seq")
    if cfg.num_devices != world:
        raise ValueError(
            f"mesh {cfg.shape} wants {cfg.num_devices} devices, have "
            f"{world}")
    grid = np.arange(world).reshape(cfg.shape)
    coords = dict(zip(AXES, (int(i) for i in np.argwhere(grid == rank)[0])))
    groups = {}
    if live:
        for ax in ("seq", "data"):   # the same order on every rank
            groups[ax] = _axis_groups(grid, AXES.index(ax), rank, world)
    return Mesh(shape=dict(zip(AXES, cfg.shape)), rank=rank, coords=coords,
                data_group=groups.get("data"), seq_group=groups.get("seq"))


def mesh_for_devices(n: int, data: Optional[int] = None, **axes) -> Mesh:
    """Convenience: an n-rank mesh, defaulting all parallelism to data."""
    return make_mesh(MeshConfig(data=data if data is not None else n,
                                **axes))
