"""Sequence-parallel halo exchange over `torch.distributed` — port of
`proteinbert_tpu/parallel/halo.py` (`halo_exchange`, `conv1d_halo`).

The local conv track is sharded over the sequence axis: rank i of the
seq process group holds rows [i·L, (i+1)·L) of every batch row. A 'SAME'
conv of a shard needs `halo` rows each side from its neighbours (20 for
the k=9, d=5 wide conv); the ends of the sequence get zeros, as 'SAME'
zero padding does. A halo longer than a shard hops over several
neighbours: round r brings the rows of ranks i ∓ r, as the JAX rounds of
`ppermute` do (halo.py:46-69), here as direct sends to rank i ± r, each
carrying only the rows the receiver keeps. One `batch_isend_irecv` posts
every round's sends and receives at once. gloo's send and receive take
host tensors only (its collectives stage CUDA tensors themselves), so on
a gloo group the rows of a CUDA tensor go through host memory; NCCL
moves them on the device.

The exchange is differentiable: its backward is the adjoint of the JAX
`ppermute`s — each halo's gradient goes back to the rank that owns those
rows and is added into that rank's centre gradient (`_HaloExchange`).

A group of size 1 (or None) pads with zeros and makes no collective call
(halo.py:42-44). `seq_parallel_conv1d` (halo.py:99-116) is the
standalone sharded conv over a mesh: the JAX function shard_maps a global
(B, L, C) array with B over the joint ('data', 'fsdp') axis and L over
'seq'; here every rank passes the same global array, cuts its block of it
(`mesh_block`) and returns its block of the output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def group_size(group) -> int:
    """World size of a seq process group; None counts as 1."""
    return 1 if group is None else dist.get_world_size(group)


def _rounds(halo: int, L: int, world: int) -> List[Tuple[int, int]]:
    """[(r, n)]: round r reaches ranks i ∓ r and carries n rows."""
    rounds = min(-(-halo // L), world - 1)
    return [(r, min(L, halo - (r - 1) * L)) for r in range(1, rounds + 1)]


def _swap(group, sends: List[Tuple[int, torch.Tensor]],
          recv_shapes: List[Tuple[int, tuple]], like: torch.Tensor
          ) -> List[torch.Tensor]:
    """Send each (peer group rank, tensor) and receive one tensor of each
    (peer, shape), all in one batch; → the received tensors (on `like`'s
    device; through host memory for CUDA tensors on a gloo group)."""
    staged = like.is_cuda and dist.get_backend(group) == "gloo"
    where = torch.device("cpu") if staged else like.device
    ops, got = [], []
    for peer, t in sends:
        ops.append(dist.P2POp(dist.isend, t.to(where).contiguous(),
                              dist.get_global_rank(group, peer), group))
    for peer, shape in recv_shapes:
        buf = torch.empty(shape, dtype=like.dtype, device=where)
        got.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(like.device) for b in got] if staged else got


class _HaloExchange(torch.autograd.Function):
    """Forward: (B, L, C) → (B, halo + L + halo, C) with the neighbours'
    rows. Backward: the halo rows' gradients go back to their owners."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, halo: int, group) -> torch.Tensor:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        B, L, C = x.shape
        ctx.halo, ctx.group = halo, group
        sends, recvs, put = [], [], []
        for r, n in _rounds(halo, L, world):
            if rank + r < world:  # my tail → its left halo; its head → mine
                sends.append((rank + r, x[:, L - n:]))
                recvs.append((rank + r, (B, n, C)))
                put.append(halo + L + (r - 1) * L)
            if rank - r >= 0:     # my head → its right halo; its tail → mine
                sends.append((rank - r, x[:, :n]))
                recvs.append((rank - r, (B, n, C)))
                put.append(halo - (r - 1) * L - n)
        xh = F.pad(x, (0, 0, halo, halo))
        for row, buf in zip(put, _swap(group, sends, recvs, x)):
            xh[:, row:row + buf.shape[1]] = buf
        return xh

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        halo, group = ctx.halo, ctx.group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        B, Lh, C = g.shape
        L = Lh - 2 * halo
        gx = g[:, halo:halo + L].clone()
        sends, recvs, put = [], [], []
        for r, n in _rounds(halo, L, world):
            if rank + r < world:  # my right halo's rows are its head
                row = halo + L + (r - 1) * L
                sends.append((rank + r, g[:, row:row + n]))
                recvs.append((rank + r, (B, n, C)))
                put.append(L - n)  # its left halo read my tail
            if rank - r >= 0:     # my left halo's rows are its tail
                row = halo - (r - 1) * L - n
                sends.append((rank - r, g[:, row:row + n]))
                recvs.append((rank - r, (B, n, C)))
                put.append(0)      # its right halo read my head
        for row, buf in zip(put, _swap(group, sends, recvs, g)):
            gx[:, row:row + buf.shape[1]] += buf
        return gx, None, None


def halo_exchange(x: torch.Tensor, halo: int,
                  group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Pad the (B, L_shard, C) local block with `halo` rows from each
    side's neighbours in the seq process group `group` (zeros at the ends
    of the sequence) → (B, L_shard + 2·halo, C). Differentiable; a group
    of size 1 (or None) only pads."""
    if halo == 0:
        return x
    if group_size(group) == 1:
        return F.pad(x, (0, 0, halo, halo))
    return _HaloExchange.apply(x, halo, group)


def conv1d_halo(params: Params, x: torch.Tensor, dilation: int,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """'SAME' Conv1d of a seq-sharded (B, L_shard, C) block: halo
    exchange, then a VALID conv in x's dtype. Requires an odd kernel."""
    k = params["kernel"].shape[0]
    if k % 2 != 1:
        raise ValueError(f"conv1d_halo: the halo conv needs an odd kernel, "
                         f"got {k}")
    xh = halo_exchange(x, (k - 1) // 2 * dilation, group)
    w = params["kernel"].to(x.dtype).permute(2, 1, 0)  # (Cout, Cin, K)
    y = F.conv1d(xh.transpose(1, 2), w, dilation=dilation).transpose(1, 2)
    return y + params["bias"].to(x.dtype)


def mesh_block(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global (B, L, …) array laid out as the JAX
    P(('data', 'fsdp'), 'seq'): rows by the joint replica index, positions
    by the seq coordinate."""
    rows = x.shape[0] // mesh.data_extent
    cols = x.shape[1] // mesh.shape["seq"]
    return x[mesh.data_index * rows:(mesh.data_index + 1) * rows,
             mesh.coords["seq"] * cols:(mesh.coords["seq"] + 1) * cols]


def seq_parallel_conv1d(mesh, params: Params, x: torch.Tensor,
                        dilation: int = 1) -> torch.Tensor:
    """The 'SAME' conv of a global (B, L, C) array whose L is sharded
    over the mesh's seq axis and B over data×fsdp (the JAX function):
    this rank's block of the output, from its block of `x` and the halo
    exchange over `mesh.seq_group`. Every rank passes the same `x`."""
    return conv1d_halo(params, mesh_block(mesh, x), dilation, mesh.seq_group)
