"""Layout rules of the train state and the batch over the mesh — port of
`proteinbert_tpu/parallel/sharding.py` (`_leaf_spec` as `leaf_spec`,
`param_spec`, `zero_update_spec`, `batch_sharding`,
`serve_batch_sharding`).

The JAX rules return a `PartitionSpec` for each leaf of an abstract tree;
here each is a plain function of `(path, shape, mesh_shape)` returning
the spec as a tuple: `()` for a replicated leaf, else one entry a dim —
None, a mesh axis name, or the joint `("data", "fsdp")`. The port applies
them to its own leaves (`parallel/fsdp.py` places the shards), and a test
holds them against the JAX functions with a namespace carrying `.shape`
standing in for the mesh (they read only `mesh.shape`).

- tensor parallelism over the annotation dim A: `global_head` on its last
  dim and `global_in`'s kernel on its rows, each only where `model`
  divides that dim (at the `large` preset's own model=4 it does not:
  A = 8943 = 3·11·271, so every leaf there is replicated over `model`);
- the token embedding replicated;
- FSDP on one dim of a leaf: a block leaf's LAST dim that `fsdp` divides
  (never the stacked axis), another leaf's LARGEST such dim, in both
  cases only where the dim holds at least 2·fsdp entries.

The port keeps the blocks as a list (`models/proteinbert.py`), so a block
leaf has no leading num_blocks axis. The JAX rules see it stacked, one
rank higher: a block's bias or LN scale is 2-D there, (N, C), and the
FSDP rule (`len(shape) >= 2`) shards it. `leaf_spec` therefore counts a
block leaf's rank as `len(shape) + 1` and searches its own dims, which
are the stacked leaf's dims 1.. — the JAX spec with its stacked entry
dropped. ZeRO-1's largest-dim choice likewise runs over the block leaf's
own dims: the JAX choice wherever that choice is not the stacked axis
(never at the presets' widths, whose num_blocks is smaller than every
other dim of a block leaf that the rules place).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

Spec = Tuple
Path = Tuple

JOINT = ("data", "fsdp")


def _is_block(path: Path) -> bool:
    return bool(path) and path[0] == "blocks"


def leaf_spec(path: Path, shape: Sequence[int],
              mesh_shape: Dict[str, int]) -> Spec:
    """Storage spec of one leaf between steps (the JAX `_leaf_spec`)."""
    shape = tuple(shape)
    model_n = mesh_shape.get("model", 1)
    fsdp_n = mesh_shape.get("fsdp", 1)

    # Tensor parallelism over the annotation dimension A.
    if model_n > 1 and "global_head" in path:
        if len(shape) >= 1 and shape[-1] % model_n == 0:
            return (None,) * (len(shape) - 1) + ("model",)
    if model_n > 1 and "global_in" in path and "kernel" in path:
        if len(shape) >= 2 and shape[-2] % model_n == 0:
            return (None,) * (len(shape) - 2) + ("model", None)

    # The token embedding is replicated (a few KB at every preset).
    if "embedding" in path:
        return ()

    # FSDP on one dim; a block leaf ranks as its stacked JAX leaf.
    block = _is_block(path)
    rank = len(shape) + (1 if block else 0)
    if fsdp_n > 1 and rank >= 2:
        if block:
            axes = range(len(shape) - 1, -1, -1)
        else:
            axes = sorted(range(len(shape)), key=lambda i: shape[i],
                          reverse=True)
        for ax in axes:
            if shape[ax] % fsdp_n == 0 and shape[ax] >= 2 * fsdp_n:
                spec = [None] * len(shape)
                spec[ax] = "fsdp"
                return tuple(spec)
    return ()


def param_spec(path: Path, shape: Sequence[int],
               mesh_shape: Dict[str, int]) -> Spec:
    """The storage spec of a leaf, scalar-safe (the JAX `param_spec`):
    the layout params keep between steps, ZeRO or not."""
    if len(shape) == 0:
        return ()
    return leaf_spec(path, shape, mesh_shape)


def zero_update_spec(path: Path, shape: Sequence[int],
                     mesh_shape: Dict[str, int]) -> Spec:
    """ZeRO-1 spec of one leaf: the storage spec extended with the joint
    ('data', 'fsdp') replica axis (the JAX function, in its order of
    preference): (1) widen a 'fsdp' dim to the joint axis where
    data·fsdp divides it; (2) else, on a leaf without 'fsdp', the
    largest free dim that data·fsdp divides; (3) else the largest free
    dim that `data` alone divides ('data', keeping any 'fsdp'); (4) else
    the storage spec — the moments stay at the storage shard and the
    update runs on every data replica."""
    shape = tuple(shape)
    base = param_spec(path, shape, mesh_shape)
    if len(shape) == 0:
        return base
    data_n = mesh_shape.get("data", 1)
    joint = data_n * mesh_shape.get("fsdp", 1)
    if joint == 1:
        return base
    entries = list(base) + [None] * (len(shape) - len(base))
    for i, e in enumerate(entries):
        if e == "fsdp" and shape[i] % joint == 0:
            entries[i] = JOINT
            return tuple(entries)
    has_fsdp = "fsdp" in entries
    by_size = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    if not has_fsdp:
        for ax in by_size:
            if entries[ax] is None and shape[ax] % joint == 0:
                entries[ax] = JOINT
                return tuple(entries)
    if data_n > 1:
        for ax in by_size:
            if entries[ax] is None and shape[ax] % data_n == 0:
                entries[ax] = "data"
                return tuple(entries)
    return base


def _spec_extent(entry, mesh_shape: Dict[str, int]) -> int:
    """How many pieces one spec entry cuts its dim into."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for name in names:
        n *= mesh_shape.get(name, 1)
    return n


def shard_shape(shape: Sequence[int], spec: Spec,
                mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """The per-rank shape of a leaf laid out by `spec` (the JAX
    `NamedSharding.shard_shape`)."""
    out = list(shape)
    for i, e in enumerate(spec):
        out[i] //= _spec_extent(e, mesh_shape)
    return tuple(out)


def zero_dim(path: Path, shape: Sequence[int],
             mesh_shape: Dict[str, int]) -> Optional[int]:
    """On a data-only mesh (fsdp = model = 1): the dim of a leaf that
    ZeRO-1 splits over the joint replica axis, or None when the leaf is
    updated whole on every replica (the JAX `_leaf_plan`'s "alltoall"
    case). `parallel/fsdp.py` plans the fsdp- and model-bearing
    meshes."""
    spec = zero_update_spec(path, shape, mesh_shape)
    return spec.index(JOINT) if JOINT in spec else None


def batch_sharding(mesh_shape: Dict[str, int]) -> Dict[str, Spec]:
    """Spec of each training batch key (the JAX `batch_sharding`): rows
    over the joint ('data', 'fsdp') axis, positions over 'seq'; the
    annotations keep batch-only sharding (trailing dims replicated, so
    the packed (B, S, A) tensor takes the same entry). Every `model`
    rank of a replica reads the same rows."""
    return {"tokens": (JOINT, "seq"), "segment_ids": (JOINT, "seq"),
            "annotations": (JOINT, None)}


def serve_batch_sharding(mesh_shape: Dict[str, int]) -> Dict[str, Spec]:
    """Spec of each SERVED batch key (the JAX `serve_batch_sharding`):
    rows over the joint replica axis, positions replicated (served
    buckets need not divide the seq extent)."""
    return {"tokens": (JOINT, None), "segment_ids": (JOINT, None),
            "annotations": (JOINT, None)}


def leaf_paths(tree, prefix: Path = ()):
    """(path, tensor) of every leaf of a params tree, in `tree_leaves`
    order; a path is the tuple of dict keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def local_batch_size(batch_size: int, data_extent: int) -> int:
    """The rows one replica feeds of a global batch of `batch_size` (the
    batch splits over the joint data·fsdp axis, `batch_sharding`).
    ValueError when it does not split evenly."""
    if batch_size % data_extent:
        raise ValueError(
            f"global batch {batch_size} does not split evenly over the "
            f"data*fsdp extent {data_extent}: each data rank feeds "
            "batch_size / data rows")
    return batch_size // data_extent
