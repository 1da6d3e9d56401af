"""Layout rules of the train state and the batch over the mesh — port of
`proteinbert_tpu/parallel/sharding.py` (`zero_update_spec`,
`batch_sharding`) on the meshes the port builds: data x seq, with fsdp =
model = 1 (`mesh.make_mesh` refuses the others, ROADMAP A11c).

On such a mesh every leaf's storage spec is replicated, and the one rule
that acts is ZeRO-1's: which dim of a leaf, if any, splits over the
joint ('data', 'fsdp') replica axis. The JAX rule returns a
`PartitionSpec` for each leaf of an abstract tree; here it is a plain
function of `(path, shape, mesh_shape)` returning the spec as a tuple,
so the port applies it to its own leaves and a test can hold it against
the JAX function with a namespace carrying `.shape` standing in for the
mesh (it reads only `mesh.shape`).

The port keeps the blocks as a list (`models/proteinbert.py`): a block
leaf has no leading num_blocks axis, so ZeRO-1's largest-axis choice
runs over the block leaf's own axes — the JAX choice with its leading
axis dropped, wherever that choice is not the stacked axis itself (never
at the presets' widths: their num_blocks is smaller than every other
axis of a block leaf). The FSDP and model-axis rules come with A11c.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

Spec = Tuple
Path = Tuple

JOINT = ("data", "fsdp")


def zero_update_spec(path: Path, shape: Sequence[int],
                     mesh_shape: Dict[str, int]) -> Spec:
    """ZeRO-1 spec of one leaf: the joint ('data', 'fsdp') replica axis on
    the leaf's largest dim that the data extent divides (the first of
    equal dims), else () — updated replicated. This is the JAX
    function's choice at fsdp = model = 1; ValueError for the others."""
    for ax in ("fsdp", "model"):
        if mesh_shape.get(ax, 1) > 1:
            raise ValueError(f"zero_update_spec: mesh axis {ax} > 1 is not "
                             "ported yet (ROADMAP A11c)")
    data_n = mesh_shape.get("data", 1)
    if data_n == 1:
        return ()
    for ax in sorted(range(len(shape)), key=lambda i: shape[i],
                     reverse=True):
        if shape[ax] % data_n == 0:
            spec = [None] * len(shape)
            spec[ax] = JOINT
            return tuple(spec)
    return ()


def zero_dim(path: Path, shape: Sequence[int],
             mesh_shape: Dict[str, int]) -> Optional[int]:
    """The dim of a leaf that ZeRO-1 splits over the joint replica axis,
    or None when the leaf is updated whole on every replica (the JAX
    `_leaf_plan`'s "alltoall" case)."""
    spec = zero_update_spec(path, shape, mesh_shape)
    return spec.index(JOINT) if spec else None


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
    """The rows one data rank feeds of a global batch of `batch_size`
    (the port's `batch_sharding`: the batch splits over the joint replica
    axis). ValueError when it does not split evenly."""
    if batch_size % data_extent:
        raise ValueError(
            f"global batch {batch_size} does not split evenly over the "
            f"data*fsdp extent {data_extent}: each data rank feeds "
            "batch_size / data rows")
    return batch_size // data_extent
