"""The port's mesh layout rules (`parallel/sharding.py`), its per-rank
state bytes (`zero.per_chip_state_bytes`) and its resharding schedule
(`parallel/reshard.py`) against the JAX package's, from shapes alone —
no process group, no spawned rank.

The JAX rules run on `jax.eval_shape` of the JAX trees of the `tiny`,
`base` and `large` presets, the port's on its own leaves; a block leaf
of the port is the JAX stacked leaf without its leading num_blocks axis,
so the JAX spec is compared with that entry dropped (and that entry must
be None: no rule splits the stacked axis). Meshes: data=2 x fsdp=2 x
model=2, fsdp=4, model=3 (the GO head's split at A = 8943), model=4 (the
`large` preset's own: no split), data=4 x fsdp=2 (ZeRO-1). The JAX
`reshard_schedule_bytes` compiles the redistribution and reads output
bytes off its HLO; the port prices the same move from the rules in wire
bytes, so their kinds must agree and the port's bytes are held against a
hand count, the JAX figure printed beside it.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from proteinbert_tpu import configs as jconfigs
from proteinbert_tpu.parallel import reshard as jreshard
from proteinbert_tpu.parallel import zero as jzero
from proteinbert_tpu.parallel.sharding import _leaf_spec as j_leaf_spec
from proteinbert_tpu.parallel.sharding import (
    batch_sharding as j_batch_sharding,
    serve_batch_sharding as j_serve_batch_sharding,
    zero_update_spec as j_zero_update_spec,
)
from proteinbert_tpu.train import train_state as jts
from proteinbert_tpu_torch import configs as tconfigs
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.parallel import reshard, sharding
from proteinbert_tpu_torch.parallel.mesh import Mesh
from proteinbert_tpu_torch.parallel.zero import per_chip_state_bytes

torch.set_num_threads(1)

MESHES = {
    "data2-fsdp2-model2": dict(data=2, fsdp=2, model=2),
    "fsdp4": dict(fsdp=4),
    "model3": dict(model=3),
    "model4": dict(model=4),
    "data4-fsdp2": dict(data=4, fsdp=2),
}
PRESETS = ("tiny", "base", "large")


def _shape(mesh):
    return {"data": 1, "fsdp": 1, "model": 1, "seq": 1, **MESHES[mesh]}


@functools.lru_cache(maxsize=None)
def _jax_abstract(preset):
    cfg = jconfigs.get_preset(preset)
    return jax.eval_shape(lambda: jts.create_train_state(
        jax.random.PRNGKey(0), cfg))


def _keys(path):
    return tuple(getattr(p, "key", getattr(p, "name", None)) for p in path)


def _jax_specs(preset, mesh_shape, fn):
    """{port path: JAX spec with the stacked entry dropped} of each params
    leaf, every block i of the port mapped onto the stacked leaf."""
    mesh = types.SimpleNamespace(shape=mesh_shape)
    n_blocks = jconfigs.get_preset(preset).model.num_blocks
    out = {}

    def record(path, leaf):
        keys = _keys(path)
        spec = list(fn(path, leaf, mesh))
        spec += [None] * (len(leaf.shape) - len(spec))
        if keys[0] == "blocks":
            assert spec[0] is None, f"JAX split the stacked axis of {keys}"
            for i in range(n_blocks):
                out[("blocks", i) + keys[1:]] = (tuple(spec[1:]),
                                                 leaf.shape[1:])
        else:
            out[keys] = (tuple(spec), leaf.shape)

    jax.tree_util.tree_map_with_path(record, _jax_abstract(preset).params)
    return out


@functools.lru_cache(maxsize=None)
def _port_leaves(preset):
    params = tmodel.abstract_params(tconfigs.get_preset(preset).model)
    return [(path, tuple(t.shape)) for path, t in
            sharding.leaf_paths(params)]


def _padded(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("rule", ["leaf_spec", "zero_update_spec"])
def test_rules_match_jax_on_every_leaf(preset, mesh, rule):
    mesh_shape = _shape(mesh)
    jfn, tfn = {"leaf_spec": (j_leaf_spec, sharding.leaf_spec),
                "zero_update_spec": (j_zero_update_spec,
                                     sharding.zero_update_spec)}[rule]
    want = _jax_specs(preset, mesh_shape, jfn)
    leaves = _port_leaves(preset)
    assert len(leaves) == len(want)
    for path, shape in leaves:
        spec, jshape = want[path]
        assert tuple(jshape) == shape, path
        got = tfn(path, shape, mesh_shape)
        assert _padded(got, len(shape)) == spec, (path, got, spec)


def test_large_block_vectors_shard_and_model4_splits_nothing():
    """The two facts of the rules at `large` widths: under fsdp=2 a block's
    bias and LN scale (1-D here, (12, 1024) stacked in JAX) are FSDP
    shards; at the preset's own model=4 (A = 8943 = 3·11·271) nothing is
    cut over `model`, and at model=3 the head splits into 2981 columns."""
    fsdp2 = {"data": 1, "fsdp": 2, "model": 1, "seq": 1}
    vectors = [(p, s) for p, s in _port_leaves("large")
               if p[0] == "blocks" and len(s) == 1]
    assert len(vectors) == 12 * 14
    for path, shape in vectors:
        assert sharding.leaf_spec(path, shape, fsdp2) == ("fsdp",), path
    for m, cols in ((4, None), (3, 2981)):
        mesh_shape = dict(fsdp2, fsdp=1, model=m)
        split = {p: sharding.shard_shape(s, sharding.leaf_spec(
            p, s, mesh_shape), mesh_shape)
            for p, s in _port_leaves("large")
            if "model" in sharding.leaf_spec(p, s, mesh_shape)}
        if cols is None:
            assert split == {}
        else:
            assert split == {("global_in", "kernel"): (cols, 1024),
                             ("global_head", "kernel"): (1024, cols),
                             ("global_head", "bias"): (cols,)}


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_batch_sharding_matches_jax(kind):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(
        1, 1, 1, 1), ("data", "fsdp", "model", "seq"))
    jfn, tfn = {"train": (j_batch_sharding, sharding.batch_sharding),
                "serve": (j_serve_batch_sharding,
                          sharding.serve_batch_sharding)}[kind]
    want = {k: tuple(v.spec) for k, v in jfn(mesh).items()}
    assert tfn(dict(mesh.shape)) == want


def _port_state(preset):
    """What `per_chip_state_bytes` reads of a state: the params (their
    shapes, on the meta device) and the plateau scalars (none here)."""
    return types.SimpleNamespace(
        params=tmodel.abstract_params(tconfigs.get_preset(preset).model),
        opt_state=types.SimpleNamespace(plateau=None))


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero1"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
def test_per_chip_state_bytes_match_jax(preset, mesh, zero):
    """The port's params and Adam moments a rank against the JAX
    function's (its opt_state less the optimizer's scalar leaves)."""
    mesh_shape = _shape(mesh)
    jmesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:int(np.prod(list(mesh_shape.values())))])
        .reshape(tuple(mesh_shape.values())), tuple(mesh_shape))
    abstract = _jax_abstract(preset)
    want = jzero.per_chip_state_bytes(jmesh, abstract, zero_update=zero)
    scalars = sum(np.dtype(leaf.dtype).itemsize for leaf in
                  jax.tree_util.tree_leaves(abstract.opt_state)
                  if leaf.ndim == 0)
    got = per_chip_state_bytes(Mesh(shape=mesh_shape, rank=0, coords={
        a: 0 for a in mesh_shape}), _port_state(preset), zero_update=zero)
    assert got["params"] == want["params"]
    assert got["opt_state"] == want["opt_state"] - scalars


@pytest.mark.parametrize("spec", ["4x2", "8x1x1x1", "1", "data=4,fsdp=2",
                                  "seq=2", " 2X3 ", "model=3"])
def test_parse_mesh_spec_matches_jax(spec):
    assert reshard.parse_mesh_spec(spec).shape == \
        jreshard.parse_mesh_spec(spec).shape
    want = jreshard.mesh_from_config(jreshard.parse_mesh_spec(spec))
    got = reshard.mesh_from_config(reshard.parse_mesh_spec(spec))
    assert (got is None) == (want is None)
    if got is not None:
        assert got.shape == dict(want.shape)


@pytest.mark.parametrize("spec", ["", "2x2x2x2x2", "bogus=2", "4xtwo",
                                  "0x4", "data=0,fsdp=4", "-2", "data2"])
def test_parse_mesh_spec_refuses_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jreshard.parse_mesh_spec(spec)
    with pytest.raises(ValueError) as got:
        reshard.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


# The grid of tests/test_reshard.py, its config.
GRID = [(a, b) for a in ("1", "4x2", "8x1") for b in ("1", "4x2", "8x1")
        if a != b] + [("4x2", "4x2")]


def _grid_cfg(mod):
    return mod.PretrainConfig(model=mod.ModelConfig(
        local_dim=16, global_dim=32, key_dim=8, num_heads=2, num_blocks=2,
        num_annotations=32, dtype="float32"))


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero1"])
@pytest.mark.parametrize("src,dst", GRID, ids=[f"{a}to{b}" for a, b in GRID])
def test_reshard_schedule_kind_matches_jax(src, dst, zero, capsys):
    """The port's schedule kind equals JAX's on every pair (on the same
    mesh: plain to plain, and plain to ZeRO-1); JAX's output bytes printed
    beside the port's wire bytes."""
    zs, zd = (False, zero) if src == dst else (zero, zero)
    want, wkind = jreshard.reshard_schedule_bytes(
        _grid_cfg(jconfigs), jreshard.mesh_from_config(
            jreshard.parse_mesh_spec(src)),
        jreshard.mesh_from_config(jreshard.parse_mesh_spec(dst)), zs, zd)
    got, kind = reshard.reshard_schedule_bytes(
        _grid_cfg(tconfigs), reshard.mesh_from_config(
            reshard.parse_mesh_spec(src)),
        reshard.mesh_from_config(reshard.parse_mesh_spec(dst)), zs, zd)
    assert kind == wkind
    assert (got["total"] > 0) == (kind == "collective")
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    with capsys.disabled():
        print(f"\n  reshard {src} -> {dst} zero {zs}->{zd}: {kind}; JAX HLO "
              f"output bytes {want}; port wire bytes {got}")


def test_reshard_schedule_bytes_against_a_hand_count():
    """4x2 -> 8x1, plain: every leaf the rules cut over fsdp=2 at 4x2 is
    whole at 8x1, so its params and two moments are all-gathered over two
    ranks: (2-1)/2 of the leaf's bytes each on the wire. 8x1 -> 4x2 moves
    nothing (each rank slices). 4x2 plain -> ZeRO-1: a moment the rule
    widens to the joint axis on its fsdp dim is a piece rank (d, f) does
    not hold: one collective-permute of the piece (a 1/8 of the leaf) a
    moment."""
    cfg = _grid_cfg(tconfigs)
    m42 = reshard.mesh_from_config(reshard.parse_mesh_spec("4x2"))
    m81 = reshard.mesh_from_config(reshard.parse_mesh_spec("8x1"))
    leaves = _leaves_of(cfg)
    fsdp = [(p, s) for p, s in leaves
            if "fsdp" in sharding.param_spec(p, s, m42.shape)]
    assert fsdp
    got, _ = reshard.reshard_schedule_bytes(cfg, m42, m81)
    assert got["all-gather"] == got["total"] == sum(
        3 * int(np.prod(s)) * 4 // 2 for _, s in fsdp)
    got, kind = reshard.reshard_schedule_bytes(cfg, m81, m42)
    assert kind == "identity" and got["total"] == 0
    widened = [(p, s) for p, s in fsdp
               if sharding.JOINT in sharding.zero_update_spec(
                   p, s, m42.shape)]
    got, _ = reshard.reshard_schedule_bytes(cfg, m42, m42, False, True)
    assert got["collective-permute"] == got["total"] == sum(
        2 * int(np.prod(s)) * 4 // 8 for _, s in widened)


def _leaves_of(cfg):
    return [(p, tuple(t.shape)) for p, t in
            sharding.leaf_paths(tmodel.abstract_params(cfg.model))]
