"""Mesh-agnostic checkpoint resharding — port of
`proteinbert_tpu/parallel/reshard.py` (`parse_mesh_spec`,
`mesh_from_config`, `tree_digest`, `states_byte_identical`,
`reshard_schedule_bytes`, `reshard_checkpoint`) and of the `pbt
reshard` verb's work.

A port step file is full-shape whatever layout wrote it
(`train/checkpoint.py`: the fsdp and model shards and the ZeRO pieces are
gathered to rank 0 before the write, and sliced on restore). So moving a
run to another mesh needs no restore onto the target's devices: the
verb reads the step, checks it against the run's config, writes it into
a fresh run directory whose config.json records the target mesh (and
the ZeRO choice), and re-reads it for the byte-parity gate. The JAX
verb restores through orbax onto a template placed on the target mesh,
and therefore refuses a target larger than the machine; the port's verb
needs none of the target's cards and does not refuse it.

`reshard_schedule_bytes` prices the move that a LIVE redistribution
between the two layouts would make on the same ranks. The JAX function
compiles that program and reads its HLO; the port has no HLO, so it
works the move out from the rules (`sharding.param_spec`,
`zero_update_spec`) leaf by leaf: each rank's source and target boxes
of the leaf, and the collective that turns one into the other —

- none where every rank's target box lies inside its source box (a
  local slice: replicated → sharded, or a finer cut of the same dim);
- an all-gather where every target box is a union of source boxes
  (sharded → replicated, or a coarser cut), over as many ranks as one
  target box holds source boxes;
- an all-to-all where the boxes are as large as each other but cut
  differently (a moment's ZeRO dim moving);
- a collective-permute where each target box lies whole inside some
  rank's source box (a ZeRO piece of the joint axis, which the JAX order
  d·fsdp + f places outside this rank's fsdp shard);
- otherwise an all-gather of the leaf over its source cut, then a slice;

each priced with `zero.wire_bytes` on the target box's bytes (per rank,
the ring factors of the JAX HLO reader). The kind is "host_staged" (no
bytes) when the two meshes hold different device counts, "identity" when
nothing moves, else "collective", as in JAX.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch.configs import MeshConfig

logger = logging.getLogger(__name__)


# ------------------------------------------------------------- mesh specs

def parse_mesh_spec(spec: str) -> MeshConfig:
    """Parse a CLI mesh spec into a MeshConfig.

    Accepted forms: `"4x2"` (data×fsdp), `"4x2x1x1"`
    (data×fsdp×model×seq), `"1"` (single device — no mesh), or
    key=value pairs `"data=4,fsdp=2"`. Axis order follows
    MeshConfig.axis_names.
    """
    spec = spec.strip().lower()
    if not spec:
        raise ValueError("empty mesh spec")

    def extent(raw) -> int:
        n = int(raw)
        if n < 1:
            # A zero/negative axis would silently degrade to the
            # single-device layout (num_devices 0 -> "no mesh") and
            # rewrite config.json with a nonsense topology — reject.
            raise ValueError(f"mesh axis extent must be >= 1, got {n}")
        return n

    if "=" in spec:
        axes: Dict[str, int] = {}
        for part in spec.split(","):
            if "=" not in part:
                raise ValueError(f"bad mesh spec fragment {part!r} "
                                 "(expected axis=extent)")
            k, v = part.split("=", 1)
            k = k.strip()
            if k not in MeshConfig().axis_names:
                raise ValueError(f"unknown mesh axis {k!r}; have "
                                 f"{MeshConfig().axis_names}")
            axes[k] = extent(v)
        return MeshConfig(**axes)
    dims = [extent(d) for d in spec.split("x")]
    if len(dims) > 4:
        raise ValueError(f"mesh spec {spec!r} has {len(dims)} axes; "
                         "at most data x fsdp x model x seq")
    dims += [1] * (4 - len(dims))
    return MeshConfig(data=dims[0], fsdp=dims[1], model=dims[2],
                      seq=dims[3])


def mesh_from_config(mesh_cfg: MeshConfig):
    """The layout a MeshConfig describes — a `parallel.mesh.Mesh` seen from
    rank 0, with no process groups (the rules read only its `shape`) — or
    None for the single-device (unsharded) layout, as in JAX."""
    if mesh_cfg.num_devices <= 1:
        return None
    from proteinbert_tpu_torch.parallel.mesh import AXES, Mesh

    return Mesh(shape=dict(zip(AXES, mesh_cfg.shape)), rank=0,
                coords={ax: 0 for ax in AXES})


# ------------------------------------------------- the redistribution

def _state_leaves(cfg, zero: bool, mesh_shape: Dict[str, int]):
    """(name, shape, itemsize, spec) of every params and moments leaf of
    the train state of `cfg` laid out on `mesh_shape`."""
    from proteinbert_tpu_torch.models.proteinbert import abstract_params
    from proteinbert_tpu_torch.parallel.sharding import (
        leaf_paths, param_spec, zero_update_spec,
    )

    for path, t in leaf_paths(abstract_params(cfg.model)):
        shape = tuple(t.shape)
        store = param_spec(path, shape, mesh_shape)
        moment = zero_update_spec(path, shape, mesh_shape) if zero else store
        for part, spec in (("params", store), ("mu", moment),
                           ("nu", moment)):
            yield (part,) + path, shape, t.element_size(), spec


def _boxes(shape: Sequence[int], spec, mesh_shape: Dict[str, int]):
    """Each rank's [lo, hi) a dim of a leaf laid out by `spec`, ranks in
    mesh order (data-major)."""
    from proteinbert_tpu_torch.parallel.mesh import AXES

    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for coords in itertools.product(*(range(mesh_shape[a]) for a in AXES)):
        at = dict(zip(AXES, coords))
        box = []
        for size, e in zip(shape, entries):
            names = () if e is None else (e if isinstance(e, tuple)
                                          else (e,))
            idx, n = 0, 1
            for name in names:
                idx, n = idx * mesh_shape[name] + at[name], \
                    n * mesh_shape[name]
            step = size // n
            box.append((idx * step, (idx + 1) * step))
        out.append(tuple(box))
    return out


def _inside(a, b) -> bool:
    """Box a lies inside box b."""
    return all(b0 <= a0 and a1 <= b1 for (a0, a1), (b0, b1) in zip(a, b))


def _volume(box) -> int:
    return int(np.prod([hi - lo for lo, hi in box])) if box else 1


def _move_of(shape: Sequence[int], itemsize: int, src_spec,
            src_mesh: Dict[str, int], dst_spec,
            dst_mesh: Dict[str, int]) -> Optional[Tuple[str, int, int]]:
    """The collective that turns one leaf's source layout into its target
    layout on the same ranks (module docstring; rank r's boxes read on
    each mesh's own coordinates) → (kind, output bytes a rank, group
    size), or None when every rank slices locally."""
    src = _boxes(shape, src_spec, src_mesh)
    dst = _boxes(shape, dst_spec, dst_mesh)
    if all(_inside(d, s) for s, d in zip(src, dst)):
        return None
    out = _volume(dst[0]) * itemsize
    if all(_inside(s, d) for s, d in zip(src, dst)):
        return "all-gather", out, _volume(dst[0]) // _volume(src[0])
    full = _volume([(0, n) for n in shape])
    pieces = full // _volume(src[0])
    if _volume(src[0]) == _volume(dst[0]):
        return "all-to-all", out, pieces
    if all(any(_inside(d, s) for s in src) for d in dst):
        return "collective-permute", out, 2
    return "all-gather", full * itemsize, pieces


def reshard_schedule_bytes(
    cfg, source_mesh, target_mesh, source_zero: bool = False,
    target_zero: bool = False,
) -> Tuple[Dict[str, int], str]:
    """Per-rank wire bytes of the source→target redistribution, from the
    rules alone (module docstring; nothing is allocated or moved) →
    ({kind: bytes, ..., "total"}, schedule kind): "host_staged" with zero
    bytes when the meshes hold different device counts, "identity" when
    nothing moves, else "collective". A mesh is a `mesh_from_config`
    layout (None: one device)."""
    from proteinbert_tpu_torch.parallel.zero import COLLECTIVES, wire_bytes

    out = {k: 0 for k in COLLECTIVES}
    out["total"] = 0
    size = [1 if m is None else m.size for m in (source_mesh, target_mesh)]
    if size[0] != size[1]:
        return out, "host_staged"
    if source_mesh is None:
        return out, "identity"
    src = _state_leaves(cfg, source_zero, source_mesh.shape)
    dst = _state_leaves(cfg, target_zero, target_mesh.shape)
    for (_, shape, item, s_spec), (_, _, _, d_spec) in zip(src, dst):
        move = _move_of(shape, item, s_spec, source_mesh.shape, d_spec,
                       target_mesh.shape)
        if move is not None:
            kind, nbytes, n = move
            out[kind] += wire_bytes(kind, nbytes, n)
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out, "collective" if out["total"] else "identity"


# ------------------------------------------------------------- parity

def _bytes(v) -> bytes:
    if torch.is_tensor(v):
        t = v.detach().to("cpu").contiguous().reshape(-1)
        return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return repr(v).encode()


def tree_digest(state: Any) -> Dict[str, bytes]:
    """Canonical per-leaf byte image of a train state (a `TrainState`, or
    its checkpoint tree), keyed by tree path: two states compare equal
    iff their values are byte-identical."""
    from proteinbert_tpu_torch.train.checkpoint import state_tree

    tree = state if isinstance(state, dict) else state_tree(state)
    out: Dict[str, bytes] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        else:
            out[prefix] = _bytes(node)

    walk(tree, "")
    return out


def states_byte_identical(a: Any, b: Any) -> bool:
    return tree_digest(a) == tree_digest(b)


def _check_against(tree: Dict[str, Any], cfg, src: str, step: int) -> None:
    """ValueError unless the step's params and moments have the shapes of
    `cfg`'s model (the JAX restore's template check)."""
    from proteinbert_tpu_torch.models.proteinbert import abstract_params
    from proteinbert_tpu_torch.parallel.sharding import leaf_paths

    want = {p: tuple(t.shape)
            for p, t in leaf_paths(abstract_params(cfg.model))}
    params = dict(leaf_paths(tree.get("params") or {}))
    o = tree.get("opt_state") or {}
    shapes = [tuple(t.shape) for t in params.values()]
    if ({p: tuple(t.shape) for p, t in params.items()} != want
            or any([tuple(t.shape) for t in o.get(k) or []] != shapes
                   for k in ("mu", "nu"))):
        raise ValueError(
            f"{src} step {step}: its params or moments do not have the "
            "shapes of the run's config (model widths, num_annotations); "
            "pass the config the run was made with")


# ------------------------------------------------------ checkpoint verb

def reshard_checkpoint(
    src: str,
    dst: str,
    cfg=None,
    target_mesh_cfg: Optional[MeshConfig] = None,
    zero_update: Optional[bool] = None,
    step: Optional[int] = None,
    telemetry=None,
    verify: bool = True,
) -> Dict[str, Any]:
    """Carry `src`'s checkpoint to the target mesh layout: write it into
    run directory `dst` (config.json updated to the new topology and ZeRO
    choice, so training resumes there natively).

    - `cfg`: the source run's config; default: `src/config.json`.
    - `target_mesh_cfg`: target topology; default: cfg.mesh.
    - `zero_update`: the target's ZeRO-1 choice (default: the source
      config's parallel.zero_update).
    - `verify`: re-read the step from `dst` and byte-compare it with the
      one written (the round-trip parity gate).

    The step file is full-shape, so no device of either mesh is needed,
    and a target larger than this machine is not refused (the JAX
    function refuses it: orbax must place the shards). Returns the JAX
    summary (step, meshes, zero_update, schedule, wire_bytes, parity),
    sets the `reshard_wire_bytes{kind}` gauge and emits one `reshard`
    event when telemetry is enabled."""
    from proteinbert_tpu_torch.configs import load_config, save_config
    from proteinbert_tpu_torch.obs import as_telemetry
    from proteinbert_tpu_torch.train.checkpoint import Checkpointer

    tele = as_telemetry(telemetry)
    if cfg is None:
        path = os.path.join(src, "config.json")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{src} has no config.json; pass cfg= (CLI: "
                "--preset/--pretrained-set describing the source run)")
        cfg = load_config(path)
    if target_mesh_cfg is None:
        target_mesh_cfg = cfg.mesh
    if zero_update is None:
        zero_update = cfg.parallel.zero_update

    src_ck = Checkpointer(src, async_save=False)
    src_ck.on_note = lambda **f: tele.emit("note", **f)
    try:
        tree, data_state = src_ck.read(step)
    finally:
        src_ck.close()
    if tree is None:
        raise FileNotFoundError(f"no checkpoint found in {src}")
    restored_step = int(tree["step"])
    _check_against(tree, cfg, src, restored_step)

    wire_bytes, schedule = reshard_schedule_bytes(
        cfg, mesh_from_config(cfg.mesh), mesh_from_config(target_mesh_cfg),
        source_zero=cfg.parallel.zero_update, target_zero=bool(zero_update))
    for kind, n in wire_bytes.items():
        tele.metrics.gauge("reshard_wire_bytes", kind=kind).set(n)

    new_cfg = cfg.replace(
        mesh=target_mesh_cfg,
        parallel=dataclasses.replace(cfg.parallel,
                                     zero_update=bool(zero_update)))
    dst_ck = Checkpointer(dst, async_save=False)
    try:
        if not dst_ck.write(restored_step, tree, data_state):
            raise RuntimeError(
                f"{dst} already holds a checkpoint at step >= "
                f"{restored_step}; pick an empty/older output directory")
        parity = None
        if verify:
            back, _ = dst_ck.read(restored_step, fallback=False)
            parity = states_byte_identical(tree, back)
            if not parity:
                raise RuntimeError(
                    "round-trip parity FAILED: the state read back from "
                    f"{dst} is not byte-identical to the state just "
                    "written")
    finally:
        dst_ck.close()
    save_config(new_cfg, os.path.join(os.path.abspath(dst), "config.json"))

    summary = {
        "step": restored_step,
        "source_mesh": {k: int(v) for k, v in
                        zip(cfg.mesh.axis_names, cfg.mesh.shape)},
        "target_mesh": {k: int(v) for k, v in
                        zip(target_mesh_cfg.axis_names,
                            target_mesh_cfg.shape)},
        "zero_update": bool(zero_update),
        "schedule": schedule,
        "wire_bytes": wire_bytes,
        "parity": parity,
    }
    tele.emit("reshard", step=restored_step,
              target_mesh=summary["target_mesh"],
              wire_bytes=wire_bytes,
              source_mesh=summary["source_mesh"],
              zero_update=bool(zero_update), schedule=schedule,
              parity=parity, src=os.path.abspath(src),
              dst=os.path.abspath(dst))
    logger.info(
        "resharded %s step %d: %s -> %s (%s schedule, %d wire bytes%s)",
        src, restored_step, summary["source_mesh"], summary["target_mesh"],
        schedule, wire_bytes.get("total", 0),
        ", parity verified" if parity else "")
    return summary
