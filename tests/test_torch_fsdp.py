"""The port's sharded step on a data × fsdp × model mesh (`parallel/
fsdp.py`, `parallel/tensor_parallel.py`), its full-shape checkpoints,
`reshard_checkpoint` and `seq_parallel_conv1d`, on the CPU against the
JAX package on the same numpy-made inputs and weights.

Two spawned gloo groups (`tests/torch_mesh_child.py`) meet through a
FileStore under a temporary directory, each bounded by its own timeout:
- group A, four ranks at data=1 x fsdp=2 x model=2 with A = 64 (so the
  GO head splits into 32 columns a model rank): one step, plain and with
  ZeRO-1, against JAX `train_step` / `make_zero_train_step` on
  `make_mesh(MeshConfig(fsdp=2, model=2))` — loss rel 2e-5 and params
  atol 2e-5, the tolerances of tests/test_parallel.py, float32; the model
  replicas' replicated leaves bit for bit; rank 0's step file tensor by
  tensor a one-process save of the gathered state; then the same ranks
  at data=2 x fsdp=2 with ZeRO-1 (the moments cut again over data inside
  each fsdp shard) against JAX's ZeRO-1 step on that mesh; then the
  sequence-parallel step on the sharded layout, at fsdp=2 x seq=2 and
  model=2 x seq=2 with C=128 and `use_pallas` (so that the JAX step runs
  its Pallas kernel in interpret mode), plain and with ZeRO-1 in fp32
  and bf16, against JAX `make_seq_parallel_train_step` on the same mesh
  from `shard_train_state`'s sharded state: loss rel 2e-5, params atol
  2e-5, the gradient norm rel 2e-6 and each leaf's first moments rel
  4e-6 (two float32 backward passes, torch's convs against the Pallas
  kernel's, differ at 1e-6: CPU readings 8.4e-7 and 1.2e-6); on the
  bf16 route, JAX's cast of the reduced gradients, the norm is the fp32
  route's bit for bit (taken before the cast) and the moments within
  2.5e-4 of JAX's (reading 4.8e-5: the 1e-6 gradient differences round
  some elements to the other bf16 neighbour; a stochastically rounded
  wire lands near 2e-3); the model and seq replicas bit for bit, the
  stored bytes, the
  step file, and `reshard_checkpoint` of the fsdp x seq step file to one
  device (and back) resumed by one process within 1e-5. The JAX steps
  run while the ranks do;
- group B, two ranks at fsdp=2: three steps with a checkpoint at step 2,
  `reshard_checkpoint` of that step to one device (parity, the event),
  and a one-process resume whose step-3 loss is the fsdp run's within
  1e-5, as is the fsdp run's pooled eval at step 3 against one process's
  eval of the same rows; then `seq_parallel_conv1d` on a seq=2 mesh of
  the same ranks
  against the JAX function within atol 1e-5.
The corruption is the identity (so that the JAX key and the port's
generator draw alike).
"""

import dataclasses
import functools
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu import configs as jconfigs
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.parallel import (
    batch_sharding, make_mesh as j_make_mesh, shard_train_state,
)
from proteinbert_tpu.parallel import quant as jquant
from proteinbert_tpu.parallel import zero as jzero
from proteinbert_tpu.parallel.halo import (
    seq_parallel_conv1d as j_seq_parallel_conv1d,
)
from proteinbert_tpu.parallel.seq_parallel import (
    make_seq_parallel_train_step as j_make_seq_step,
)
from proteinbert_tpu.train import train_state as jts
from proteinbert_tpu.train.schedule import make_optimizer as j_make_opt
from proteinbert_tpu_torch import configs as tconfigs
from proteinbert_tpu_torch.obs import Telemetry, read_events
from proteinbert_tpu_torch.parallel.reshard import (
    parse_mesh_spec, reshard_checkpoint,
)
from proteinbert_tpu_torch.parallel.sharding import leaf_paths
from proteinbert_tpu_torch.train import Checkpointer
from proteinbert_tpu_torch.train import train_state as tts
from proteinbert_tpu_torch.train.schedule import OptState
from proteinbert_tpu_torch.train.trainer import pretrain
from proteinbert_tpu_torch.weights import params_from_flat
from tests import torch_mesh_child
from tests.test_torch_data_parallel import (
    IDENTITY, MODEL, QUANT_BOUNDS, _spawn, _tokens,
)

torch.set_num_threads(1)

CONSTANT = dict(schedule="constant", learning_rate=1e-4, warmup_steps=0,
                weight_decay=0.01, grad_clip_norm=0.1)
STEP = {"data": dict(seq_len=32, batch_size=8, **IDENTITY),
        "optimizer": CONSTANT, "mesh": {"fsdp": 2, "model": 2}}
SPEC = {
    "model": MODEL,
    "plain": STEP,
    "zero": dict(STEP, parallel=dict(zero_update=True)),
    # ZeRO-1 pieces cut from the fsdp shards over a data axis of 2.
    "zero_dp": dict(STEP, mesh={"data": 2, "fsdp": 2},
                    parallel=dict(zero_update=True)),
    "resume": {"data": dict(seq_len=32, batch_size=8, **IDENTITY),
               "optimizer": dict(CONSTANT, learning_rate=1e-3),
               "mesh": {"fsdp": 2},
               "train": dict(max_steps=3, log_every=1, eval_every=3),
               "checkpoint": dict(every_steps=2, async_save=False),
               "batches": 3},
    "conv_dilation": 5,
}
# The quantized reduce-scatter at data=2 x fsdp=2 (group A's ranks): the
# JAX quantization test's optimizer (tests/test_quant.py:47-60: LR 0 at
# step 1, 1e-4 at step 2), the identity corruption, two steps on one
# batch of 16; "quant" is the fp32 reference step on the same mesh.
QUANT = {"data": dict(seq_len=32, batch_size=16, **IDENTITY),
         "optimizer": dict(learning_rate=1e-3, warmup_steps=10),
         "mesh": {"data": 2, "fsdp": 2}}
SPEC["quant"] = QUANT
for _p in ("fp32", "bf16", "int8", "int8_again"):
    SPEC[f"q_{_p}"] = dict(QUANT, parallel=dict(
        zero_update=True,
        grad_reduce_dtype="bf16" if _p == "bf16" else "int8"))
PAYLOADS = ("fp32", "bf16", "int8")
# The sequence-parallel step on the sharded layout (group A's ranks after
# the quantized legs): C=128 so that the JAX step runs its Pallas kernel
# (interpret mode), A=64 so that model=2 splits the GO head; B=4 (two
# rows a replica at fsdp=2), L=64 (32 a seq rank).
SPEC["seq_model"] = dict(MODEL, local_dim=128, use_pallas=True)
SEQ_STEP = {"data": dict(seq_len=64, batch_size=4, **IDENTITY),
            "optimizer": CONSTANT,
            "train": dict(max_steps=2, log_every=1)}
SEQ_MESHES = {"sf": {"fsdp": 2, "seq": 2}, "sm": {"model": 2, "seq": 2}}
SEQ_ROUTES = {"plain": {}, "zero": dict(zero_update=True),
              "zero_bf16": dict(zero_update=True, grad_reduce_dtype="bf16")}
for _m, _axes in SEQ_MESHES.items():
    for _r, _par in SEQ_ROUTES.items():
        SPEC[f"{_m}_{_r}"] = dict(SEQ_STEP, mesh=_axes, parallel=_par)
SEQ_TAGS = tuple(f"{m}_{r}" for m in SEQ_MESHES for r in SEQ_ROUTES)
SPEC["seq_tags"] = list(SEQ_TAGS)
SEQ_FSDP_TAGS = tuple(t for t in SEQ_TAGS if t.startswith("sf_"))
SEQ_MODEL_TAGS = tuple(t for t in SEQ_TAGS if t.startswith("sm_"))
# Against JAX's step (module docstring): the gradient norm, and each
# leaf's first moments by route.
NORM_SEQ_REL = 2e-6
MU_SEQ_REL = {"plain": 4e-6, "zero": 4e-6, "zero_bf16": 2.5e-4}
# The reduction's own error, as relative bounds: the gradient norm
# against the fp32 step's and JAX's (CPU readings at most 8.7e-8 /
# 4.0e-5 / 1.4e-4, fp32 / bf16 / int8), and each leaf's first moment
# against the fp32 step's (1.5e-7 / 2.0e-3 / 9.8e-3: a bf16 value rounds
# to 2^-8 of itself, an int8 chunk to amax/127).
NORM_REL = {"fp32": 1e-6, "bf16": 2e-4, "int8": 5e-4}
MU_REL = {"fp32": 1e-6, "bf16": 5e-3, "int8": 2.5e-2}
TAGS = ("plain", "zero", "zero_dp")
LOSS_REL = 2e-5
PARAMS_ATOL = 2e-5


def _cfg(mod, name):
    c = SPEC[name]
    return mod.PretrainConfig(
        model=mod.ModelConfig(**(SPEC["seq_model"] if name in SEQ_TAGS
                                 else MODEL)),
        data=mod.DataConfig(**c["data"]),
        optimizer=mod.OptimizerConfig(**c["optimizer"]),
        mesh=mod.MeshConfig(**c["mesh"]),
        parallel=mod.ParallelConfig(**c.get("parallel", {})),
        train=mod.TrainConfig(**c.get("train", {})),
        checkpoint=mod.CheckpointConfig(**c.get("checkpoint", {})))


@functools.lru_cache(maxsize=2)
def _jax_params(seq: bool = False):
    cfg = jconfigs.ModelConfig(**(SPEC["seq_model"] if seq else MODEL))
    return jax.jit(lambda key: jmodel.init(key, cfg))(jax.random.PRNGKey(0))


def _prefix(tag):
    """The inputs' key prefix of the params a leg starts from."""
    return "sp:" if tag in SEQ_TAGS else "p:"


def _jax_state(cfg, seq=False):
    params = jax.tree.map(jnp.array, _jax_params(seq))
    return jts.TrainState(step=jnp.int32(0), params=params,
                          opt_state=j_make_opt(cfg.optimizer).init(params),
                          key=jax.random.PRNGKey(0))


def _inputs(out, arrays, seq=False):
    (out / "spec.json").write_text(json.dumps(SPEC))
    flat = flatten_params(_jax_params())
    if seq:
        arrays = dict(arrays, **{f"sp:{k}": v for k, v in flatten_params(
            _jax_params(True)).items()})
    np.savez(out / "inputs.npz", **{f"p:{k}": v for k, v in flat.items()},
             **arrays)


def _jax_seq_steps(seq_batches):
    """JAX's `make_seq_parallel_train_step` on each seq mesh from
    `shard_train_state`'s sharded state, one step on the first batch →
    {tag: (loss, grad_norm, flat params, flat first moments)}. On
    model=2 x seq=2 data·fsdp is 1, so JAX's ZeRO routes take its plain
    path (zero_extent = 1): one step serves the three tags there."""
    want = {}
    for tag in SEQ_TAGS:
        if tag in SEQ_MODEL_TAGS and tag != "sm_plain":
            want[tag] = want["sm_plain"]
            continue
        jcfg = _cfg(jconfigs, tag)
        mesh = j_make_mesh(jcfg.mesh, jax.devices()[:4])
        bsh = batch_sharding(mesh)
        batch = {k: jax.device_put(v, bsh[k])
                 for k, v in seq_batches[0].items()}
        state = shard_train_state(_jax_state(jcfg, seq=True), mesh,
                                  zero_update=jcfg.parallel.zero_update)
        new, m = j_make_seq_step(mesh, jcfg)(state, batch)
        mu = [s for s in jax.tree_util.tree_leaves(
            new.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0].mu
        want[tag] = (float(m["loss"]), float(m["grad_norm"]),
                     flatten_params(jax.device_get(new.params)),
                     flatten_params(jax.device_get(mu)))
    return want


@pytest.fixture(scope="module")
def group_a(tmp_path_factory):
    """Four ranks at fsdp=2 x model=2 (`torch_mesh_child.fsdp_model`), and
    JAX's plain and ZeRO-1 steps on that mesh from the same state."""
    out = tmp_path_factory.mktemp("mesh_a")
    rng = np.random.default_rng(20)
    tokens, ann = _tokens(rng, 8, 32)
    q_tokens, q_ann = _tokens(rng, 16, 32)
    arrays = {"tokens": tokens, "annotations": ann,
              "quant:tokens": q_tokens, "quant:annotations": q_ann}
    seq_batches = []
    for b in (0, 1):
        t, a = _tokens(rng, 4, 64)
        seq_batches.append({"tokens": t, "annotations": a})
        arrays.update({f"seq{b}:tokens": t, f"seq{b}:annotations": a})
    _inputs(out, arrays, seq=True)
    t0 = time.perf_counter()
    ranks, want = _spawn(torch_mesh_child.fsdp_model, 4, out,
                         lambda: _group_a_jax(tokens, ann, q_tokens, q_ann,
                                              seq_batches))
    print(f"spawn and JAX {time.perf_counter() - t0:.1f} s")
    return ranks, want, out


def _group_a_jax(tokens, ann, q_tokens, q_ann, seq_batches):
    """JAX's steps of group A's legs on the same meshes and rows."""
    want = {}
    for tag in TAGS:
        jcfg = _cfg(jconfigs, tag)
        mesh = j_make_mesh(jcfg.mesh, jax.devices()[:4])
        bsh = batch_sharding(mesh)
        batch = {k: jax.device_put(v, bsh[k])
                 for k, v in (("tokens", tokens), ("annotations", ann))}
        zero = jcfg.parallel.zero_update
        state = shard_train_state(_jax_state(jcfg), mesh, zero_update=zero)
        step = (jzero.make_zero_train_step(mesh, jcfg) if zero
                else functools.partial(jts.train_step, cfg=jcfg))
        new, m = step(state, batch)
        want[tag] = (float(m["loss"]), float(m["grad_norm"]),
                     flatten_params(jax.device_get(new.params)))
    # JAX's quantized step on the same mesh, two steps at each payload.
    jcfg = _cfg(jconfigs, "q_int8")
    mesh = j_make_mesh(jcfg.mesh, jax.devices()[:4])
    bsh = batch_sharding(mesh)
    batch = {k: jax.device_put(v, bsh[k])
             for k, v in (("tokens", q_tokens), ("annotations", q_ann))}
    for payload in PAYLOADS:
        state = shard_train_state(_jax_state(jcfg), mesh, zero_update=True)
        step = jquant.make_quant_zero_train_step(mesh, jcfg, payload=payload)
        for _ in range(2):
            state, m = step(state, batch)
        want[f"q_{payload}"] = (float(m["loss"]), float(m["grad_norm"]),
                                flatten_params(jax.device_get(state.params)))
    want.update(_jax_seq_steps(seq_batches))
    want["seq_batches"] = seq_batches
    return want


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_step_matches_jax(group_a, tag):
    """Every rank's loss and gathered params after one step against JAX's
    step on the same mesh; the GO head really split (32 of 64 columns a
    model rank) where the mesh has a model axis; the step moved the
    params."""
    ranks, want, _ = group_a
    loss, norm, params = want[tag]
    flat0 = flatten_params(_jax_params())
    cols = 32 if SPEC[tag]["mesh"].get("model", 1) == 2 else -1
    for r in ranks:
        assert int(r[f"{tag}:tp_cols"]) == cols
        assert float(r[f"{tag}:loss"]) == pytest.approx(loss, rel=LOSS_REL)
        assert float(r[f"{tag}:grad_norm"]) == pytest.approx(norm, rel=1e-4)
        for k, v in params.items():
            np.testing.assert_allclose(r[f"{tag}:p:{k}"], np.asarray(v),
                                       atol=PARAMS_ATOL, err_msg=k)
    moved = max(float(np.abs(ranks[0][f"{tag}:p:{k}"] - v).max())
                for k, v in flat0.items())
    assert moved > 5e-5


def _replica_pairs(tag, axis):
    """Pairs of group A's ranks on `tag`'s mesh whose coordinates differ
    only along `axis` (at index 0 and 1 of it)."""
    shape = tconfigs.MeshConfig(**SPEC[tag]["mesh"]).shape
    grid = np.arange(4).reshape(shape)
    ax = ("data", "fsdp", "model", "seq").index(axis)
    lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
    return [(int(line[0]), int(line[1])) for line in lines]


@pytest.mark.parametrize("tag", ["plain", "zero", *SEQ_MODEL_TAGS])
def test_model_replicas_stay_bit_identical(group_a, tag):
    """Ranks that differ only in their model coordinate hold the same
    rows: every stored tensor the model axis does not shard, and its
    moment, bit for bit; the model-sharded ones differ (different
    columns)."""
    ranks, _, _ = group_a
    n = sum(1 for k in ranks[0] if k.startswith(f"{tag}:local:"))
    split = 0
    for i0, i1 in _replica_pairs(tag, "model"):
        a, b = ranks[i0], ranks[i1]
        for i in range(n):
            if str(a[f"{tag}:stored:{i}"]) == "model":
                split += 1
                assert not np.array_equal(a[f"{tag}:local:{i}"],
                                          b[f"{tag}:local:{i}"])
                continue
            np.testing.assert_array_equal(a[f"{tag}:local:{i}"],
                                          b[f"{tag}:local:{i}"])
            np.testing.assert_array_equal(a[f"{tag}:mu_local:{i}"],
                                          b[f"{tag}:mu_local:{i}"])
    assert split == 2 * 3   # global_head kernel and bias, global_in kernel


@pytest.mark.parametrize("tag", SEQ_TAGS)
def test_seq_sharded_step_matches_jax(group_a, tag):
    """The sequence-parallel step on the sharded layout against JAX's
    `make_seq_parallel_train_step` on the same mesh, one step from the
    same params and rows: every rank's loss, gradient norm, gathered
    params and each leaf's gathered first moments; the GO head split
    where the mesh has a model axis; the step moved the params."""
    ranks, want, _ = group_a
    loss, norm, params, mu = want[tag]
    flat0 = flatten_params(_jax_params(True))
    bound = MU_SEQ_REL[tag.split("_", 1)[1]]
    for r in ranks:
        if tag.endswith("_bf16"):   # the cast comes after the norm
            assert r[f"{tag}:grad_norm"] == r[f"{tag[:-5]}:grad_norm"]
        assert float(r[f"{tag}:loss"]) == pytest.approx(loss, rel=LOSS_REL)
        assert float(r[f"{tag}:grad_norm"]) == pytest.approx(
            norm, rel=NORM_SEQ_REL)
        for k, v in params.items():
            np.testing.assert_allclose(r[f"{tag}:p:{k}"], np.asarray(v),
                                       atol=PARAMS_ATOL, err_msg=k)
        for k, v in mu.items():
            ref = np.asarray(v, np.float64)
            got = r[f"{tag}:mu_flat:{k}"].astype(np.float64)
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= bound, (k, rel)
    stored = {str(ranks[0][k]) for k in ranks[0]
              if k.startswith(f"{tag}:stored:")}
    assert stored == ({"", "model"} if tag in SEQ_MODEL_TAGS
                      else {"", "fsdp"})
    moved = max(float(np.abs(ranks[0][f"{tag}:p:{k}"] - v).max())
                for k, v in flat0.items())
    assert moved > 5e-5


def test_pretrain_takes_the_seq_step_on_the_sharded_layout(group_a):
    """`pretrain` on the fsdp=2 x seq=2 mesh routes to the same step: its
    two losses are the step's, bit for bit, on every rank."""
    ranks, _, _ = group_a
    tag = SEQ_FSDP_TAGS[0]
    for r in ranks:
        np.testing.assert_array_equal(
            r["seq_pretrain:losses"],
            [float(r[f"{tag}:loss"]), float(r[f"{tag}:loss2"])])


@pytest.mark.parametrize("tag", SEQ_TAGS)
def test_seq_replicas_stay_bit_identical(group_a, tag):
    """The seq ranks of one (data, fsdp, model) coordinate hold the same
    shards: every stored tensor and its moment bit for bit."""
    ranks, _, _ = group_a
    n = sum(1 for k in ranks[0] if k.startswith(f"{tag}:local:"))
    for i0, i1 in _replica_pairs(tag, "seq"):
        for i in range(n):
            for part in ("local", "mu_local"):
                np.testing.assert_array_equal(ranks[i0][f"{tag}:{part}:{i}"],
                                              ranks[i1][f"{tag}:{part}:{i}"])


@pytest.mark.parametrize("tag", TAGS + SEQ_FSDP_TAGS)
def test_step_file_equals_a_one_process_save(group_a, tag, tmp_path):
    """Rank 0's step file (the shards and ZeRO pieces gathered before the
    write) against a one-process Checkpointer's save of the gathered
    state: the same tree, tensor by tensor."""
    ranks, _, out = group_a
    r0 = ranks[0]
    cfg = _cfg(tconfigs, tag)
    params = params_from_flat({k[len(f"{tag}:p:"):]: v for k, v in r0.items()
                               if k.startswith(f"{tag}:p:")}, cfg.model,
                              device="cpu")
    moments = {name: [torch.from_numpy(r0[f"{tag}:{name}:{i}"])
                      for i in range(len(list(leaf_paths(params))))]
               for name in ("mu", "nu")}
    gen = torch.Generator()
    gen.set_state(torch.from_numpy(r0[f"{tag}:generator"]))
    state = tts.TrainState(1, params, OptState(int(r0[f"{tag}:count"]),
                                               moments["mu"], moments["nu"],
                                               None), gen)
    ck = Checkpointer(str(tmp_path / "one"), async_save=False)
    assert ck.save(1, state)
    ck.close()
    got = torch.load(out / f"ck_{tag}" / "1" / "state.pt", weights_only=True)
    want = torch.load(tmp_path / "one" / "1" / "state.pt", weights_only=True)

    def walk(a, b, path):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert list(a) == list(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        elif torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, path

    walk(got, want, "")


@pytest.mark.parametrize("tag", TAGS + SEQ_TAGS)
def test_stored_bytes_are_per_chip_state_bytes(group_a, tag):
    """What each rank stores between steps is `per_chip_state_bytes` of
    the rules: the params at their fsdp or model shard, the moments at
    the ZeRO shard (less than the params' under ZeRO-1)."""
    from proteinbert_tpu_torch.parallel.mesh import Mesh
    from proteinbert_tpu_torch.parallel.zero import per_chip_state_bytes

    ranks, _, _ = group_a
    cfg = _cfg(tconfigs, tag)
    pre = _prefix(tag)
    params = params_from_flat(
        {k[len(pre):]: v for k, v in np.load(
            group_a[2] / "inputs.npz").items() if k.startswith(pre)},
        cfg.model, device="cpu")
    full = tts.TrainState(0, params, tts.make_optimizer(
        cfg.optimizer).init(params), torch.Generator())
    mesh = Mesh(shape=dict(cfg.mesh.__dict__), rank=0,
                coords={"data": 0, "fsdp": 0, "model": 0, "seq": 0})
    want = per_chip_state_bytes(mesh, full,
                                zero_update=cfg.parallel.zero_update)
    for r in ranks:
        p = sum(v.nbytes for k, v in r.items()
                if k.startswith(f"{tag}:local:"))
        m = sum(v.nbytes for k, v in r.items()
                if k.startswith(f"{tag}:mu_local:"))
        assert p == want["params"] and 2 * m == want["opt_state"]
        if cfg.parallel.zero_update and cfg.mesh.data * cfg.mesh.fsdp > 1:
            assert m < p


def _max_err(r, tag, want):
    return max(float(np.abs(r[f"{tag}:p:{k}"].astype(np.float64)
                            - np.asarray(v, np.float64)).max())
               for k, v in want.items())


@pytest.mark.parametrize("payload", PAYLOADS)
def test_fsdp_quantized_reduce_scatter_within_bounds(group_a, payload):
    """Two steps of the quantized reduce-scatter on the fsdp layout
    against two steps of the fp32 sharded step on the same mesh and rows:
    the first loss the same (quantization is all that differs), the
    params within the JAX quantization test's bound, every rank the same
    gathered params."""
    ranks, _, _ = group_a
    r0 = ranks[0]
    tag = f"q_{payload}"
    ref = {k[len("qref:p:"):]: v for k, v in r0.items()
           if k.startswith("qref:p:")}
    assert abs(float(r0[f"{tag}:losses"][0])
               - float(r0["qref:losses"][0])) <= 2e-5
    err = _max_err(r0, tag, ref)
    assert err <= QUANT_BOUNDS[payload], (payload, err)
    if payload != "fp32":
        assert err > 0.0, "quantization did not round anything"
    for r in ranks[1:]:
        for k in ref:
            np.testing.assert_array_equal(r[f"{tag}:p:{k}"],
                                          r0[f"{tag}:p:{k}"])


@pytest.mark.parametrize("payload", PAYLOADS)
def test_fsdp_quantized_step_matches_jax(group_a, payload):
    """The port's quantized step on the fsdp layout against JAX's
    `make_quant_zero_train_step` on MeshConfig(data=2, fsdp=2) at the
    same payload, two steps from the same params and rows."""
    ranks, want, _ = group_a
    loss, _, params = want[f"q_{payload}"]
    tag = f"q_{payload}"
    for r in ranks:
        assert float(r[f"{tag}:losses"][1]) == pytest.approx(loss,
                                                             rel=LOSS_REL)
        err = _max_err(r, tag, params)
        assert err <= QUANT_BOUNDS[payload], (payload, err)


def _mu_rel(r, tag):
    """Each leaf's ||mu - mu_ref|| / ||mu_ref|| against the fp32 sharded
    step's first moments after the same two steps."""
    out = []
    i = 0
    while f"qref:mu:{i}" in r:
        ref = r[f"qref:mu:{i}"].astype(np.float64)
        got = r[f"{tag}:mu:{i}"].astype(np.float64)
        out.append(float(np.linalg.norm(got - ref) / np.linalg.norm(ref)))
        i += 1
    return out


@pytest.mark.parametrize("payload", PAYLOADS)
def test_fsdp_quantized_grad_norm_matches_jax_and_fp32(group_a, payload):
    """The quantized step's gradient norm (of the dequantized sum) at
    each of the two steps against the fp32 sharded step's, and at step 2
    against JAX's quantized step's at the same payload; every rank the
    same norm. (The params alone cannot tell a bad reduction: the first
    Adam update is lr·sign(g), so any two runs differ by at most ~2·lr.)"""
    ranks, want, _ = group_a
    _, norm, _ = want[f"q_{payload}"]
    bound = NORM_REL[payload]
    for r in ranks:
        got, ref = r[f"q_{payload}:norms"], r["qref:norms"]
        np.testing.assert_array_equal(got, ranks[0][f"q_{payload}:norms"])
        assert float(got[1]) == pytest.approx(norm, rel=bound)
        np.testing.assert_allclose(got, ref, rtol=bound)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_fsdp_quantized_moments_track_fp32(group_a, payload):
    """The first moments after two steps are linear in the reduced
    gradients (LR 0 at step 1 leaves the params, so both steps see the
    same batch at the same point): each leaf's relative distance from
    the fp32 sharded step's moments is the reduction's own error, within
    MU_REL, and nonzero where the payload rounds. A wrong scale or a
    slice dequantized into another's place moves it by order 1."""
    ranks, _, _ = group_a
    for r in ranks:
        rel = _mu_rel(r, f"q_{payload}")
        assert len(rel) == sum(1 for k in r if k.startswith("qref:mu:"))
        assert max(rel) <= MU_REL[payload], (payload, max(rel))
        if payload != "fp32":
            assert min(rel) > 0.0


def test_fsdp_int8_is_deterministic_and_wire_bytes_shrink(group_a):
    """int8 twice, bit for bit; the gradient reduction's wire bytes by
    kind: the exchange (all-to-all) moves half the fp32 payload's bytes
    in bf16 and at most 0.27 of them in int8 (a quarter plus the chunk
    scales), and the fp32 all-reduce of the remainder leaves is the same
    whatever the payload. (The totals' ratios, 0.2856 and 0.5179 here,
    carry that remainder, which is a larger share at these widths than at
    the presets'.)"""
    ranks, _, _ = group_a
    for r in ranks:
        for k in r:
            if k.startswith("q_int8:"):
                np.testing.assert_array_equal(
                    r[k], r["q_int8_again:" + k[len("q_int8:"):]])
        a2a, ar, rs = (float(x) for x in r["q_fp32:wire_kinds"])
        assert a2a > 0 and rs == 0
        for p, bound in (("int8", 0.27), ("bf16", 0.5)):
            q_a2a, q_ar, q_rs = (float(x) for x in r[f"q_{p}:wire_kinds"])
            assert q_ar == ar and q_rs == 0
            assert q_a2a <= bound * a2a, (p, q_a2a / a2a)
        assert float(r["q_bf16:wire_kinds"][0]) == 0.5 * a2a
        assert float(r["q_int8:wire"]) < 0.3 * float(r["q_fp32:wire"])


@pytest.mark.parametrize("tag", ["q_int8", "q_bf16"])
def test_fsdp_quantized_stored_bytes(group_a, tag):
    """Between steps each rank stores `per_chip_state_bytes` under
    ZeRO-1: the params at their fsdp shard, the moments at the ZeRO
    piece (the plateau's scalars beside them)."""
    from proteinbert_tpu_torch.parallel.mesh import Mesh
    from proteinbert_tpu_torch.parallel.zero import per_chip_state_bytes

    ranks, _, out = group_a
    cfg = _cfg(tconfigs, tag)
    params = params_from_flat(
        {k[len("p:"):]: v for k, v in np.load(out / "inputs.npz").items()
         if k.startswith("p:")}, cfg.model, device="cpu")
    opt = tts.make_optimizer(cfg.optimizer).init(params)
    full = tts.TrainState(0, params, opt, torch.Generator())
    mesh = Mesh(shape=dict(cfg.mesh.__dict__), rank=0,
                coords={"data": 0, "fsdp": 0, "model": 0, "seq": 0})
    want = per_chip_state_bytes(mesh, full, zero_update=True)
    plateau = sum(v.nbytes for v in (opt.plateau or {}).values())
    for r in ranks:
        p = sum(v.nbytes for k, v in r.items()
                if k.startswith(f"{tag}:local:"))
        m = sum(v.nbytes for k, v in r.items()
                if k.startswith(f"{tag}:mu_local:"))
        assert p == want["params"]
        assert 2 * m + plateau == want["opt_state"] and m < p


@pytest.mark.parametrize("case", ["model", "seq", "batch"])
def test_fsdp_quantized_refusals_match_jax(case):
    """The typed QuantConfigError of the fsdp route, with the JAX
    message: a model or seq axis, or a batch that does not split over
    data·fsdp."""
    from proteinbert_tpu_torch.parallel import quant
    from proteinbert_tpu_torch.parallel.fsdp import make_sharded_train_step
    from proteinbert_tpu_torch.parallel.mesh import Mesh

    shape = {"data": 2, "fsdp": 2, "model": 1, "seq": 1}
    batch = 16
    if case == "batch":
        batch = 14
    else:
        shape[case] = 2
    cfg = _cfg(tconfigs, "q_int8")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch))
    mesh = Mesh(shape=shape, rank=0,
                coords={"data": 0, "fsdp": 0, "model": 0, "seq": 0})
    with pytest.raises(jquant.QuantConfigError) as want:
        jquant.check_quant_mesh(types.SimpleNamespace(shape=shape), "int8",
                                batch)
    with pytest.raises(quant.QuantConfigError) as got:
        make_sharded_train_step(mesh, cfg)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def group_b(tmp_path_factory):
    """Two ranks at fsdp=2 (`torch_mesh_child.fsdp_resume`)."""
    out = tmp_path_factory.mktemp("mesh_b")
    rng = np.random.default_rng(21)
    arrays = {}
    for b in range(SPEC["resume"]["batches"]):
        t, a = _tokens(rng, 8, 32)
        arrays.update({f"resume{b}:tokens": t, f"resume{b}:annotations": a})
    t, a = _tokens(rng, 8, 32)
    arrays.update({"eval:tokens": t, "eval:annotations": a})
    arrays["conv:x"] = rng.standard_normal((4, 16, 3)).astype(np.float32)
    arrays["conv:kernel"] = rng.standard_normal((9, 3, 3)).astype(np.float32)
    arrays["conv:bias"] = rng.standard_normal(3).astype(np.float32)
    _inputs(out, arrays)
    t0 = time.perf_counter()
    ranks = _spawn(torch_mesh_child.fsdp_resume, 2, out)
    print(f"spawn {time.perf_counter() - t0:.1f} s")
    return ranks, out, arrays


@pytest.mark.parametrize("tag", SEQ_FSDP_TAGS)
def test_seq_fsdp_step_file_reshards_and_resumes(group_a, tag, tmp_path):
    """The fsdp=2 x seq=2 run's step file (step 1) through
    `reshard_checkpoint` to one device, and from there back to 1x2x1x2:
    the same tensors, bit for bit; one process resumes the one-device
    file and takes step 2 on the second batch, with the seq run's step-2
    loss within 1e-5."""
    from proteinbert_tpu_torch.parallel.reshard import states_byte_identical

    ranks, want, out = group_a
    cfg = _cfg(tconfigs, tag)
    one, back = tmp_path / "one", tmp_path / "back"
    summary = reshard_checkpoint(str(out / f"ck_{tag}"), str(one), cfg=cfg,
                                 target_mesh_cfg=parse_mesh_spec("1"))
    assert summary["parity"] is True and summary["step"] == 1
    assert summary["source_mesh"] == {"data": 1, "fsdp": 2, "model": 1,
                                      "seq": 2}
    summary = reshard_checkpoint(str(one), str(back),
                                 target_mesh_cfg=parse_mesh_spec("1x2x1x2"))
    assert summary["parity"] is True
    assert summary["target_mesh"] == summary["source_mesh"] | {"fsdp": 2,
                                                               "seq": 2}
    trees = []
    for d in (out / f"ck_{tag}", back):
        ck = Checkpointer(str(d), async_save=False)
        trees.append(ck.read(1)[0])
        ck.close()
    assert states_byte_identical(*trees)
    ck = Checkpointer(str(one), async_save=False)
    run = pretrain(cfg.replace(mesh=tconfigs.MeshConfig()),
                   lambda skip: iter(want["seq_batches"][skip:]),
                   checkpointer=ck, device="cpu")
    ck.close()
    got = [h["loss"] for h in run["history"]]
    assert len(got) == 1
    for r in ranks:
        assert abs(got[0] - float(r[f"{tag}:loss2"])) <= 1e-5


def test_fsdp_checkpoint_reshards_to_one_device_and_resumes(group_b,
                                                            tmp_path):
    ranks, out, arrays = group_b
    losses = ranks[0]["resume:losses"]
    np.testing.assert_array_equal(losses, ranks[1]["resume:losses"])
    assert list(ranks[0]["resume:steps"]) == [2, 3]
    cfg = _cfg(tconfigs, "resume")
    events = tmp_path / "ev.jsonl"
    tele = Telemetry(events_path=str(events))
    summary = reshard_checkpoint(str(out / "ck"), str(tmp_path / "one"),
                                 cfg=cfg, target_mesh_cfg=parse_mesh_spec("1"),
                                 step=2, telemetry=tele)
    tele.close()
    assert summary["parity"] is True and summary["step"] == 2
    assert summary["schedule"] == "host_staged"
    assert summary["source_mesh"]["fsdp"] == 2
    assert summary["target_mesh"] == {"data": 1, "fsdp": 1, "model": 1,
                                      "seq": 1}
    (ev,) = [e for e in read_events(str(events), strict=True)
             if e["event"] == "reshard"]
    assert ev["wire_bytes"]["total"] == 0 and ev["parity"] is True
    saved = torch.load(tmp_path / "one" / "2" / "state.pt",
                       weights_only=True)
    for mu, p in zip(saved["opt_state"]["mu"],
                     list(t for _, t in leaf_paths(saved["params"]))):
        assert mu.shape == p.shape
    one = cfg.replace(mesh=tconfigs.MeshConfig())
    batches = [{k: arrays[f"resume{b}:{k}"] for k in ("tokens",
                                                       "annotations")}
               for b in range(3)]
    ck = Checkpointer(str(tmp_path / "one"), async_save=False)
    run = pretrain(one, lambda skip: iter(batches[skip:]), checkpointer=ck,
                   device="cpu")
    ck.close()
    got = [h["loss"] for h in run["history"]]
    assert len(got) == 1
    assert abs(got[0] - float(losses[2])) <= 1e-5
    # The fsdp run's eval at step 3 (params gathered to full shape, each
    # replica its half of the batch, pooled over the replica group) is one
    # process's eval of the same halves with the resumed params.
    from proteinbert_tpu_torch.train.trainer import evaluate_batches

    halves = [{k: arrays[f"eval:{k}"][h * 4:(h + 1) * 4]
               for k in ("tokens", "annotations")} for h in (0, 1)]
    want, n, rows = evaluate_batches(
        run["state"], iter(halves), one, lambda b: torch.Generator())
    assert (n, rows) == (2, 8)
    for r in ranks:
        (eval_loss,) = r["resume:eval_loss"]
        assert abs(float(eval_loss) - want["loss"]) <= 1e-5


def test_seq_parallel_conv1d_matches_jax(group_b):
    ranks, _, arrays = group_b
    mesh = j_make_mesh(jconfigs.MeshConfig(seq=2), jax.devices()[:2])
    params = {k: jnp.asarray(arrays[f"conv:{k}"]) for k in ("kernel", "bias")}
    want = np.asarray(j_seq_parallel_conv1d(
        mesh, params, jnp.asarray(arrays["conv:x"]),
        dilation=SPEC["conv_dilation"]))
    for s, r in enumerate(ranks):
        np.testing.assert_allclose(r["conv:y"], want[:, s * 8:(s + 1) * 8],
                                   atol=1e-5)
