"""The port's data parallelism (`proteinbert_tpu_torch.parallel` mesh,
multihost, sharding, zero and the training half of quant; the
data-parallel step of `train/train_state.py`) on the CPU, against the
JAX package on the same numpy-made inputs and weights (carried through
the flat export layout).

Multi-rank cases spawn gloo ranks (`tests/torch_dp_child.py`) that meet
through a FileStore under a temporary directory, each spawn bounded by
its own timeout: two ranks at data=2 once for the module
(`dp_ranks`), and four ranks at data=2 x seq=2 once. Tolerances, float32
throughout, each the JAX test's own where it has one:
- the data-parallel loss 1e-5 and gradients 5e-4 against JAX
  `pretrain_loss` / `packed_pretrain_loss` gradients on the full batch
  (another reduction order over the ranks and the same model);
- the ZeRO-1 update against JAX `zero_gradient_update` on a data=2 mesh
  from the same gradients: params and moments 2e-6 (tests/test_zero.py);
- two steps of the quantized reduce-scatter against the replicated step:
  the fp32 payload 1e-6, bf16 5e-4, int8 1e-3 (tests/test_quant.py), the
  rounded ones moving the params at all, int8 bit for bit across runs;
  wire bytes of the gradient reduction: int8 at most 0.27 and bf16 at
  most 0.52 of the fp32 payload's;
- a ZeRO checkpoint of the data=2 run resumed by one process: its losses
  the data=2 run's within 1e-5;
- an eval pooled over the two ranks: `global_auroc` / `global_p_at_k`
  one process's over the whole batches within 1e-6 (they merge by
  addition; another summation order);
- data=2 x seq=2 with ZeRO-1 against JAX `make_seq_parallel_train_step`
  on that mesh: loss 1e-5, gradients 5e-4, params after one step 1e-5
  (the seq test's tolerances);
- `quantize_int8_chunks` without a generator: bit for bit with JAX;
  stochastic rounding: the mean rounding error within 4 standard errors
  of 0 (a truncating rounder sits tens of standard errors away).
"""

import dataclasses
import functools
import json
import logging
import multiprocessing
import os
import shutil
import socket
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from proteinbert_tpu import configs as jconfigs
from proteinbert_tpu.data.corruption import corrupt_batch as j_corrupt
from proteinbert_tpu.data.corruption import (
    corrupt_packed_batch as j_corrupt_packed,
)
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.parallel import (
    batch_sharding, make_mesh as j_make_mesh, shard_train_state,
)
from proteinbert_tpu.parallel import quant as jquant
from proteinbert_tpu.parallel import zero as jzero
from proteinbert_tpu.parallel.seq_parallel import (
    make_seq_parallel_train_step as j_make_seq_step,
)
from proteinbert_tpu.parallel.sharding import (
    zero_update_spec as j_zero_update_spec,
)
from proteinbert_tpu.train import train_state as jts
from proteinbert_tpu.train.loss import (
    packed_pretrain_loss as j_packed_loss, pretrain_loss as j_loss,
)
from proteinbert_tpu.train.schedule import make_optimizer as j_make_opt
from proteinbert_tpu_torch import configs as tconfigs
from proteinbert_tpu_torch.data.dataset import InMemoryPretrainingDataset
from proteinbert_tpu_torch.data.packing import make_packed_iterator
from proteinbert_tpu_torch.data.synthetic import make_random_proteins
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.obs.metrics import MetricsRegistry
from proteinbert_tpu_torch.parallel import multihost, quant, sharding, zero
from proteinbert_tpu_torch.parallel.mesh import Mesh, make_mesh
from proteinbert_tpu_torch.parallel.seq_parallel import (
    make_seq_parallel_train_step,
)
from proteinbert_tpu_torch.train import Checkpointer
from proteinbert_tpu_torch.train import train_state as tts
from proteinbert_tpu_torch.train.loss import (
    loss_from_terms, pretrain_loss, pretrain_loss_terms,
)
from proteinbert_tpu_torch.train.schedule import tree_leaves
from proteinbert_tpu_torch.train.trainer import pretrain
from proteinbert_tpu_torch.weights import params_from_flat
from tests import torch_dp_child

torch.set_num_threads(1)

MODEL = dict(local_dim=16, global_dim=32, key_dim=8, num_heads=4,
             num_blocks=2, num_annotations=64, dtype="float32")
IDENTITY = dict(token_randomize_prob=0.0, annotation_corrupt_prob=1.0,
                annotation_drop_prob=0.0, annotation_add_prob=0.0)
CONSTANT = dict(schedule="constant", learning_rate=1e-4, warmup_steps=0)
# Each section: one config, as spec.json carries it to the ranks.
SPEC = {
    "model": MODEL,
    "grads": {"data": dict(seq_len=32, batch_size=8),
              "optimizer": dict(CONSTANT, weight_decay=0.01,
                                grad_clip_norm=0.1),
              "mesh": {"data": 2}},
    # The JAX quantization test's config (tests/test_quant.py:47-60).
    "quant": {"data": dict(seq_len=32, batch_size=16),
              "optimizer": dict(learning_rate=1e-3, warmup_steps=10),
              "mesh": {"data": 2},
              "parallel": dict(zero_update=True, grad_reduce_dtype="int8")},
    "resume": {"data": dict(seq_len=32, batch_size=8, **IDENTITY),
               "optimizer": dict(CONSTANT, learning_rate=1e-3),
               "mesh": {"data": 2},
               "parallel": dict(zero_update=True),
               "train": dict(max_steps=4, log_every=1),
               "checkpoint": dict(every_steps=2, async_save=False),
               "batches": 4},
    # The default corruption, batches fed inline (a signal raised while
    # fetching one lands before that step's stop check).
    "preempt": {"data": dict(seq_len=32, batch_size=8, prefetch_depth=0),
                "optimizer": dict(CONSTANT, learning_rate=1e-3),
                "mesh": {"data": 2},
                "parallel": dict(zero_update=True),
                "train": dict(max_steps=6, log_every=1),
                "checkpoint": dict(every_steps=100, async_save=False)},
    "seq_data": {"data": dict(seq_len=128, batch_size=4, **IDENTITY),
                 "optimizer": CONSTANT,
                 "mesh": {"data": 2, "seq": 2},
                 "parallel": dict(zero_update=True)},
}
SPAWN_TIMEOUT = 150  # seconds for one spawned group, start-up included
QUANT_BOUNDS = {"fp32": 1e-6, "bf16": 5e-4, "int8": 1e-3}


def _cfg(mod, name):
    c = SPEC[name]
    return mod.PretrainConfig(
        model=mod.ModelConfig(**MODEL),
        data=mod.DataConfig(**c["data"]),
        optimizer=mod.OptimizerConfig(**c["optimizer"]),
        mesh=mod.MeshConfig(**c["mesh"]),
        parallel=mod.ParallelConfig(**c.get("parallel", {})),
        train=mod.TrainConfig(**c.get("train", {})),
        checkpoint=mod.CheckpointConfig(**c.get("checkpoint", {})))


def _spawn(fn, world, out, work=None):
    """Run fn(rank, world, store, out) in `world` spawned processes, and
    `work()` in this process while they run; → each rank's results (and
    what `work` returned, when given). The timeout starts after `work`."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, str(out / "store"),
                                          str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        done = None if work is None else work()
        deadline = time.monotonic() + SPAWN_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        assert [p.exitcode for p in procs] == [0] * world, (
            f"ranks exited {[p.exitcode for p in procs]} "
            f"(None = still running at the {SPAWN_TIMEOUT} s timeout)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    out_ranks = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            out_ranks.append({k: z[k] for k in z.files})
    return out_ranks if work is None else (out_ranks, done)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _tokens(rng, B, L, A=64):
    tokens = rng.integers(4, 26, (B, L)).astype(np.int32)
    for b in range(B):   # unequal lengths: unequal weight masses per rank
        tokens[b, rng.integers(L // 4, L):] = 0
    ann = (rng.random((B, A)) < 0.1).astype(np.float32)
    ann[: B // 2: 2] = 0.0   # rows with no annotation weigh 0 globally
    return tokens, ann


@functools.lru_cache(maxsize=1)
def _jax_params():
    """The JAX model's params at MODEL widths (PRNGKey(0)), jitted: eager
    init compiles op by op."""
    cfg = jconfigs.ModelConfig(**MODEL)
    return jax.jit(lambda key: jmodel.init(key, cfg))(jax.random.PRNGKey(0))


def _jax_moments(opt_state):
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    return adam[0].mu, adam[0].nu


# ------------------------------------------------------------ the rules

@functools.lru_cache(maxsize=1)
def _base_leaf_shapes():
    """(path, shape) of every leaf of the port's `base` model."""
    params = tmodel.init(tconfigs.get_preset("base").model,
                         torch.Generator().manual_seed(0), device="cpu")
    return [(path, tuple(t.shape)) for path, t in sharding.leaf_paths(params)]


def _namespace_mesh(data):
    return types.SimpleNamespace(
        shape={"data": data, "fsdp": 1, "model": 1, "seq": 1})


@pytest.mark.parametrize("data", [2, 4, 8, 16, 64])
def test_zero_update_spec_matches_jax(data):
    """The port's rule on its own leaves (a block leaf without the stacked
    axis) against JAX `zero_update_spec` on the JAX leaves, leaf by leaf,
    at `base` widths; and the ZeRO dim against JAX `_leaf_plan`."""
    jcfg = jconfigs.get_preset("base")
    abstract = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jcfg.model))
    mesh = _namespace_mesh(data)
    want = {}

    def record(path, leaf):
        keys = tuple(getattr(p, "key", getattr(p, "name", None))
                     for p in path)
        want[keys] = (tuple(j_zero_update_spec(path, leaf, mesh)),
                      leaf.shape)

    jax.tree_util.tree_map_with_path(record, abstract)
    seen = 0
    for path, shape in _base_leaf_shapes():
        got = sharding.zero_update_spec(path, shape, mesh.shape)
        if path[0] == "blocks":
            spec, jshape = want[(path[0],) + path[2:]]
            assert jshape[1:] == shape
            entries = list(spec) + [None] * (len(jshape) - len(spec))
            assert entries[0] is None, "JAX split the stacked axis"
            spec = tuple(entries[1:])
        else:
            spec, jshape = want[path]
            assert jshape == shape
        entries = list(spec) + [None] * (len(shape) - len(spec))
        assert list(got) + [None] * (len(shape) - len(got)) == entries, path
        kind, info = jquant._leaf_plan(jax.sharding.PartitionSpec(*spec),
                                       shape, data)
        dim = sharding.zero_dim(path, shape, mesh.shape)
        assert dim == (info if kind == "alltoall" else None), path
        seen += 1
    assert seen == len(want) + (jcfg.model.num_blocks - 1) * sum(
        1 for k in want if k[0] == "blocks")


def test_local_batch_size_and_state_bytes():
    assert sharding.local_batch_size(128, 16) == 8
    with pytest.raises(ValueError, match="does not split evenly"):
        sharding.local_batch_size(10, 4)
    cfg = _cfg(tconfigs, "grads")
    params = tmodel.init(cfg.model, torch.Generator().manual_seed(0),
                         device="cpu")
    state = tts.TrainState(0, params, tts.make_optimizer(
        cfg.optimizer).init(params), torch.Generator())
    mesh = _namespace_mesh(2)
    rep = zero.per_chip_state_bytes(mesh, state)
    zer = zero.per_chip_state_bytes(mesh, state, zero_update=True)
    n = sum(t.numel() for t in tree_leaves(params)) * 4
    assert rep["params"] == zer["params"] == n and rep["opt_state"] == 2 * n
    sharded = sum(t.numel() * 4 for p, t in sharding.leaf_paths(params)
                  if sharding.zero_dim(p, tuple(t.shape), mesh.shape)
                  is not None)
    assert zer["opt_state"] == 2 * n - sharded
    assert sharded > 0.9 * n


# ---------------------------------------------------- the quantization

@pytest.mark.parametrize("case", ["random", "slice16", "zeros", "empty"])
def test_quantize_int8_chunks_matches_jax(case):
    rng = np.random.default_rng(3)
    x = {"random": rng.standard_normal((3, 1300)) * 5,
         "slice16": rng.standard_normal((2, 16)),
         "zeros": np.zeros((2, 16)),
         "empty": np.zeros((2, 0))}[case].astype(np.float32)
    if case == "empty":
        with pytest.raises(ValueError):
            jquant.quantize_int8_chunks(jnp.asarray(x), None)
        with pytest.raises((ValueError, RuntimeError, IndexError)):
            quant.quantize_int8_chunks(torch.from_numpy(x), None)
        return
    jq, js, jm = jquant.quantize_int8_chunks(jnp.asarray(x), None)
    tq, ts_, tm = quant.quantize_int8_chunks(torch.from_numpy(x), None)
    assert tm == jm and tq.dtype == torch.int8
    assert tuple(tq.shape) == jq.shape and tuple(ts_.shape) == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js))
    back = quant.dequantize_int8_chunks(tq, ts_, tm).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jquant.dequantize_int8_chunks(jq, js, jm)))
    if case == "slice16":
        assert tq.shape[-1] == 16   # one block of 16, not a padded 512


@pytest.mark.parametrize("payload", ["bf16", "int8"])
def test_stochastic_rounding_is_unbiased(payload):
    """The mean rounding error over 2^16 positive values is within 4
    standard errors of 0; truncation (the biased rounder) is far outside;
    the same generator seed gives the same bits."""
    x = torch.from_numpy(np.abs(np.random.default_rng(4).standard_normal(
        (1, 1 << 16))).astype(np.float32) + 0.1)

    def rounded(seed):
        gen = torch.Generator().manual_seed(seed)
        if payload == "bf16":
            return quant.stochastic_round_bf16(x, gen).float()
        q, s, m = quant.quantize_int8_chunks(x, gen)
        return quant.dequantize_int8_chunks(q, s, m)

    if payload == "bf16":
        truncated = (x.view(torch.int32) & -65536).view(torch.float32)
    else:
        q, s, m = quant.quantize_int8_chunks(x, None)
        y = x.reshape(q.shape) / s[..., None]
        truncated = (torch.floor(y) * s[..., None]).reshape(x.shape)
    for r, unbiased in ((rounded(0), True), (truncated, False)):
        err = (r - x).double()
        z = float(err.mean() / (err.std() / err.numel() ** 0.5))
        assert (abs(z) < 4) == unbiased, (payload, unbiased, z)
    assert torch.equal(rounded(1), rounded(1))
    assert not torch.equal(rounded(1), rounded(2))


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_match_jax_formulas(kind):
    """The port counts each call's bytes with the ring factors JAX reads
    off compiled HLO (`collective_wire_bytes_from_hlo`)."""
    for n in (2, 4, 8):
        groups = "{{" + ",".join(map(str, range(n))) + "}}"
        line = (f"  %c = f32[1000]{{0}} {kind}(f32[1000]{{0}} %p), "
                f"replica_groups={groups}")
        want = jzero.collective_wire_bytes_from_hlo(line)[kind]
        assert zero.wire_bytes(kind, 4000, n) == want, (kind, n)
    registry = MetricsRegistry()
    zero.count_collective(registry, kind, 4000, 4)
    out, wire = zero.comm_bytes(registry)
    assert out[kind] == out["total"] == 4000
    assert wire[kind] == zero.wire_bytes(kind, 4000, 4)


# ------------------------------------------------------ the process group

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["none", "partial", "coordinator",
                                  "torchrun", "no-card"])
def test_multihost_environment(case, clean_env):
    """Neither environment: a single-process no-op (False), and with
    required=True the JAX error; COORDINATOR_ADDRESS without its two
    siblings is refused; the coordinator's names and torchrun's `env://`
    each form a one-rank gloo group (idempotently); NCCL without a card
    is refused before any connection."""
    assert not dist.is_initialized()
    kw = {"device": "cpu"}
    if case == "none":
        assert multihost.maybe_initialize_distributed(**kw) is False
        assert multihost.process_index() == 0
    elif case == "partial":
        clean_env.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    elif case == "coordinator":
        clean_env.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
        clean_env.setenv("NUM_PROCESSES", "1")
        clean_env.setenv("PROCESS_ID", "0")
    elif case == "torchrun":
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                     ("MASTER_ADDR", "127.0.0.1"),
                     ("MASTER_PORT", str(_free_port()))):
            clean_env.setenv(k, v)
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: NCCL would bind it")
        clean_env.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
        clean_env.setenv("NUM_PROCESSES", "1")
        clean_env.setenv("PROCESS_ID", "0")
        kw = {"device": "cuda"}
    if case in ("coordinator", "torchrun"):
        assert multihost.maybe_initialize_distributed(required=True, **kw)
        assert dist.get_backend() == "gloo"
        assert multihost.maybe_initialize_distributed(required=True, **kw)
        assert (multihost.process_index(), dist.get_world_size()) == (0, 1)
        return
    match = {"none": "no distributed environment",
             "partial": "needs NUM_PROCESSES and PROCESS_ID",
             "no-card": "NCCL needs a CUDA device"}[case]
    assert multihost.maybe_initialize_distributed(**kw) is False
    with pytest.raises(RuntimeError, match="multi-host initialization was "
                       "requested but failed.*" + match):
        multihost.maybe_initialize_distributed(required=True, **kw)
    assert not dist.is_initialized()


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("case", ["size", "fsdp", "model", "rule",
                                  "seq-fsdp"])
def test_mesh_refusals(case):
    """One process: a mesh of more devices than the world is refused with
    the JAX message, word for word, whatever its axes (seq together with
    fsdp too); the ZeRO rule at data=2 x fsdp=2 is JAX's."""
    if case == "rule":
        mesh = types.SimpleNamespace(
            shape={"data": 2, "fsdp": 2, "model": 1, "seq": 1})
        for shape in ((26, 128), (64, 32), (9, 32, 32), (32,), (6, 3)):
            leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
            path = (jax.tree_util.DictKey("global_in"),
                    jax.tree_util.DictKey("kernel"))
            want = tuple(j_zero_update_spec(path, leaf, mesh))
            got = sharding.zero_update_spec(("global_in", "kernel"), shape,
                                            mesh.shape)
            assert got == want + (None,) * (len(got) - len(want)), shape
        return
    kw = {"size": dict(data=2), "fsdp": dict(fsdp=2),
          "model": dict(model=4), "seq-fsdp": dict(seq=2, fsdp=2)}[case]
    # The JAX message, word for word.
    with pytest.raises(ValueError) as want:
        j_make_mesh(jconfigs.MeshConfig(**kw), jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        make_mesh(tconfigs.MeshConfig(**kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["payload", "no-replicas", "model", "seq",
                                  "batch", "seq-step-int8"])
def test_quant_config_refusals_match_jax(case):
    """Every QuantConfigError of the port with the JAX message."""
    shape = {"data": 2, "fsdp": 1, "model": 1, "seq": 1}
    payload, batch = "int8", None
    if case == "payload":
        payload = "fp16"
    elif case == "no-replicas":
        shape["data"] = 1
    elif case in ("model", "seq"):
        shape[case] = 2
    elif case == "batch":
        batch = 7
    if case == "seq-step-int8":
        jcfg, tcfg = (dataclasses.replace(
            _cfg(mod, "grads"), parallel=mod.ParallelConfig(
                zero_update=True, grad_reduce_dtype="int8"))
            for mod in (jconfigs, tconfigs))
        with pytest.raises(jquant.QuantConfigError) as want:
            j_make_seq_step(j_make_mesh(jconfigs.MeshConfig(seq=2),
                                        jax.devices()[:2]), jcfg)
        with pytest.raises(quant.QuantConfigError) as got:
            make_seq_parallel_train_step(None, tcfg)
    else:
        mesh = types.SimpleNamespace(shape=shape)
        with pytest.raises(jquant.QuantConfigError) as want:
            jquant.check_quant_mesh(mesh, payload, batch)
        with pytest.raises(quant.QuantConfigError) as got:
            quant.check_quant_mesh(mesh, payload, batch)
    assert isinstance(got.value, ValueError)
    assert str(got.value) == str(want.value)


def test_pretrain_refuses_a_batch_that_does_not_split():
    cfg = _cfg(tconfigs, "grads")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=9))
    mesh = Mesh(shape={"data": 2, "fsdp": 1, "model": 1, "seq": 1}, rank=0,
                coords={"data": 0, "fsdp": 0, "model": 0, "seq": 0})
    with pytest.raises(ValueError, match="global batch 9 does not split"):
        pretrain(cfg, iter([]), device="cpu", mesh=mesh)


# ------------------------------------------------ the loss decomposition

def test_rank_mean_loss_differs_from_the_global_share():
    """Two halves of a batch with unequal weight masses: the shares (each
    half's numerators over the whole batch's masses) sum to the batch's
    loss; the mean of the halves' own losses does not — the error a
    data-parallel step that averaged per-rank losses would make, and the
    parity tests below would catch (their 1e-5 is far below it)."""
    rng = np.random.default_rng(6)
    B, L, V, A = 8, 32, 26, 64
    tokens, ann = _tokens(rng, B, L, A)
    ll = torch.from_numpy(rng.standard_normal((B, L, V)).astype(np.float32))
    gl = torch.from_numpy(rng.standard_normal((B, A)).astype(np.float32))
    Y = {"local": torch.from_numpy(tokens).long(),
         "global": torch.from_numpy(ann)}
    W = {"local": (Y["local"] != 0).float(),
         "global": (Y["global"].sum(-1, keepdim=True) > 0).float()
         .expand(B, A)}
    whole, _ = pretrain_loss(ll, gl, Y, W)
    halves = [slice(0, B // 2), slice(B // 2, B)]
    terms = [pretrain_loss_terms(ll[h], gl[h], {k: v[h] for k, v in
                                                 Y.items()},
                                 {k: v[h] for k, v in W.items()})
             for h in halves]
    total = {k: terms[0][1][k] + terms[1][1][k] for k in ("local", "global")}
    assert terms[0][1]["local"] != terms[1][1]["local"]
    shares = sum(float(loss_from_terms(n, total)[0]) for n, _ in terms)
    mean = sum(float(loss_from_terms(n, d)[0]) for n, d in terms) / 2
    assert abs(shares - float(whole)) <= 1e-5
    assert abs(mean - float(whole)) > 1e-3


# --------------------------------------- a one-rank group, in process

def _loop_cfg(**parallel):
    cfg = _cfg(tconfigs, "grads")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=4),
        mesh=tconfigs.MeshConfig(data=1),
        parallel=tconfigs.ParallelConfig(**parallel),
        train=tconfigs.TrainConfig(max_steps=3, log_every=1))


def _loop_batches(packed, n=3):
    rng = np.random.default_rng(40)
    if packed:
        seqs, ann = make_random_proteins(40, rng, num_annotations=64,
                                         max_len=14)
        ds = InMemoryPretrainingDataset(seqs, ann, 32)
        it = make_packed_iterator(ds, 4, seed=0, max_segments=4)
        return iter([next(it) for _ in range(n)])
    return iter([dict(zip(("tokens", "annotations"), _tokens(rng, 4, 32)))
                 for _ in range(n)])


@pytest.mark.parametrize("case", ["dense", "packed", "zero"])
def test_pretrain_with_a_one_rank_mesh_is_the_plain_loop(case, tmp_path,
                                                          caplog):
    """`pretrain(mesh=make_mesh(MeshConfig(data=1)))` over a one-rank gloo
    group — every collective runs over one rank — bit for bit the plain
    loop: losses, params and moments. With zero_update the JAX warning is
    logged and the replicated update runs."""
    cfg = _loop_cfg(zero_update=case == "zero")
    packed = case == "packed"
    plain = pretrain(cfg, _loop_batches(packed), device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    caplog.set_level(logging.WARNING)
    try:
        mesh = make_mesh(cfg.mesh)
        assert mesh.data_group is dist.group.WORLD
        got = pretrain(cfg, _loop_batches(packed), device="cpu", mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert [h["loss"] for h in got["history"]] == \
        [h["loss"] for h in plain["history"]]
    a, b = plain["state"], got["state"]
    for x, y in zip(tree_leaves(a.params) + a.opt_state.mu + a.opt_state.nu,
                    tree_leaves(b.params) + b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    warned = [r for r in caplog.records
              if "zero_update requested but the mesh has data*fsdp == 1"
              in r.getMessage()]
    assert len(warned) == (1 if case == "zero" else 0)


# ------------------------------------------------- two ranks, data=2

@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    """The JAX side and the inputs, then one spawn of two ranks (`torch_dp_
    child.data_parallel`) → (rank results, JAX results, out dir)."""
    out = tmp_path_factory.mktemp("dp")
    jcfg = _cfg(jconfigs, "grads")
    jparams = _jax_params()
    flat = flatten_params(jparams)
    arrays = {f"p:{k}": v for k, v in flat.items()}
    want = {}
    rng = np.random.default_rng(7)

    # Dense: the JAX corruption of one batch of 8 rows.
    tokens, ann = _tokens(rng, 8, 32)
    X, Y, W = j_corrupt(jax.random.PRNGKey(1), jnp.asarray(tokens),
                        jnp.asarray(ann))

    def dense_loss(p):
        ll, gl = jmodel.apply(p, X["local"], X["global"], jcfg.model,
                              W["local"] > 0)
        return j_loss(ll, gl, Y, W)

    # Packed: 8 rows of up to 4 proteins, the JAX packed corruption.
    seqs, pann = make_random_proteins(60, rng, num_annotations=64,
                                      max_len=14)
    pb = next(make_packed_iterator(InMemoryPretrainingDataset(seqs, pann, 32),
                                   8, seed=1, max_segments=4))
    seg = jnp.asarray(pb["segment_ids"])
    PX, PY, PW = j_corrupt_packed(jax.random.PRNGKey(2),
                                  jnp.asarray(pb["tokens"]), seg,
                                  jnp.asarray(pb["annotations"]))

    def packed_loss(p):
        ll, gl = jmodel.apply(p, PX["local"], PX["global"], jcfg.model,
                              segment_ids=seg)
        return j_packed_loss(ll, gl, PY, PW, seg)

    for kind, fn, tensors in (("dense", dense_loss, (X, Y, W)),
                              ("packed", packed_loss, (PX, PY, PW))):
        g, m = jax.jit(jax.grad(fn, has_aux=True))(jparams)
        want[f"{kind}:loss"] = float(m["loss"])
        want[f"{kind}:g"] = flatten_params(g)
        want[f"{kind}:grads"] = g
        for n, dct in zip("XYW", tensors):
            arrays.update({f"{kind}:{n}_{k}": np.asarray(v)
                           for k, v in dct.items()})
        if kind == "dense":
            arrays.update({f"G:{k}": v for k, v in want["dense:g"].items()})
    arrays["packed:seg"] = pb["segment_ids"]

    # ZeRO-1 from the dense gradients on a data=2 mesh.
    mesh = j_make_mesh(jcfg.mesh, jax.devices()[:2])
    opt0 = j_make_opt(jcfg.optimizer).init(jparams)
    grads = jax.tree.map(jnp.asarray, want.pop("dense:grads"))
    new_p, new_o, norm = jax.jit(lambda p, g, o: jzero.zero_gradient_update(
        mesh, jcfg.optimizer, p, g, o))(jparams, grads, opt0)
    mu, nu = _jax_moments(new_o)
    want.update({"zero:p": flatten_params(new_p), "zero:mu": flatten_params(mu),
                 "zero:nu": flatten_params(nu), "zero:norm": float(norm)})

    # The quantization runs' batch; the resumed run's four batches.
    q_tokens, q_ann = _tokens(rng, 16, 32)
    arrays.update({"quant:tokens": q_tokens, "quant:annotations": q_ann})
    for b in range(SPEC["resume"]["batches"]):
        t, a = _tokens(rng, 8, 32)
        arrays.update({f"resume{b}:tokens": t, f"resume{b}:annotations": a})

    (out / "spec.json").write_text(json.dumps(SPEC))
    np.savez(out / "inputs.npz", **arrays)
    (out / "cli").mkdir()
    t0 = time.perf_counter()
    ranks = _spawn(torch_dp_child.data_parallel, 2, out)
    print(f"spawn {time.perf_counter() - t0:.1f} s")
    return ranks, want, out, arrays


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_data_parallel_loss_and_grads_match_jax(dp_ranks, kind):
    ranks, want, _, _ = dp_ranks
    for r in ranks:
        assert abs(float(r[f"{kind}:loss"]) - want[f"{kind}:loss"]) <= 1e-5
        for k, v in want[f"{kind}:g"].items():
            _close(r[f"{kind}:g:{k}"], v, 5e-4, k)
    for k in want[f"{kind}:g"]:
        np.testing.assert_array_equal(ranks[0][f"{kind}:g:{k}"],
                                      ranks[1][f"{kind}:g:{k}"])


def test_zero_update_matches_jax(dp_ranks):
    """From the same gradients (each rank holding half), the ZeRO-1
    update's params and gathered moments against JAX
    `zero_gradient_update` on a data=2 mesh; the clip (max norm 0.1)
    fires on the global norm."""
    ranks, want, _, _ = dp_ranks
    assert ranks[0]["zero:sharded"] > 0
    for r in ranks:
        assert abs(float(r["zero:norm"]) - want["zero:norm"]) \
            <= 1e-6 * want["zero:norm"]
        assert want["zero:norm"] > 0.1
        for part in ("p", "mu", "nu"):
            for k, v in want[f"zero:{part}"].items():
                _close(r[f"zero:{part}:{k}"], v, 2e-6, f"{part} {k}")


@pytest.mark.parametrize("payload", ["fp32", "bf16", "int8"])
def test_quantized_reduce_scatter_within_bounds(dp_ranks, payload):
    """Two steps of the ZeRO-1 step over each payload against two steps
    of the replicated step on the same rows and corruption: the first
    loss the same (quantization is all that differs), the params within
    the bound, every rank the same params."""
    ranks, _, _, _ = dp_ranks
    r0 = ranks[0]
    keys = [k[len("plain:p:"):] for k in r0 if k.startswith("plain:p:")]
    assert abs(float(r0[f"{payload}:losses"][0])
               - float(r0["plain:losses"][0])) <= 2e-5
    err = max(float(np.abs(r0[f"{payload}:p:{k}"].astype(np.float64)
                           - r0[f"plain:p:{k}"]).max()) for k in keys)
    assert err <= QUANT_BOUNDS[payload], (payload, err)
    if payload != "fp32":
        assert err > 0.0, "quantization did not round anything"
    for k in keys:
        np.testing.assert_array_equal(ranks[1][f"{payload}:p:{k}"],
                                      r0[f"{payload}:p:{k}"])


def test_int8_is_deterministic_and_wire_bytes_shrink(dp_ranks):
    ranks, _, _, _ = dp_ranks
    r0 = ranks[0]
    for k in r0:
        if k.startswith("int8:p:"):
            np.testing.assert_array_equal(r0[k], r0["int8_again" + k[4:]])
    fp32 = float(r0["fp32:wire"])
    assert fp32 > 0
    assert float(r0["int8:wire"]) <= 0.27 * fp32, r0["int8:wire"] / fp32
    assert float(r0["bf16:wire"]) <= 0.52 * fp32, r0["bf16:wire"] / fp32
    # The replicated step all-reduces fp32: 2(n-1)/n of the buffer.
    assert float(r0["plain:wire"]) >= fp32


def test_zero_checkpoint_resumes_at_world_one(dp_ranks, tmp_path):
    """The data=2 ZeRO run saved full-shape moments at step 2; one process
    restores that step and its steps 3-4 repeat the data=2 losses."""
    ranks, _, out, arrays = dp_ranks
    losses = ranks[0]["resume:losses"]
    np.testing.assert_array_equal(losses, ranks[1]["resume:losses"])
    cfg = _cfg(tconfigs, "resume")
    n = sum(int(np.prod(v.shape)) for k, v in arrays.items()
            if k.startswith("p:"))
    assert int(ranks[0]["resume:mu_shard"]) < 0.6 * n   # sharded moments
    ck_dir = tmp_path / "ck"
    shutil.copytree(out / "zero_ck", ck_dir)
    shutil.rmtree(ck_dir / "4")
    saved = torch.load(ck_dir / "2" / "state.pt", weights_only=True)
    for mu, p in zip(saved["opt_state"]["mu"],
                     tree_leaves(saved["params"])):
        assert mu.shape == p.shape
    batches = [{k: arrays[f"resume{b}:{k}"] for k in ("tokens",
                                                       "annotations")}
               for b in range(4)]
    ck = Checkpointer(str(ck_dir), async_save=False)
    run = pretrain(cfg, lambda skip: iter(batches[skip:]), checkpointer=ck,
                   device="cpu")
    ck.close()
    got = [h["loss"] for h in run["history"]]
    assert len(got) == 2
    np.testing.assert_allclose(got, losses[2:], rtol=0, atol=1e-5)


def test_eval_pools_ranking_statistics_across_the_group(dp_ranks):
    """Each rank scores its rows of the four batches; pooled over the
    group, the split's `global_auroc` and `global_p_at_k` are one
    process's over the whole batches (they merge by addition), and every
    rank holds the same metrics."""
    from proteinbert_tpu_torch.train.trainer import evaluate_batches

    ranks, _, _, arrays = dp_ranks
    cfg = _cfg(tconfigs, "resume")
    params = params_from_flat({k[2:]: v for k, v in arrays.items()
                               if k.startswith("p:")}, cfg.model,
                              device="cpu")
    state = tts.TrainState(0, params, tts.make_optimizer(
        cfg.optimizer).init(params), torch.Generator())
    batches = [{k: arrays[f"resume{b}:{k}"] for k in ("tokens",
                                                       "annotations")}
               for b in range(4)]
    want, n, rows = evaluate_batches(
        state, iter(batches), cfg, lambda b: torch.Generator().manual_seed(b))
    for r in ranks:
        assert (int(r["eval:n"]), int(r["eval:rows"])) == (2 * n, rows)
        for k in ("global_auroc", "global_p_at_k"):
            assert abs(float(r[f"eval:{k}"]) - want[k]) <= 1e-6, k
        for k in r:
            if k.startswith("eval:"):
                np.testing.assert_array_equal(r[k], ranks[0][k])


def test_eval_corruption_draws_differ_across_data_ranks(dp_ranks):
    """Both ranks corrupt the same clean rows with the generator
    `evaluate` gives them: the draws differ between the ranks (the data
    index is in the seed), and rank 0's are one process's."""
    from proteinbert_tpu_torch.train.trainer import eval_generators

    ranks, _, _, arrays = dp_ranks
    for k in ("tokens", "annotations"):
        assert not np.array_equal(ranks[0][f"noise:{k}"],
                                  ranks[1][f"noise:{k}"]), k
    cfg = _cfg(tconfigs, "preempt")
    params = params_from_flat({k[2:]: v for k, v in arrays.items()
                               if k.startswith("p:")}, cfg.model,
                              device="cpu")
    state = tts.TrainState(0, params, tts.make_optimizer(
        cfg.optimizer).init(params), torch.Generator())
    X, _, _, _ = tts.corrupt_for_step(
        state, {k: arrays[f"resume0:{k}"] for k in ("tokens", "annotations")},
        cfg, eval_generators(cfg, 3, torch.device("cpu"))(0))
    np.testing.assert_array_equal(ranks[0]["noise:tokens"], X["local"])
    np.testing.assert_array_equal(ranks[0]["noise:annotations"],
                                  X["global"])


def test_preemption_of_one_rank_stops_both_at_one_step(dp_ranks):
    """SIGTERM reached rank 1 alone, as it fetched its third batch: both
    ranks finished that step, saved step 3 (the ZeRO moments gathered
    over the group) and returned preempted, with the same losses."""
    ranks, _, out, _ = dp_ranks
    for r in ranks:
        assert bool(r["preempt:preempted"])
        assert int(r["preempt:step"]) == 3
        assert int(r["preempt:latest"]) == 3
        assert len(r["preempt:losses"]) == 3
    np.testing.assert_array_equal(ranks[0]["preempt:losses"],
                                  ranks[1]["preempt:losses"])
    saved = torch.load(out / "preempt_ck" / "3" / "state.pt",
                       weights_only=True)
    for mu, p in zip(saved["opt_state"]["mu"],
                     tree_leaves(saved["params"])):
        assert mu.shape == p.shape


def test_cli_pretrain_multihost_on_two_ranks(dp_ranks):
    """`pretrain --multihost` on both ranks: exit 0; only process 0 wrote
    config.json, its events and its metrics; run_start carries the mesh
    and two chips."""
    ranks, _, out, _ = dp_ranks
    assert [int(r["cli:rc"]) for r in ranks] == [0, 0]
    cli = out / "cli"
    assert (cli / "run" / "config.json").is_file()
    assert (cli / "ev0.jsonl").is_file() and (cli / "m0.jsonl").is_file()
    assert not (cli / "ev1.jsonl").exists()
    assert not (cli / "m1.jsonl").exists()
    events = [json.loads(line) for line in
              (cli / "ev0.jsonl").read_text().splitlines()]
    start = [e for e in events if e["event"] == "run_start"]
    assert len(start) == 1
    assert start[0]["mesh"] == {"data": 2, "fsdp": 1, "model": 1, "seq": 1}
    assert start[0]["n_chips"] == 2 and start[0]["zero_update"] is False
    assert sorted(os.listdir(cli / "run")) == ["2", "config.json"]


# -------------------------------------------- four ranks, data=2 x seq=2

def test_seq_by_data_with_zero_matches_jax(tmp_path):
    """data=2 x seq=2 with ZeRO-1 against JAX `make_seq_parallel_train_step`
    on a MeshConfig(data=2, seq=2) mesh of four CPU devices (the loss and
    the params after one step) and against the JAX gradients of the
    global batch's loss through the unsharded model."""
    jcfg = _cfg(jconfigs, "seq_data")
    rng = np.random.default_rng(8)
    tokens, ann = _tokens(rng, 4, 128)
    jparams = jax.tree.map(jnp.array, _jax_params())  # the step donates
    jstate = jts.TrainState(step=jnp.int32(0), params=jparams,
                            opt_state=j_make_opt(jcfg.optimizer).init(jparams),
                            key=jax.random.PRNGKey(0))
    flat0 = flatten_params(jstate.params)
    X, Y, W = j_corrupt(jax.random.PRNGKey(1), jnp.asarray(tokens),
                        jnp.asarray(ann), **IDENTITY)
    np.testing.assert_array_equal(np.asarray(X["local"]), tokens)
    arrays = {f"p:{k}": v for k, v in flat0.items()}
    arrays.update({"tokens": tokens, "annotations": ann})
    for n, dct in zip("XYW", (X, Y, W)):
        arrays.update({f"{n}_{k}": np.asarray(v) for k, v in dct.items()})
    (tmp_path / "spec.json").write_text(json.dumps(SPEC))
    np.savez(tmp_path / "inputs.npz", **arrays)
    t0 = time.perf_counter()
    ranks = _spawn(torch_dp_child.seq_data, 4, tmp_path)
    print(f"spawn {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    mesh = j_make_mesh(jcfg.mesh, jax.devices()[:4])

    def loss_fn(p):
        ll, gl = jmodel.apply(p, X["local"], X["global"], jcfg.model,
                              W["local"] > 0)
        return j_loss(ll, gl, Y, W)

    jgrads, jm = jax.jit(jax.grad(loss_fn, has_aux=True))(jstate.params)
    bsh = batch_sharding(mesh)
    jnew, jsm = j_make_seq_step(mesh, jcfg)(
        shard_train_state(jstate, mesh, zero_update=True),
        {k: jax.device_put(arrays[k], bsh[k])
         for k in ("tokens", "annotations")})
    jg = flatten_params(jgrads)
    jp = flatten_params(jax.device_get(jnew.params))
    print(f"jax {time.perf_counter() - t0:.1f} s")
    n = sum(v.size for v in flat0.values())
    for r in ranks:
        assert abs(float(r["m:loss"]) - float(jm["loss"])) <= 1e-5
        assert abs(float(r["s:loss"]) - float(jsm["loss"])) <= 1e-5
        assert int(r["s:mu_numel"]) < 0.6 * n   # ZeRO-1 moments
        for k, v in jg.items():
            _close(r[f"g:{k}"], v, 5e-4, k)
        for k, v in jp.items():
            _close(r[f"p:{k}"], v, 1e-5, k)
    moved = max(np.abs(ranks[0][f"p:{k}"] - v).max()
                for k, v in flat0.items())
    assert moved > 5e-5   # the step really updated (about the LR, 1e-4)
