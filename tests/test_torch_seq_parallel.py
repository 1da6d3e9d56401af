"""The port's sequence-parallel pretraining (`proteinbert_tpu_torch.parallel`
halo exchange, seq-parallel model and step, and the prehaloed local-track
entry) on the CPU, against the JAX package on the same numpy-made inputs
and weights (carried through the flat export layout), and the trainer's
NaN halt.

Multi-rank cases spawn gloo ranks (`tests/torch_seq_child.py`) that meet
through a FileStore under the test's tmp_path, each spawn bounded by its
own timeout. Tolerances, float32 throughout: the prehaloed track's plain
versions 1e-5 (the same arithmetic, other conv kernels); the halo exchange
exact (it moves rows and adds gradients, at most two terms per row); the
seq-parallel forward 2e-5 (a distributed softmax against the plain one,
the JAX test's own tolerance); the seq step's loss 1e-5, grads 5e-4 (the
JAX test's gradient tolerance, seq_parallel.py against the unsharded
model) and the params after one Adam step 1e-5 (a constant LR of 1e-4, so
a grad sign flip would show as 2e-4).
"""

import dataclasses
import json
import logging
import math
import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from proteinbert_tpu import configs as jconfigs
from proteinbert_tpu.data.corruption import corrupt_batch as j_corrupt
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.kernels import fused_block as jfused
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.parallel import (
    batch_sharding, make_mesh, shard_train_state,
)
from proteinbert_tpu.parallel.seq_parallel import (
    make_seq_parallel_train_step as j_make_seq_step,
    seq_parallel_apply as j_seq_parallel_apply,
)
from proteinbert_tpu.train import create_train_state as j_create_state
from proteinbert_tpu.train.loss import pretrain_loss as j_pretrain_loss
from proteinbert_tpu_torch import configs as tconfigs
from proteinbert_tpu_torch.kernels import fused_block as tfused
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.parallel import seq_parallel as tsp
from proteinbert_tpu_torch.train import train_state as tts
from proteinbert_tpu_torch.train.resilience import NonFiniteLossError
from proteinbert_tpu_torch.train.schedule import make_optimizer
from proteinbert_tpu_torch.train.trainer import pretrain
from proteinbert_tpu_torch.weights import params_from_flat, params_to_flat
from tests import torch_seq_child

torch.set_num_threads(1)

MODEL = dict(local_dim=16, global_dim=32, key_dim=8, num_heads=4,
             num_blocks=2, num_annotations=64, dtype="float32")
SPAWN_TIMEOUT = 150  # seconds for one spawned group, start-up included


def _spawn(fn, world, tmp_path):
    """Run fn(rank, world, store, out) in `world` spawned processes; →
    each rank's results."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, str(tmp_path / "store"),
                                          str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
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
    out = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def _track_params(rng, C):
    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def vec(base=0.0):
        return (base + 0.1 * rng.standard_normal(C)).astype(np.float32)

    return {"narrow_conv": {"kernel": w((9, C, C), 9 * C), "bias": vec()},
            "wide_conv": {"kernel": w((9, C, C), 9 * C), "bias": vec()},
            "local_ln1": {"scale": vec(1.0), "bias": vec()},
            "local_dense": {"kernel": w((C, C), C), "bias": vec()},
            "local_ln2": {"scale": vec(1.0), "bias": vec()}}


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# ----------------------------------------------- (a) the prehaloed entry

def test_valid_reference_matches_jax_with_real_halo_rows():
    """C=128, L=64 whose 20 halo rows each side are real data: the plain
    version and the backward reference against the JAX
    `local_track_valid_reference`."""
    rng = np.random.default_rng(0)
    C, L = 128, 64
    p = _track_params(rng, C)
    H = tfused.track_halo(_tree(p, torch.from_numpy), 1, 5)
    assert H == jfused.track_halo(_tree(p, jnp.asarray), 1, 5) == 20
    xh = rng.standard_normal((2, L + 2 * H, C)).astype(np.float32)
    bc = rng.standard_normal((2, C)).astype(np.float32)
    want = jfused.local_track_valid_reference(
        _tree(p, jnp.asarray), jnp.asarray(xh), jnp.asarray(bc), 1, 5)
    tp = _tree(p, torch.from_numpy)
    for fn in (tfused.local_track_valid_reference,
               tfused.local_track_valid_grad_reference,
               tfused.fused_local_track_valid):
        got = fn(tp, torch.from_numpy(xh), torch.from_numpy(bc), 1, 5)
        assert got.shape == (2, L, C)
        _close(got.numpy(), want, 1e-5)


def test_valid_matches_jax_pallas_interpret():
    """The shape of the JAX package's own prehaloed-kernel test (B=2,
    L=64, C=128): the port's wrapper (its plain version on the CPU)
    against the JAX `fused_local_track_valid` in interpret mode."""
    rng = np.random.default_rng(1)
    C, L, H = 128, 64, 20
    p = _track_params(rng, C)
    xh = rng.standard_normal((2, L + 2 * H, C)).astype(np.float32)
    bc = rng.standard_normal((2, C)).astype(np.float32)
    want = jfused.fused_local_track_valid(
        _tree(p, jnp.asarray), jnp.asarray(xh), jnp.asarray(bc), 1, 5, True)
    got = tfused.fused_local_track_valid(
        _tree(p, torch.from_numpy), torch.from_numpy(xh),
        torch.from_numpy(bc), 1, 5)
    _close(got.numpy(), want, 1e-5)


def test_valid_centre_of_zero_padded_row_and_stitched_shards():
    """With zero halo rows the centre is the 'SAME' track of the row (the
    JAX identity, tests/test_seq_parallel.py:44-58); with a row cut into
    4 shards carrying their neighbours' rows, the shards' centres are the
    row's track."""
    rng = np.random.default_rng(2)
    C, L, H = 16, 64, 20
    p = _tree(_track_params(rng, C), torch.from_numpy)
    x = torch.from_numpy(rng.standard_normal((2, L, C)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, C)).astype(np.float32))
    want = tfused.local_track_reference(p, x, b, 1, 5)
    xp = torch.nn.functional.pad(x, (0, 0, H, H))
    for fn in (tfused.local_track_valid_reference,
               tfused.local_track_valid_grad_reference):
        _close(fn(p, xp, b, 1, 5).numpy(), want.numpy(), 1e-5)
    Ls = L // 4
    shards = [tfused.fused_local_track_valid(
        p, xp[:, i * Ls:i * Ls + Ls + 2 * H], b, 1, 5) for i in range(4)]
    _close(torch.cat(shards, 1).numpy(), want.numpy(), 1e-5)


def test_valid_kernel_checks_shapes_before_launch():
    """The CUDA route's checks run before any launch: a width no kernel
    covers, and a row too short to hold a centre, raise ValueError."""
    rng = np.random.default_rng(3)
    p = _tree(_track_params(rng, 16), torch.from_numpy)
    with pytest.raises(ValueError, match="no kernel for C=16"):
        tfused._local_track_valid_kernel(p, torch.zeros(1, 48, 16),
                                         torch.zeros(1, 16), 1, 5)
    p = _tree(_track_params(rng, 128), torch.from_numpy)
    with pytest.raises(ValueError, match="no centre"):
        tfused._local_track_valid_kernel(p, torch.zeros(1, 40, 128),
                                         torch.zeros(1, 128), 1, 5)


# --------------------------------------------------- (b) halo exchange

HALO_CASES = [[32, 20, 0],   # one round
              [8, 20, 1],    # a shard shorter than the halo: multi-hop
              [5, 4, 2]]     # the narrow conv's halo, odd shard


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange_rows_and_adjoint(world, tmp_path):
    """Each rank's haloed block is the same slice of the zero-padded row;
    its centre gradient is that slice of the gradient of Σ_r <xh_r, r_r>
    with respect to the row; `conv1d_halo` (k=9, d=5) on the shards is the
    'SAME' conv of the row (1e-5: another conv algorithm on fewer rows)."""
    from proteinbert_tpu_torch.ops.layers import conv1d_apply

    (tmp_path / "spec.json").write_text(json.dumps({"cases": HALO_CASES}))
    ranks = _spawn(torch_seq_child.halo, world, tmp_path)
    for i, (L, H, seed) in enumerate(HALO_CASES):
        rng = np.random.default_rng(seed)
        full = rng.standard_normal((2, L * world, 3)).astype(np.float32)
        r = rng.standard_normal((world, 2, L + 2 * H, 3)).astype(np.float32)
        padded = np.pad(full, ((0, 0), (H, H), (0, 0)))
        gpad = np.zeros_like(padded)
        for k in range(world):
            gpad[:, k * L:k * L + L + 2 * H] += r[k]
        for k in range(world):
            np.testing.assert_array_equal(
                ranks[k][f"xh{i}"], padded[:, k * L:k * L + L + 2 * H])
            np.testing.assert_allclose(
                ranks[k][f"gx{i}"], gpad[:, H + k * L:H + (k + 1) * L],
                rtol=0, atol=1e-6)
        conv = {n: torch.from_numpy(v) for n, v in
                torch_seq_child.conv_params(seed).items()}
        want = conv1d_apply(conv, torch.from_numpy(full), 5).numpy()
        _close(np.concatenate([r[f"conv{i}"] for r in ranks], axis=1), want,
               1e-5)


def test_halo_exchange_without_group_only_pads():
    x = torch.arange(12.0).reshape(1, 4, 3)
    from proteinbert_tpu_torch.parallel import halo_exchange

    xh = halo_exchange(x, 2, None)
    assert torch.equal(xh, torch.nn.functional.pad(x, (0, 0, 2, 2)))


# ------------------------------------------- (c) the seq-parallel model

def _inputs(rng, B=4, L=128, A=64):
    tokens = rng.integers(4, 26, (B, L)).astype(np.int32)
    tokens[:, L - 16:] = 0   # real padding tails for the distributed softmax
    tokens[1, L - 40:] = 0   # one tail that crosses into another shard
    ann = (rng.random((B, A)) < 0.1).astype(np.float32)
    return tokens, ann


def _write_spec(tmp_path, jcfg, jparams, arrays):
    spec = {"model": dataclasses.asdict(jcfg.model),
            "data": dataclasses.asdict(jcfg.data),
            "optimizer": dataclasses.asdict(jcfg.optimizer)}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    flat = {f"p:{k}": v for k, v in flatten_params(jparams).items()}
    np.savez(tmp_path / "inputs.npz", **flat, **arrays)


def _cfgs(model=None, **opt):
    kw = dict(model=dict(model or MODEL), data=dict(seq_len=128,
                                                    batch_size=4),
              optimizer=dict(schedule="constant", learning_rate=1e-4,
                             warmup_steps=0, **opt),
              # No corruption: both packages' steps then see the clean
              # batch, whatever their generators draw.
              corrupt=dict(token_randomize_prob=0.0,
                           annotation_corrupt_prob=1.0,
                           annotation_drop_prob=0.0,
                           annotation_add_prob=0.0))

    def build(mod):
        return mod.PretrainConfig(
            model=mod.ModelConfig(**kw["model"]),
            data=mod.DataConfig(**kw["data"], **kw["corrupt"]),
            optimizer=mod.OptimizerConfig(**kw["optimizer"]),
            train=mod.TrainConfig(max_steps=1))

    return build(jconfigs), build(tconfigs)


@pytest.mark.parametrize("world", [2, 4])
def test_seq_parallel_apply_matches_unsharded_and_jax(world, tmp_path):
    jcfg, tcfg = _cfgs()
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg.model)
    tokens, ann = _inputs(np.random.default_rng(10 + world))
    _write_spec(tmp_path, jcfg, jparams, {"tokens": tokens,
                                          "annotations": ann})
    ranks = _spawn(torch_seq_child.apply, world, tmp_path)
    local = np.concatenate([r["local"] for r in ranks], axis=1)

    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    with torch.no_grad():
        want_l, want_g = tmodel.apply(tparams, torch.from_numpy(tokens),
                                      torch.from_numpy(ann), tcfg.model)
    mesh = make_mesh(jconfigs.MeshConfig(seq=world), jax.devices()[:world])
    jl, jg = j_seq_parallel_apply(mesh, jparams, jnp.asarray(tokens),
                                  jnp.asarray(ann), jcfg.model)
    for r in ranks:  # the replicated global track is the same everywhere
        np.testing.assert_array_equal(r["glob"], ranks[0]["glob"])
    for wl, wg in ((want_l.numpy(), want_g.numpy()), (jl, jg)):
        _close(local, wl, 2e-5)
        _close(ranks[0]["glob"], wg, 2e-5)


# ----------------------------------------------- (d) the seq train step

def test_seq_parallel_step_matches_unsharded_and_jax(tmp_path):
    """World 2, C=128 with use_pallas (the JAX step then runs
    `fused_local_track_valid` in interpret mode): loss, grads and the
    params after one Adam step against the port's unsharded step and the
    JAX seq-parallel step on a seq=2 mesh."""
    world = 2
    model = dict(MODEL, local_dim=128, use_pallas=True)
    jcfg, tcfg = _cfgs(model)
    tokens, ann = _inputs(np.random.default_rng(20))
    jstate = j_create_state(jax.random.PRNGKey(0), jcfg)
    X, Y, W = j_corrupt(jax.random.PRNGKey(1), jnp.asarray(tokens),
                        jnp.asarray(ann), token_randomize_prob=0.0,
                        annotation_corrupt_prob=1.0,
                        annotation_drop_prob=0.0, annotation_add_prob=0.0)
    np.testing.assert_array_equal(np.asarray(X["local"]), tokens)
    arrays = {"tokens": tokens, "annotations": ann}
    for n, d in zip("XYW", (X, Y, W)):
        arrays.update({f"{n}_{k}": np.asarray(v) for k, v in d.items()})
    _write_spec(tmp_path, jcfg, jstate.params, arrays)
    rank0 = _spawn(torch_seq_child.step, world, tmp_path)[0]

    # JAX: jax.grad of the seq step's own loss, then the step itself.
    mesh = make_mesh(jconfigs.MeshConfig(seq=world), jax.devices()[:world])

    def loss_fn(p):
        ll, gl = j_seq_parallel_apply(mesh, p, X["local"], X["global"],
                                      jcfg.model)
        return j_pretrain_loss(ll, gl, Y, W)

    jgrads, jm = jax.grad(loss_fn, has_aux=True)(jstate.params)
    flat0 = flatten_params(jstate.params)  # before the step donates them
    bsh = batch_sharding(mesh)
    jnew, jsm = j_make_seq_step(mesh, jcfg)(
        shard_train_state(jstate, mesh),
        {k: jax.device_put(v, bsh[k]) for k, v in arrays.items()
         if k in ("tokens", "annotations")})

    # The port's unsharded step on the same weights.
    tparams = params_from_flat(flat0, tcfg.model, device="cpu")
    tX, tY, tW = ({k: torch.from_numpy(np.array(v)) for k, v in d.items()}
                  for d in (X, Y, W))
    ugrads, um = tts.loss_and_grads(tparams, tX, tY, tW, tcfg)
    ustate = tts.TrainState(0, tparams,
                            make_optimizer(tcfg.optimizer).init(tparams),
                            torch.Generator().manual_seed(0))
    ustate, _ = tts.train_step(ustate, arrays, tcfg)

    for want in (float(jm["loss"]), float(jsm["loss"]), float(um["loss"])):
        assert abs(float(rank0["m:loss"]) - want) <= 1e-5
    assert float(rank0["s:loss"]) == float(rank0["m:loss"])
    jg_flat = flatten_params(jgrads)
    it = iter(ugrads)
    ug_flat = params_to_flat(_tree_like(tparams, it))
    for k, v in jg_flat.items():
        _close(rank0[f"g:{k}"], v, 5e-4)
        _close(rank0[f"g:{k}"], ug_flat[k], 5e-4)
    jp_flat = flatten_params(jax.device_get(jnew.params))
    up_flat = params_to_flat(ustate.params)
    moved = max(np.abs(rank0[f"p:{k}"] - v).max() for k, v in flat0.items())
    assert moved > 5e-5  # the step really updated (about the LR, 1e-4)
    for k, v in jp_flat.items():
        _close(rank0[f"p:{k}"], v, 1e-5)
        _close(rank0[f"p:{k}"], up_flat[k], 1e-5)


def _tree_like(params, it):
    if isinstance(params, dict):
        return {k: _tree_like(v, it) for k, v in params.items()}
    if isinstance(params, list):
        return [_tree_like(v, it) for v in params]
    return next(it)


# ---------------------------------------------------- (e) the refusals

def _tiny_state(tcfg):
    params = tmodel.init(tcfg.model, torch.Generator().manual_seed(0),
                         device="cpu")
    return tts.TrainState(0, params,
                          make_optimizer(tcfg.optimizer).init(params),
                          torch.Generator().manual_seed(1))


@pytest.mark.parametrize("case", ["packed", "int8_reduce", "length"])
def test_seq_step_refusals(case, monkeypatch):
    _, tcfg = _cfgs()
    tokens, ann = _inputs(np.random.default_rng(30), B=2, L=32)
    batch = {"tokens": tokens, "annotations": ann}
    if case == "packed":
        batch["segment_ids"] = (tokens > 0).astype(np.int32)
        step = tsp.make_seq_parallel_train_step(None, tcfg)
        with pytest.raises(NotImplementedError, match="packed batches"):
            step(_tiny_state(tcfg), batch)
    elif case == "int8_reduce":
        cfg = dataclasses.replace(tcfg, parallel=tconfigs.ParallelConfig(
            zero_update=True, grad_reduce_dtype="int8"))
        with pytest.raises(ValueError, match="grad_reduce_dtype='int8'"):
            tsp.make_seq_parallel_train_step(None, cfg)
    else:
        # A 3-rank group seen from a batch of 32 rows: the step refuses
        # before any collective.
        monkeypatch.setattr(tsp, "group_size", lambda group: 3)
        step = tsp.make_seq_parallel_train_step(object(), tcfg)
        with pytest.raises(ValueError, match="does not split over 3"):
            step(_tiny_state(tcfg), batch)


SHARDED_SHAPE = {"data": 1, "fsdp": 2, "model": 1, "seq": 2}


@pytest.mark.parametrize("case", ["int8", "packed", "plateau"])
def test_sharded_seq_step_refusals_match_jax(case):
    """The JAX refusals of the seq step on a seq x fsdp mesh, word for
    word: the int8 ZeRO reduction (QuantConfigError), a packed batch
    (NotImplementedError) and the trainer's eval-keyed plateau
    (ValueError). The port's mesh is this rank's view only: each refusal
    comes before any collective."""
    from proteinbert_tpu.parallel.quant import QuantConfigError
    from proteinbert_tpu.train.trainer import pretrain as j_pretrain
    from proteinbert_tpu_torch.parallel.mesh import Mesh
    from proteinbert_tpu_torch.parallel.quant import (
        QuantConfigError as TQuantConfigError,
    )

    jcfg, tcfg = _cfgs(dict(MODEL, use_pallas=True))
    mesh_cfg = dict(fsdp=2, seq=2)
    jcfg = dataclasses.replace(jcfg, mesh=jconfigs.MeshConfig(**mesh_cfg))
    tcfg = dataclasses.replace(tcfg, mesh=tconfigs.MeshConfig(**mesh_cfg))
    jmesh = make_mesh(jcfg.mesh, jax.devices()[:4])
    mesh = Mesh(shape=dict(SHARDED_SHAPE), rank=0,
                coords={ax: 0 for ax in SHARDED_SHAPE})
    assert mesh.sharded
    tokens, ann = _inputs(np.random.default_rng(31), B=4, L=32)
    batch = {"tokens": tokens, "annotations": ann}
    if case == "int8":
        par = {"zero_update": True, "grad_reduce_dtype": "int8"}
        jcfg = dataclasses.replace(jcfg, parallel=jconfigs.ParallelConfig(
            **par))
        tcfg = dataclasses.replace(tcfg, parallel=tconfigs.ParallelConfig(
            **par))
        with pytest.raises(QuantConfigError) as want:
            j_make_seq_step(jmesh, jcfg)
        with pytest.raises(TQuantConfigError) as got:
            tsp.make_seq_parallel_train_step(None, tcfg, mesh=mesh)
    elif case == "packed":
        batch["segment_ids"] = (tokens > 0).astype(np.int32)
        with pytest.raises(NotImplementedError) as want:
            j_make_seq_step(jmesh, jcfg)(None, batch)
        step = tsp.make_seq_parallel_train_step(None, tcfg, mesh=mesh)
        with pytest.raises(NotImplementedError) as got:
            step(None, batch)
    else:
        opt = {"plateau_metric": "eval_loss", "schedule": "warmup_plateau"}
        jcfg = dataclasses.replace(jcfg, optimizer=dataclasses.replace(
            jcfg.optimizer, **opt), train=jconfigs.TrainConfig(
                max_steps=1, eval_every=1))
        tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
            tcfg.optimizer, **opt), train=tconfigs.TrainConfig(
                max_steps=1, eval_every=1))
        with pytest.raises(ValueError) as want:
            j_pretrain(jcfg, iter([batch]), mesh=jmesh,
                       eval_batches=lambda: iter([batch]))
        with pytest.raises(ValueError) as got:
            pretrain(tcfg, iter([batch]), mesh=mesh, device="cpu",
                     eval_batches=lambda: iter([batch]))
    assert str(got.value) == str(want.value)


# ------------------------------------- the trainer: seq group, NaN halt

def _loop_cfg(**train):
    _, tcfg = _cfgs()
    return dataclasses.replace(
        tcfg, data=dataclasses.replace(tcfg.data, seq_len=32, batch_size=2),
        train=tconfigs.TrainConfig(max_steps=3, log_every=1, **train))


def _batches(n, seed=40):
    rng = np.random.default_rng(seed)
    return iter([dict(zip(("tokens", "annotations"),
                          _inputs(rng, B=2, L=32))) for _ in range(n)])


def test_pretrain_with_a_one_rank_group_matches_the_plain_loop(tmp_path):
    """`pretrain(..., seq_group=g)` with g a one-rank gloo group: no
    collective runs, and the losses are the plain loop's (a distributed
    softmax against the kernel-form one, 1e-5)."""
    cfg = _loop_cfg()
    plain = pretrain(cfg, _batches(3), device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        seq = pretrain(cfg, _batches(3), device="cpu",
                       seq_group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert len(seq["history"]) == 3
    for a, b in zip(plain["history"], seq["history"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5


@pytest.mark.parametrize("on_nan", ["halt", "warn", "off"])
def test_pretrain_nan_halt(on_nan, caplog):
    """A NaN in the params makes the first logged loss NaN: "halt" raises
    NonFiniteLossError, "warn" logs and trains on, "off" trains on
    silently."""
    cfg = _loop_cfg(on_nan=on_nan)
    state = _tiny_state(cfg)
    with torch.no_grad():
        state.params["global_head"]["bias"][0] = float("nan")
    caplog.set_level(logging.WARNING)
    if on_nan == "halt":
        with pytest.raises(NonFiniteLossError, match="non-finite loss"):
            pretrain(cfg, _batches(3), state=state, device="cpu")
        return
    out = pretrain(cfg, _batches(3), state=state, device="cpu")
    assert len(out["history"]) == 3
    assert math.isnan(out["history"][0]["loss"])
    warned = [r for r in caplog.records if "on_nan=warn" in r.getMessage()]
    assert len(warned) == (3 if on_nan == "warn" else 0)
