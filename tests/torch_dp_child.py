"""Ranks of the port's data-parallel CPU tests (spawned by
tests/test_torch_data_parallel.py, as tests/torch_seq_child.py is for the
sequence-parallel ones). Each rank joins a gloo process group through a
FileStore, runs its cases on its rows of the batches in `inputs.npz` and
writes `<out>/rank<r>.npz`. Imports torch, numpy and the port only."""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from tests.torch_seq_child import _join, _save


def _spec(out: str):
    from proteinbert_tpu_torch import configs

    with open(os.path.join(out, "spec.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(out, "inputs.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def cfg(name):
        c = spec[name]
        return configs.PretrainConfig(
            model=configs.ModelConfig(**spec["model"]),
            data=configs.DataConfig(**c["data"]),
            optimizer=configs.OptimizerConfig(**c["optimizer"]),
            mesh=configs.MeshConfig(**c["mesh"]),
            parallel=configs.ParallelConfig(**c.get("parallel", {})),
            train=configs.TrainConfig(**c.get("train", {})),
            checkpoint=configs.CheckpointConfig(**c.get("checkpoint", {})))

    return spec, cfg, arrays


def _rows(a: np.ndarray, index: int, extent: int) -> np.ndarray:
    n = a.shape[0] // extent
    return a[index * n:(index + 1) * n]


def _flat(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _like(params, leaves):
    it = iter(leaves)

    def put(t):
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        if isinstance(t, list):
            return [put(v) for v in t]
        return next(it)

    return put(params)


def _params_flat(params):
    from proteinbert_tpu_torch.weights import params_to_flat

    return params_to_flat(params)


def data_parallel(rank: int, world: int, store: str, out: str) -> None:
    """data=2: (a) the share loss and reduced grads of the dense and the
    packed corrupted batches; (b) one ZeRO-1 update from given gradients;
    (c) two steps of the replicated step and of the quantized step at
    each payload (int8 twice), with their wire bytes; (d) a ZeRO run with
    a checkpoint; (e) an eval pooled over the group, and the eval
    corruption of one batch; (f) a ZeRO run that rank 1 alone is asked to
    stop (SIGTERM) before its third step; (g) the command line's
    `pretrain --multihost`."""
    import signal

    from proteinbert_tpu_torch.cli.main import main as cli_main
    from proteinbert_tpu_torch.obs.metrics import MetricsRegistry
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.parallel.quant import (
        make_quant_zero_train_step,
    )
    from proteinbert_tpu_torch.parallel.zero import (
        ZeroLayout, all_reduce_flat, comm_bytes, grad_reduce_wire_bytes,
        moments_full, zero_gradient_update,
    )
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.schedule import (
        make_optimizer, tree_leaves,
    )
    from proteinbert_tpu_torch.train.trainer import pretrain
    from proteinbert_tpu_torch.weights import params_from_flat

    _join(rank, world, store)
    spec, cfg_of, arrays = _spec(out)
    res = {}
    cfg = cfg_of("grads")
    mesh = make_mesh(cfg.mesh)
    group = mesh.data_group
    i, d = mesh.data_index, mesh.data_extent

    def fresh():
        return params_from_flat(_flat(arrays, "p:"), cfg.model, device="cpu")

    # (a) this rank's share, dense and packed, summed over the group.
    for kind in ("dense", "packed"):
        X, Y, W = ({"local": torch.from_numpy(_rows(arrays[f"{kind}:{n}_local"],
                                                    i, d)),
                    "global": torch.from_numpy(_rows(
                        arrays[f"{kind}:{n}_global"], i, d))}
                   for n in "XYW")
        seg = (torch.from_numpy(_rows(arrays["packed:seg"], i, d))
               if kind == "packed" else None)
        params = fresh()
        grads, m = ts.replica_loss_and_grads(params, X, Y, W, cfg, seg,
                                             group)
        grads = all_reduce_flat(grads, group)
        res[f"{kind}:loss"] = np.asarray(float(m["loss"]))
        for k, v in _params_flat(_like(params, grads)).items():
            res[f"{kind}:g:{k}"] = v

    # (b) ZeRO-1 from the given gradients: each rank holds half of them.
    params = fresh()
    full = params_from_flat(_flat(arrays, "G:"), cfg.model, device="cpu")
    partials = [g * 0.5 for g in tree_leaves(full)]
    layout = ZeroLayout(mesh, params)
    opt = make_optimizer(cfg.optimizer).init(params)
    opt, norm = zero_gradient_update(layout, cfg.optimizer, partials, opt)
    opt = moments_full(opt, params, group)
    res["zero:norm"] = np.asarray(float(norm))
    res["zero:sharded"] = np.asarray(len(layout.sharded))
    for name, tree in (("p", params), ("mu", _like(params, opt.mu)),
                       ("nu", _like(params, opt.nu))):
        for k, v in _params_flat(tree).items():
            res[f"zero:{name}:{k}"] = v

    # (c) two steps on one batch: replicated, then each payload.
    qcfg = cfg_of("quant")
    batch = {k: _rows(arrays[f"quant:{k}"], i, d)
             for k in ("tokens", "annotations")}
    runs = [("plain", None), ("fp32", "fp32"), ("bf16", "bf16"),
            ("int8", "int8"), ("int8_again", "int8")]
    for name, payload in runs:
        reg = MetricsRegistry()
        params = fresh()
        state = ts.TrainState(0, params,
                              make_optimizer(qcfg.optimizer).init(params),
                              torch.Generator().manual_seed(5))
        step = (ts.make_data_parallel_train_step(mesh, qcfg, reg)
                if payload is None else
                make_quant_zero_train_step(mesh, qcfg, payload, reg))
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        res[f"{name}:losses"] = np.asarray(losses)
        res[f"{name}:wire"] = np.asarray(grad_reduce_wire_bytes(
            comm_bytes(reg)[1]))
        for k, v in _params_flat(state.params).items():
            res[f"{name}:p:{k}"] = v

    # (d) ZeRO-1 pretrain for 4 steps, a checkpoint every 2.
    zcfg = cfg_of("resume")
    zmesh = make_mesh(zcfg.mesh)
    n_batches = int(spec["resume"]["batches"])
    global_batches = [{k: arrays[f"resume{b}:{k}"]
                       for k in ("tokens", "annotations")}
                      for b in range(n_batches)]

    def factory(skip):
        return iter([{k: _rows(v, zmesh.data_index, zmesh.data_extent)
                      for k, v in b.items()} for b in global_batches[skip:]])

    ck = Checkpointer(os.path.join(out, "zero_ck"), async_save=False,
                      mesh=zmesh)
    run = pretrain(zcfg, factory, checkpointer=ck, device="cpu", mesh=zmesh)
    ck.close()
    res["resume:losses"] = np.asarray([h["loss"] for h in run["history"]])
    res["resume:mu_shard"] = np.asarray(sum(
        m.numel() for m in run["state"].opt_state.mu))

    # (e) an eval of this rank's rows of the four batches, pooled.
    from proteinbert_tpu_torch.train.trainer import evaluate_batches

    params = fresh()
    state = ts.TrainState(0, params, make_optimizer(zcfg.optimizer).init(
        params), torch.Generator().manual_seed(0))
    metrics, n, rows = evaluate_batches(
        state, factory(0), zcfg, lambda b: torch.Generator().manual_seed(b),
        group=zmesh.data_group)
    res.update({f"eval:{k}": np.asarray(v) for k, v in metrics.items()})
    res["eval:n"], res["eval:rows"] = np.asarray(n), np.asarray(rows)
    # The same clean rows on both ranks, corrupted by the generator that
    # `evaluate` gives this rank (the default corruption).
    from proteinbert_tpu_torch.train.trainer import eval_generators

    pcfg = cfg_of("preempt")
    gen = eval_generators(pcfg, 3, torch.device("cpu"), zmesh.data_group)(0)
    X, _, _, _ = ts.corrupt_for_step(state, global_batches[0], pcfg, gen)
    res["noise:tokens"] = X["local"].numpy()
    res["noise:annotations"] = X["global"].numpy()

    # (f) ZeRO-1 for up to 6 steps; rank 1 is signalled as it fetches the
    # third batch, rank 0 never: both stop after that step and save it.
    pmesh = make_mesh(pcfg.mesh)

    def signalled(skip):
        for b, batch in enumerate(factory(skip)):
            if rank == 1 and b == 2:
                signal.raise_signal(signal.SIGTERM)
            yield batch

    ck = Checkpointer(os.path.join(out, "preempt_ck"), async_save=False,
                      mesh=pmesh)
    run = pretrain(pcfg, signalled, checkpointer=ck, device="cpu",
                   mesh=pmesh)
    res["preempt:latest"] = np.asarray(ck.latest_step())
    ck.close()
    res["preempt:preempted"] = np.asarray(run["preempted"])
    res["preempt:step"] = np.asarray(int(run["state"].step))
    res["preempt:losses"] = np.asarray([h["loss"] for h in run["history"]])

    # (g) the command line on both ranks (the group is already formed,
    # so --multihost joins it and leaves it formed).
    cli_dir = os.path.join(out, "cli")
    rc = cli_main(["--device", "cpu", "pretrain", "--multihost",
                   "--preset", "tiny", "--max-steps", "2",
                   "--checkpoint-dir", os.path.join(cli_dir, "run"),
                   "--events-jsonl", os.path.join(cli_dir, f"ev{rank}.jsonl"),
                   "--metrics-jsonl",
                   os.path.join(cli_dir, f"m{rank}.jsonl"),
                   "--set", "mesh.data=2", "--set", "data.batch_size=4",
                   "--set", "train.log_every=1"])
    res["cli:rc"] = np.asarray(rc)
    _save(out, rank, **res)
    dist.destroy_process_group()


def seq_data(rank: int, world: int, store: str, out: str) -> None:
    """data=2 x seq=2 with ZeRO-1: the gradients of the global loss (the
    seq-summed share gradients summed over the data group) on the
    corrupted batch, then one step on the clean rows from a fresh
    state."""
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.parallel.seq_parallel import (
        make_seq_parallel_train_step, seq_parallel_loss_and_grads,
    )
    from proteinbert_tpu_torch.parallel.zero import all_reduce_flat
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.schedule import make_optimizer
    from proteinbert_tpu_torch.weights import params_from_flat

    _join(rank, world, store)
    spec, cfg_of, arrays = _spec(out)
    cfg = cfg_of("seq_data")
    mesh = make_mesh(cfg.mesh)
    i, d = mesh.data_index, mesh.data_extent
    params = params_from_flat(_flat(arrays, "p:"), cfg.model, device="cpu")
    X, Y, W = ({"local": torch.from_numpy(_rows(arrays[f"{n}_local"], i, d)),
                "global": torch.from_numpy(_rows(arrays[f"{n}_global"], i, d))}
               for n in "XYW")
    grads, m = seq_parallel_loss_and_grads(
        mesh.seq_group, params, X, Y, W, cfg, mesh.data_group)
    grads = all_reduce_flat(grads, mesh.data_group)
    res = {f"g:{k}": v for k, v in _params_flat(_like(params, grads)).items()}
    res["m:loss"] = np.asarray(float(m["loss"]))
    state = ts.TrainState(0, params, make_optimizer(cfg.optimizer).init(
        params), torch.Generator().manual_seed(0))
    batch = {k: _rows(arrays[k], i, d) for k in ("tokens", "annotations")}
    step = make_seq_parallel_train_step(mesh.seq_group, cfg, mesh=mesh)
    state, m = step(state, batch)
    res["s:loss"] = np.asarray(float(m["loss"]))
    res["s:mu_numel"] = np.asarray(sum(t.numel() for t in state.opt_state.mu))
    res.update({f"p:{k}": v for k, v in _params_flat(state.params).items()})
    _save(out, rank, **res)
    dist.destroy_process_group()
