"""Ranks of the port's mesh CPU tests (spawned by tests/test_torch_fsdp.py,
as tests/torch_dp_child.py is for the data-parallel ones). Each rank joins
a gloo process group through a FileStore, runs its cases on its rows of
the batches in `inputs.npz` and writes `<out>/rank<r>.npz`. Imports
torch, numpy and the port only."""

import os

import numpy as np
import torch
import torch.distributed as dist

from tests.torch_dp_child import _flat, _like, _params_flat, _rows, _spec
from tests.torch_seq_child import _join, _save


def _fresh_state(cfg, arrays, prefix="p:"):
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.schedule import make_optimizer
    from proteinbert_tpu_torch.weights import params_from_flat

    params = params_from_flat(_flat(arrays, prefix), cfg.model, device="cpu")
    return ts.TrainState(0, params, make_optimizer(cfg.optimizer).init(
        params), torch.Generator().manual_seed(0))


def fsdp_model(rank: int, world: int, store: str, out: str) -> None:
    """data=1 x fsdp=2 x model=2, plain and with ZeRO-1, then data=2 x
    fsdp=2 with ZeRO-1: one sharded step from the JAX params on this
    replica's rows; the full-shape state after it (params and moments,
    gathered), this rank's stored tensors, and a step file written by the
    mesh's Checkpointer. Then the quantized reduce-scatter on the data=2
    x fsdp=2 mesh (`_fsdp_quant`), and the sequence-parallel step on
    fsdp=2 x seq=2 and model=2 x seq=2 (`_seq_sharded`)."""
    from proteinbert_tpu_torch.parallel.fsdp import make_sharded_train_step
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.schedule import tree_leaves

    _join(rank, world, store)
    spec, cfg_of, arrays = _spec(out)
    res = {}
    for tag in ("plain", "zero", "zero_dp"):
        cfg = cfg_of(tag)
        mesh = make_mesh(cfg.mesh)
        batch = {k: _rows(arrays[k], mesh.data_index, mesh.data_extent)
                 for k in ("tokens", "annotations")}
        step = make_sharded_train_step(mesh, cfg)
        state, m = step(_fresh_state(cfg, arrays), batch)
        layout = state.layout
        res[f"{tag}:loss"] = np.asarray(float(m["loss"]))
        res[f"{tag}:grad_norm"] = np.asarray(float(m["grad_norm"]))
        res[f"{tag}:tp_cols"] = np.asarray(
            -1 if layout.tp is None else layout.tp.cols)
        for i, t in enumerate(tree_leaves(state.params)):
            res[f"{tag}:local:{i}"] = t.numpy()
            res[f"{tag}:stored:{i}"] = np.asarray(
                layout.plans[i].store[0] if layout.plans[i].store else "")
        for i, t in enumerate(state.opt_state.mu):
            res[f"{tag}:mu_local:{i}"] = t.numpy()
        full = layout.full_state(state)
        res.update({f"{tag}:p:{k}": v
                    for k, v in _params_flat(full.params).items()})
        for name in ("mu", "nu"):
            for i, t in enumerate(getattr(full.opt_state, name)):
                res[f"{tag}:{name}:{i}"] = t.numpy()
        res[f"{tag}:count"] = np.asarray(full.opt_state.count)
        res[f"{tag}:generator"] = full.generator.get_state().numpy()
        ck = Checkpointer(os.path.join(out, f"ck_{tag}"), async_save=False,
                          mesh=mesh)
        assert ck.save(int(state.step), state)
        ck.close()
    res.update(_fsdp_quant(cfg_of, arrays))
    res.update(_seq_sharded(spec, cfg_of, arrays, out))
    _save(out, rank, **res)
    dist.destroy_process_group()


def _fsdp_quant(cfg_of, arrays) -> dict:
    """The same ranks at data=2 x fsdp=2 under ZeRO-1: two steps on one
    batch of the fsdp step with fp32 gradients (the reference), then of
    the quantized reduce-scatter at each payload (int8 twice): the
    gathered params and first moments, this rank's stored tensors and
    moments, the losses, the gradient norms (the quantized steps': of the
    dequantized sum) and the gradient-reduction wire bytes."""
    from proteinbert_tpu_torch.obs.metrics import MetricsRegistry
    from proteinbert_tpu_torch.parallel.fsdp import make_sharded_train_step
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.parallel.quant import (
        make_quant_fsdp_train_step,
    )
    from proteinbert_tpu_torch.parallel.zero import (
        comm_bytes, grad_reduce_wire_bytes,
    )
    from proteinbert_tpu_torch.train.schedule import tree_leaves

    res = {}
    for tag, payload in (("qref", None), ("q_fp32", "fp32"),
                         ("q_bf16", "bf16"), ("q_int8", "int8"),
                         ("q_int8_again", "int8")):
        cfg = cfg_of("quant" if payload is None else tag)
        mesh = make_mesh(cfg.mesh)
        batch = {k: _rows(arrays[f"quant:{k}"], mesh.data_index,
                          mesh.data_extent)
                 for k in ("tokens", "annotations")}
        reg = MetricsRegistry()
        step = (make_sharded_train_step(mesh, cfg, reg) if payload is None
                else make_quant_fsdp_train_step(mesh, cfg, payload, reg))
        state = _fresh_state(cfg, arrays)
        losses, norms = [], []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        res[f"{tag}:losses"] = np.asarray(losses)
        res[f"{tag}:norms"] = np.asarray(norms)
        wire = comm_bytes(reg)[1]
        res[f"{tag}:wire"] = np.asarray(grad_reduce_wire_bytes(wire))
        res[f"{tag}:wire_kinds"] = np.asarray(
            [wire[k] for k in ("all-to-all", "all-reduce", "reduce-scatter")])
        full = state.layout.full_state(state)
        res.update({f"{tag}:p:{k}": v
                    for k, v in _params_flat(full.params).items()})
        for i, t in enumerate(full.opt_state.mu):
            res[f"{tag}:mu:{i}"] = t.numpy()
        for i, t in enumerate(tree_leaves(state.params)):
            res[f"{tag}:local:{i}"] = t.numpy()
        for i, t in enumerate(state.opt_state.mu):
            res[f"{tag}:mu_local:{i}"] = t.numpy()
    return res


def _seq_sharded(spec, cfg_of, arrays, out) -> dict:
    """The same ranks at fsdp=2 x seq=2 and at model=2 x seq=2, at the
    widths of `spec["seq_model"]`: one step of the sequence-parallel step
    on the sharded layout from the JAX params on this replica's rows,
    plain and with ZeRO-1 (fp32 and bf16); the loss, the gradient norm,
    this rank's stored tensors and moments, the gathered state (params,
    first moments) and, on fsdp x seq, a step file written by the mesh's
    Checkpointer and the loss of a second step on a second batch; then
    `pretrain` over the two batches on the plain fsdp x seq route."""
    from proteinbert_tpu_torch import configs
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.parallel.seq_parallel import (
        make_seq_parallel_train_step,
    )
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.trainer import pretrain

    model = configs.ModelConfig(**spec["seq_model"])
    res = {}
    for tag in spec["seq_tags"]:
        cfg = cfg_of(tag).replace(model=model)
        mesh = make_mesh(cfg.mesh)
        batches = [{k: _rows(arrays[f"seq{b}:{k}"], mesh.data_index,
                             mesh.data_extent)
                    for k in ("tokens", "annotations")} for b in (0, 1)]
        step = make_seq_parallel_train_step(mesh.seq_group, cfg, mesh=mesh)
        state, m = step(_fresh_state(cfg, arrays, "sp:"), batches[0])
        layout = state.layout
        res[f"{tag}:loss"] = np.asarray(float(m["loss"]))
        res[f"{tag}:grad_norm"] = np.asarray(float(m["grad_norm"]))
        for i, t in enumerate(tree_leaves(state.params)):
            res[f"{tag}:local:{i}"] = t.numpy()
            res[f"{tag}:stored:{i}"] = np.asarray(
                layout.plans[i].store[0] if layout.plans[i].store else "")
        for i, t in enumerate(state.opt_state.mu):
            res[f"{tag}:mu_local:{i}"] = t.numpy()
        full = layout.full_state(state)
        res.update({f"{tag}:p:{k}": v
                    for k, v in _params_flat(full.params).items()})
        res.update({f"{tag}:mu_flat:{k}": v for k, v in _params_flat(
            _like(full.params, full.opt_state.mu)).items()})
        if mesh.shape["fsdp"] > 1:
            for name in ("mu", "nu"):
                for i, t in enumerate(getattr(full.opt_state, name)):
                    res[f"{tag}:{name}:{i}"] = t.numpy()
            res[f"{tag}:count"] = np.asarray(full.opt_state.count)
            res[f"{tag}:generator"] = full.generator.get_state().numpy()
            ck = Checkpointer(os.path.join(out, f"ck_{tag}"),
                              async_save=False, mesh=mesh)
            assert ck.save(int(state.step), state, {"batches_consumed": 1})
            ck.close()
            # The second step updates the stored tensors in place: copy
            # what the arrays above share with them first.
            res = {k: np.array(v) for k, v in res.items()}
            state, m = step(state, batches[1])
            res[f"{tag}:loss2"] = np.asarray(float(m["loss"]))
    cfg = cfg_of(spec["seq_tags"][0]).replace(model=model)
    mesh = make_mesh(cfg.mesh)
    run = pretrain(cfg, iter([{k: _rows(arrays[f"seq{b}:{k}"],
                                        mesh.data_index, mesh.data_extent)
                               for k in ("tokens", "annotations")}
                              for b in (0, 1)]),
                   state=_fresh_state(cfg, arrays, "sp:"), mesh=mesh,
                   device="cpu")
    res["seq_pretrain:losses"] = np.asarray([h["loss"]
                                             for h in run["history"]])
    return res


def fsdp_resume(rank: int, world: int, store: str, out: str) -> None:
    """fsdp=2: `pretrain` for 3 steps with a checkpoint at step 2 and an
    eval of this replica's rows at step 3; then,
    on a seq=2 mesh of the same ranks, `seq_parallel_conv1d` of one array
    (this rank's block of the output)."""
    from proteinbert_tpu_torch.configs import MeshConfig
    from proteinbert_tpu_torch.parallel.halo import seq_parallel_conv1d
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.trainer import pretrain

    _join(rank, world, store)
    spec, cfg_of, arrays = _spec(out)
    cfg = cfg_of("resume")
    mesh = make_mesh(cfg.mesh)
    batches = [{k: arrays[f"resume{b}:{k}"] for k in ("tokens",
                                                       "annotations")}
               for b in range(int(spec["resume"]["batches"]))]

    def factory(skip):
        return iter([{k: _rows(v, mesh.data_index, mesh.data_extent)
                      for k, v in b.items()} for b in batches[skip:]])

    evals = {k: _rows(arrays[f"eval:{k}"], mesh.data_index, mesh.data_extent)
             for k in ("tokens", "annotations")}
    ck = Checkpointer(os.path.join(out, "ck"), async_save=False, mesh=mesh)
    run = pretrain(cfg, factory, checkpointer=ck, device="cpu", mesh=mesh,
                   state=_fresh_state(cfg, arrays),
                   eval_batches=lambda: iter([evals]))
    res = {"resume:losses": np.asarray([h["loss"] for h in run["history"]
                                        if "loss" in h]),
           "resume:eval_loss": np.asarray([h["eval_loss"]
                                           for h in run["history"]
                                           if "eval_loss" in h]),
           "resume:steps": np.asarray(ck.all_steps())}
    ck.close()

    smesh = make_mesh(MeshConfig(seq=2))
    params = {k: torch.from_numpy(arrays[f"conv:{k}"])
              for k in ("kernel", "bias")}
    y = seq_parallel_conv1d(smesh, params, torch.from_numpy(arrays["conv:x"]),
                            dilation=int(spec["conv_dilation"]))
    res["conv:y"] = y.numpy()
    _save(out, rank, **res)
    dist.destroy_process_group()
