"""Ranks of the port's sequence-parallel CPU tests (spawned by
tests/test_torch_seq_parallel.py). Each rank joins a gloo process group
through a FileStore, runs one case on its slice and writes its results to
`<out>/rank<r>.npz`. Imports torch, numpy and the port only."""

import json
import os

import numpy as np
import torch
import torch.distributed as dist


def conv_params(seed: int):
    """A k=9 conv over 3 channels, made from `seed`."""
    rng = np.random.default_rng(seed + 100)
    return {"kernel": rng.standard_normal((9, 3, 3)).astype(np.float32),
            "bias": rng.standard_normal(3).astype(np.float32)}


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def _save(out: str, rank: int, **arrays) -> None:
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)


def _load_spec(out: str):
    from proteinbert_tpu_torch import configs

    with open(os.path.join(out, "spec.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(out, "inputs.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    cfg = configs.PretrainConfig(
        model=configs.ModelConfig(**spec["model"]),
        data=configs.DataConfig(**spec["data"]),
        optimizer=configs.OptimizerConfig(**spec["optimizer"]))
    flat = {k[2:]: v for k, v in arrays.items() if k.startswith("p:")}
    return cfg, flat, arrays


def halo(rank: int, world: int, store: str, out: str) -> None:
    """For each case (L_shard, halo, seed) of spec.json: this rank's slice
    of one numpy row through `halo_exchange`, then the backward of
    <xh, r_rank>; and the slice through `conv1d_halo` (k=9, d=5)."""
    from proteinbert_tpu_torch.parallel import conv1d_halo, halo_exchange

    _join(rank, world, store)
    with open(os.path.join(out, "spec.json")) as f:
        cases = json.load(f)["cases"]
    res = {}
    for i, (L, h, seed) in enumerate(cases):
        rng = np.random.default_rng(seed)
        full = rng.standard_normal((2, L * world, 3)).astype(np.float32)
        r = rng.standard_normal((world, 2, L + 2 * h, 3)).astype(np.float32)
        x = torch.from_numpy(full[:, rank * L:(rank + 1) * L].copy())
        x.requires_grad_(True)
        xh = halo_exchange(x, h, dist.group.WORLD)
        (xh * torch.from_numpy(r[rank])).sum().backward()
        res[f"xh{i}"] = xh.detach().numpy()
        res[f"gx{i}"] = x.grad.numpy()
        conv = {k: torch.from_numpy(v) for k, v in conv_params(seed).items()}
        with torch.no_grad():
            res[f"conv{i}"] = conv1d_halo(conv, x, 5,
                                          dist.group.WORLD).numpy()
    _save(out, rank, **res)
    dist.destroy_process_group()


def apply(rank: int, world: int, store: str, out: str) -> None:
    """`seq_parallel_apply` on this rank's slice of the tokens."""
    from proteinbert_tpu_torch.parallel import seq_parallel_apply
    from proteinbert_tpu_torch.weights import params_from_flat

    _join(rank, world, store)
    cfg, flat, arrays = _load_spec(out)
    params = params_from_flat(flat, cfg.model, device="cpu")
    tokens = torch.from_numpy(arrays["tokens"])
    Ls = tokens.shape[1] // world
    with torch.no_grad():
        local, glob = seq_parallel_apply(
            dist.group.WORLD, params, tokens[:, rank * Ls:(rank + 1) * Ls],
            torch.from_numpy(arrays["annotations"]), cfg.model)
    _save(out, rank, local=local.numpy(), glob=glob.numpy())
    dist.destroy_process_group()


def step(rank: int, world: int, store: str, out: str) -> None:
    """`seq_parallel_loss_and_grads` on the corrupted batch of
    inputs.npz, then one `make_seq_parallel_train_step` step on its clean
    batch from a fresh optimizer state: grads, metrics and the params
    after the update, as flat arrays."""
    from proteinbert_tpu_torch.parallel import (
        make_seq_parallel_train_step, seq_parallel_loss_and_grads,
    )
    from proteinbert_tpu_torch.train import train_state as tts
    from proteinbert_tpu_torch.train.schedule import (
        make_optimizer, tree_leaves,
    )
    from proteinbert_tpu_torch.weights import params_from_flat, params_to_flat

    _join(rank, world, store)
    cfg, flat, arrays = _load_spec(out)
    params = params_from_flat(flat, cfg.model, device="cpu")
    X, Y, W = ({"local": torch.from_numpy(arrays[f"{n}_local"]),
                "global": torch.from_numpy(arrays[f"{n}_global"])}
               for n in "XYW")
    grads, metrics = seq_parallel_loss_and_grads(
        dist.group.WORLD, params, X, Y, W, cfg)
    it = iter(grads)

    def like(t):
        if isinstance(t, dict):
            return {k: like(v) for k, v in t.items()}
        if isinstance(t, list):
            return [like(v) for v in t]
        return next(it)

    gflat = params_to_flat(like(params))
    assert len(grads) == len(tree_leaves(params))
    state = tts.TrainState(0, params, make_optimizer(cfg.optimizer).init(
        params), torch.Generator().manual_seed(0))
    batch = {"tokens": arrays["tokens"], "annotations": arrays["annotations"]}
    state, m = make_seq_parallel_train_step(dist.group.WORLD, cfg)(state,
                                                                   batch)
    res = {f"g:{k}": v for k, v in gflat.items()}
    res.update({f"p:{k}": v for k, v in params_to_flat(state.params).items()})
    res.update({f"m:{k}": np.asarray(float(v)) for k, v in metrics.items()})
    res.update({f"s:{k}": np.asarray(float(v)) for k, v in m.items()})
    _save(out, rank, **res)
    dist.destroy_process_group()
