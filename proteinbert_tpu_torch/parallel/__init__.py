"""Parallelism and quantization — port of `proteinbert_tpu/parallel/` over
`torch.distributed`: the process group (`multihost.py`), the data × fsdp
× model × seq mesh (`mesh.py`), the layout rules (`sharding.py`), FSDP
placement and the sharded step (`fsdp.py`), the GO head's tensor
parallelism (`tensor_parallel.py`), ZeRO-1 and the comm accounting
(`zero.py`), `quant.py` (the quantized reduce-scatter and the int8
serving arm), explicit sequence parallelism (`halo.py`,
`seq_parallel.py`, on a data-only or a sharded layout), checkpoint
resharding (`reshard.py`) and the one-process serving mesh
(`mesh.serve_mesh`).

The names below load their module on first use, so that importing one
submodule (serving's `parallel.quant`) does not pull in the training stack
that `seq_parallel` needs."""

import importlib

_EXPORTS = {
    "Mesh": "mesh",
    "MeshLayout": "fsdp",
    "QuantConfigError": "quant",
    "TensorParallel": "tensor_parallel",
    "ZeroLayout": "zero",
    "batch_sharding": "sharding",
    "check_quant_mesh": "quant",
    "conv1d_halo": "halo",
    "group_size": "halo",
    "halo_exchange": "halo",
    "leaf_spec": "sharding",
    "local_batch_size": "sharding",
    "make_mesh": "mesh",
    "make_quant_fsdp_train_step": "quant",
    "make_quant_zero_train_step": "quant",
    "make_sharded_train_step": "fsdp",
    "make_zero_train_step": "zero",
    "maybe_initialize_distributed": "multihost",
    "mesh_for_devices": "mesh",
    "mesh_from_config": "reshard",
    "param_spec": "sharding",
    "parse_mesh_spec": "reshard",
    "per_chip_state_bytes": "zero",
    "gather_seq": "seq_parallel",
    "make_seq_parallel_train_step": "seq_parallel",
    "reshard_checkpoint": "reshard",
    "reshard_schedule_bytes": "reshard",
    "seq_parallel_apply": "seq_parallel",
    "seq_parallel_conv1d": "halo",
    "seq_parallel_loss_and_grads": "seq_parallel",
    "ServeMesh": "mesh",
    "serve_batch_sharding": "sharding",
    "serve_mesh": "mesh",
    "sharded_global_attention": "seq_parallel",
    "states_byte_identical": "reshard",
    "tree_digest": "reshard",
    "zero_dim": "sharding",
    "zero_extent": "zero",
    "zero_gradient_update": "zero",
    "zero_update_spec": "sharding",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
