"""Parallelism and quantization — port of `proteinbert_tpu/parallel/`. So
far: the serving half of `quant.py` (the int8 serving arm), and explicit
sequence parallelism over `torch.distributed` (`halo.py`,
`seq_parallel.py`).

The names below load their module on first use, so that importing one
submodule (serving's `parallel.quant`) does not pull in the training stack
that `seq_parallel` needs."""

import importlib

_EXPORTS = {
    "conv1d_halo": "halo",
    "group_size": "halo",
    "halo_exchange": "halo",
    "gather_seq": "seq_parallel",
    "make_seq_parallel_train_step": "seq_parallel",
    "seq_parallel_apply": "seq_parallel",
    "seq_parallel_loss_and_grads": "seq_parallel",
    "sharded_global_attention": "seq_parallel",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
