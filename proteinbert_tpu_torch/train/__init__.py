"""Pretraining: loss, optimizer chain, train state and steps, FLOP/step-time
accounting, checkpoints (`checkpoint.Checkpointer`), the NaN halt and
graceful preemption, and the `pretrain` loop — the port of
`proteinbert_tpu/train/` without fine-tuning. Telemetry is the sibling
package `proteinbert_tpu_torch.obs`.

The names below load their module on first use, so that importing one
submodule (`train.loss`, `train.schedule`) does not pull in the model and
kernels that the checkpointer and the loop import."""

import importlib

_EXPORTS = {"Checkpointer": "checkpoint", "pretrain": "trainer"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
