"""Task heads on one shared trunk — port of `proteinbert_tpu/heads/`.

- `registry` — content-addressed, self-verifying head artifacts (head
  params + TaskConfig + the fingerprint of the trunk they were trained
  against), in the JAX package's format. Typed failures:
  `UnknownHeadError` (a serving 404), `CorruptHeadError`,
  `TrunkMismatchError`.
- `apply` — split apply: one trunk pass shared by every head of a batch
  (on the card the port's kernels, captured as one CUDA graph per served
  shape), then each distinct head's tail.
- `eval` — downstream metrics of registered heads (`head_eval` events).

Producers: `train/finetune.finetune(..., registry=)`. Consumers:
`serve/server.Server(registry=, heads=)` and `Server.predict_task`.
"""

from proteinbert_tpu_torch.heads.registry import (
    CorruptHeadError,
    HeadRegistry,
    HeadRegistryError,
    LoadedHead,
    TrunkMismatchError,
    UnknownHeadError,
    trunk_fingerprint,
)

__all__ = [
    "HeadRegistry",
    "LoadedHead",
    "HeadRegistryError",
    "UnknownHeadError",
    "CorruptHeadError",
    "TrunkMismatchError",
    "trunk_fingerprint",
]
