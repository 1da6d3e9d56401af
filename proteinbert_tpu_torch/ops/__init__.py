"""The layers — the port of `proteinbert_tpu/ops/`: dense, layer norm,
conv1d and embedding (`layers.py`) and the global attention
(`attention.py`), each an `*_apply` over a params dict in the JAX layout.

The names are the JAX package's `*_apply` functions. Its `*_init`
functions (`dense_init`, `layer_norm_init`, `conv1d_init`,
`embedding_init`, `global_attention_init`) have no counterpart here: the
port makes a model's params in one place, `models.proteinbert.init` (and
`models.finetune` for the heads), from a `torch.Generator`, and takes
trained ones from either package through `weights.py`.
"""

from proteinbert_tpu_torch.ops.layers import (
    dense_apply,
    layer_norm_apply,
    conv1d_apply,
    embedding_apply,
)
from proteinbert_tpu_torch.ops.attention import global_attention_apply

# The JAX package's exports that have no counterpart in the port (above).
NOT_PORTED = ("dense_init", "layer_norm_init", "conv1d_init",
              "embedding_init", "global_attention_init")

__all__ = [
    "dense_apply",
    "layer_norm_apply",
    "conv1d_apply",
    "embedding_apply",
    "global_attention_apply",
]
