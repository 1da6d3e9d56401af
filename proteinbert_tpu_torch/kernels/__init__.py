"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version (used for CPU tensors and as the on-card yardstick)."""

from proteinbert_tpu_torch.kernels.attention import (
    ATTENTION,
    attention_oh_reference,
    fused_attention,
    fused_global_attention,
    fused_packed_attention,
)
from proteinbert_tpu_torch.kernels.fused_block import (
    LOCAL_TRACK,
    TRACK_PARAMS,
    fused_local_track,
    local_track_reference,
)

# Every kernel of the serving path, in launch order within a block.
KERNELS = (LOCAL_TRACK, ATTENTION)

__all__ = [
    "ATTENTION",
    "KERNELS",
    "LOCAL_TRACK",
    "TRACK_PARAMS",
    "attention_oh_reference",
    "fused_attention",
    "fused_global_attention",
    "fused_local_track",
    "fused_packed_attention",
    "local_track_reference",
]
