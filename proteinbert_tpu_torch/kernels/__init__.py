"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version (used for CPU tensors and as the on-card yardstick)."""

from proteinbert_tpu_torch.kernels.attention import (
    ATTENTION,
    ATTENTION_Q8,
    attention_oh_reference,
    fused_attention,
    fused_global_attention,
    fused_packed_attention,
    segment_one_hot,
)
from proteinbert_tpu_torch.kernels.fused_block import (
    LOCAL_TRACK,
    LOCAL_TRACK_SEGMENTS,
    LOCAL_TRACK_SEGMENTS_Q8,
    LOCAL_TRACK_SEGMENTS_TILED,
    LOCAL_TRACK_TILED,
    TRACK_PARAMS,
    dequant_leaf,
    dequant_params,
    fused_local_track,
    fused_local_track_segments,
    gather_segment_broadcast,
    is_quant_leaf,
    local_track_reference,
    local_track_segment_oh_reference,
    local_track_segment_reference,
    weight_leaf,
)
from proteinbert_tpu_torch.kernels.one_pass import (
    ONEPASS,
    ONEPASS_Q8,
    fused_onepass_dense,
    fused_onepass_segments,
    onepass_oh_reference,
)

# Every kernel of the served and trained paths: K1, #3, K2, #6, #2, #4,
# then the int8 legs of #3, K2 and #6 (the int8 serving arm).
KERNELS = (LOCAL_TRACK, LOCAL_TRACK_SEGMENTS, ATTENTION, ONEPASS,
           LOCAL_TRACK_TILED, LOCAL_TRACK_SEGMENTS_TILED,
           LOCAL_TRACK_SEGMENTS_Q8, ATTENTION_Q8, ONEPASS_Q8)

__all__ = [
    "ATTENTION",
    "ATTENTION_Q8",
    "KERNELS",
    "LOCAL_TRACK",
    "LOCAL_TRACK_SEGMENTS",
    "LOCAL_TRACK_SEGMENTS_Q8",
    "LOCAL_TRACK_SEGMENTS_TILED",
    "LOCAL_TRACK_TILED",
    "ONEPASS",
    "ONEPASS_Q8",
    "TRACK_PARAMS",
    "attention_oh_reference",
    "dequant_leaf",
    "dequant_params",
    "fused_attention",
    "fused_global_attention",
    "fused_local_track",
    "fused_local_track_segments",
    "fused_onepass_dense",
    "fused_onepass_segments",
    "fused_packed_attention",
    "gather_segment_broadcast",
    "is_quant_leaf",
    "local_track_reference",
    "local_track_segment_oh_reference",
    "local_track_segment_reference",
    "onepass_oh_reference",
    "segment_one_hot",
    "weight_leaf",
]
