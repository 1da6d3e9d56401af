"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version (used for CPU tensors and as the on-card yardstick), the JAX
package's kernel gates (`budget`, with its limits `LANE`,
`MAX_PALLAS_DIM`, `MAX_TILED_DIM` and `VMEM_BUDGET`) and its route
counters under JAX's names (`PATH_TOTAL`, `ATTN_PATH_TOTAL`,
`ONEPASS_PATH_TOTAL` and their observers).

`__all__` is the JAX package's `kernels.__all__` less `NOT_PORTED`, plus
the port's own names (`PORT_ONLY`): the kernels and their launch counts,
the plain versions' backward references and the one-hot helper.
"""

from proteinbert_tpu_torch.kernels.attention import (
    ATTENTION,
    ATTENTION_Q8,
    ATTN_PATH_TOTAL,
    attention_oh_grad_reference,
    attention_oh_reference,
    fused_attention,
    fused_global_attention,
    fused_packed_attention,
    note_attention_path,
    register_attention_path_observer,
    segment_one_hot,
    unregister_attention_path_observer,
)
from proteinbert_tpu_torch.kernels.budget import (
    LANE,
    MAX_PALLAS_DIM,
    MAX_TILED_DIM,
    VMEM_BUDGET,
    pallas_attention_supported,
    pallas_segments_supported,
    pallas_supported,
)
from proteinbert_tpu_torch.kernels.budget import (
    onepass_supported as pallas_onepass_supported,
)
from proteinbert_tpu_torch.kernels.fused_block import (
    LOCAL_TRACK,
    LOCAL_TRACK_SEGMENTS,
    LOCAL_TRACK_SEGMENTS_Q8,
    LOCAL_TRACK_SEGMENTS_TILED,
    LOCAL_TRACK_TILED,
    LOCAL_TRACK_TILED_VALID,
    LOCAL_TRACK_VALID,
    PATH_TOTAL,
    TRACK_PARAMS,
    dequant_leaf,
    dequant_params,
    fused_local_track,
    fused_local_track_segments,
    fused_local_track_valid,
    gather_segment_broadcast,
    is_quant_leaf,
    local_track_grad_reference,
    local_track_reference,
    local_track_segment_oh_grad_reference,
    local_track_segment_oh_reference,
    local_track_segment_reference,
    local_track_valid_grad_reference,
    local_track_valid_reference,
    note_kernel_path,
    register_path_observer,
    track_halo,
    unregister_path_observer,
    weight_leaf,
)
from proteinbert_tpu_torch.kernels.one_pass import (
    ONEPASS,
    ONEPASS_PATH_TOTAL,
    ONEPASS_Q8,
    fused_onepass_dense,
    fused_onepass_segments,
    note_onepass_path,
    onepass_oh_grad_reference,
    onepass_oh_reference,
    register_onepass_path_observer,
    unregister_onepass_path_observer,
)

# Every kernel of the served and trained paths: K1, #3, K2, #6, #2, #4,
# then the int8 legs of #3, K2 and #6 (the int8 serving arm), then the
# prehaloed entries of K1 and #2 (sequence-parallel training).
KERNELS = (LOCAL_TRACK, LOCAL_TRACK_SEGMENTS, ATTENTION, ONEPASS,
           LOCAL_TRACK_TILED, LOCAL_TRACK_SEGMENTS_TILED,
           LOCAL_TRACK_SEGMENTS_Q8, ATTENTION_Q8, ONEPASS_Q8,
           LOCAL_TRACK_VALID, LOCAL_TRACK_TILED_VALID)

# JAX's exports with no counterpart here: its PBT_FORCE_REFERENCE_KERNEL
# debug switch, which forces the XLA reference route. On the card that
# would put the plain versions on the main path, which the port's
# launch-or-raise rule forbids; a route on a CUDA device raises while the
# variable is set (`budget.refuse_forced_reference`).
NOT_PORTED = ("FORCE_REFERENCE_ENV", "force_reference_requested")

# The port's names beyond JAX's: the kernels (each with its launch count),
# their list, the track's parameter names, the backward references, the
# attention's one-hot entry and helper, and the int8 leaf's dequantize.
PORT_ONLY = (
    "ATTENTION", "ATTENTION_Q8", "KERNELS", "LOCAL_TRACK",
    "LOCAL_TRACK_SEGMENTS", "LOCAL_TRACK_SEGMENTS_Q8",
    "LOCAL_TRACK_SEGMENTS_TILED", "LOCAL_TRACK_TILED",
    "LOCAL_TRACK_TILED_VALID", "LOCAL_TRACK_VALID", "ONEPASS", "ONEPASS_Q8",
    "TRACK_PARAMS", "attention_oh_grad_reference", "dequant_leaf",
    "fused_attention", "local_track_grad_reference",
    "local_track_segment_oh_grad_reference",
    "local_track_valid_grad_reference", "onepass_oh_grad_reference",
    "segment_one_hot",
)

__all__ = [
    "ATTENTION",
    "ATTENTION_Q8",
    "ATTN_PATH_TOTAL",
    "KERNELS",
    "LANE",
    "LOCAL_TRACK",
    "LOCAL_TRACK_SEGMENTS",
    "LOCAL_TRACK_SEGMENTS_Q8",
    "LOCAL_TRACK_SEGMENTS_TILED",
    "LOCAL_TRACK_TILED",
    "LOCAL_TRACK_TILED_VALID",
    "LOCAL_TRACK_VALID",
    "MAX_PALLAS_DIM",
    "MAX_TILED_DIM",
    "ONEPASS",
    "ONEPASS_PATH_TOTAL",
    "ONEPASS_Q8",
    "PATH_TOTAL",
    "TRACK_PARAMS",
    "VMEM_BUDGET",
    "attention_oh_grad_reference",
    "attention_oh_reference",
    "dequant_leaf",
    "dequant_params",
    "fused_attention",
    "fused_global_attention",
    "fused_local_track",
    "fused_local_track_segments",
    "fused_local_track_valid",
    "fused_onepass_dense",
    "fused_onepass_segments",
    "fused_packed_attention",
    "gather_segment_broadcast",
    "is_quant_leaf",
    "local_track_grad_reference",
    "local_track_reference",
    "local_track_segment_oh_grad_reference",
    "local_track_segment_oh_reference",
    "local_track_segment_reference",
    "local_track_valid_grad_reference",
    "local_track_valid_reference",
    "note_attention_path",
    "note_kernel_path",
    "note_onepass_path",
    "onepass_oh_grad_reference",
    "onepass_oh_reference",
    "pallas_attention_supported",
    "pallas_onepass_supported",
    "pallas_segments_supported",
    "pallas_supported",
    "register_attention_path_observer",
    "register_onepass_path_observer",
    "register_path_observer",
    "segment_one_hot",
    "track_halo",
    "unregister_attention_path_observer",
    "unregister_onepass_path_observer",
    "unregister_path_observer",
    "weight_leaf",
]
