"""The one-pass guard: the reference's choice between kernel #6 and the
two-kernel composition, with torch dtypes.

A copy of `proteinbert_tpu/kernels/one_pass.pallas_onepass_supported`
and the `kernels/vmem_budget.py` primitives it prices with. The TPU
kernel keeps both weight sets, the haloed row, its one-hot and the
attention temporaries resident in 13 MiB of VMEM; where that union does
not fit, the JAX package runs the composition (#1 or #3, then #5). The
port makes the SAME choice on the same shape, so each slice runs the same
kernel family as the reference: on CUDA the rule picks between two
hand-written kernel paths and never routes to a plain version.

Conventions the formulas encode: the lane (last) dim of a VMEM block
rounds up to a multiple of 128; blocks that vary with the batch grid axis
are double-buffered; float32 temporaries price at 4 bytes.
"""

from __future__ import annotations

import torch

MAX_PALLAS_DIM = 512
MAX_TILED_DIM = 2048
LANE = 128
VMEM_BUDGET = 13 * 1024 * 1024


def lanes(n: int) -> int:
    """Round up to the next multiple of the 128-wide lane dim."""
    return -(-n // LANE) * LANE


def fits(*byte_costs: int) -> bool:
    return sum(byte_costs) <= VMEM_BUDGET


def track_weight_bytes(local_dim: int, narrow_taps: int, wide_taps: int,
                       item: int) -> int:
    return (narrow_taps + wide_taps + 1) * local_dim * local_dim * item


def attention_weight_bytes(local_dim: int, global_dim: int, key_dim: int,
                           num_heads: int, item: int) -> int:
    v_dim = global_dim // num_heads
    return (num_heads * global_dim * lanes(key_dim)
            + num_heads * local_dim * lanes(key_dim)
            + num_heads * local_dim * lanes(v_dim)) * item


def attention_temp_bytes(seq_len: int, max_segments: int, global_dim: int,
                         key_dim: int, num_heads: int) -> int:
    v_dim = global_dim // num_heads
    return (seq_len * lanes(key_dim) + seq_len * lanes(v_dim)
            + 2 * seq_len * lanes(max_segments)
            + max_segments * lanes(global_dim)) * 4


def track_temp_bytes(tile: int, local_dim: int) -> int:
    return 3 * tile * local_dim * 4


def shape_prechecks(local_dim: int, seq_len: int,
                    max_segments: int = 1) -> bool:
    return not (local_dim % LANE or local_dim > MAX_TILED_DIM
                or seq_len < 8 or max_segments < 1)


def onepass_supported(
    local_dim: int, global_dim: int, seq_len: int, max_segments: int,
    key_dim: int, num_heads: int, dtype: torch.dtype = torch.bfloat16,
    narrow_taps: int = 9, wide_taps: int = 9,
    wide_dilation: int = 5, narrow_dilation: int = 1,
) -> bool:
    """Whether the reference runs this shape as ONE program (#6) rather
    than the composition — `pallas_onepass_supported`, term for term."""
    if not shape_prechecks(local_dim, seq_len, max_segments):
        return False
    if global_dim < 1 or global_dim % num_heads:
        return False
    if narrow_taps % 2 == 0 or wide_taps % 2 == 0:
        return False
    if key_dim % 8 or (global_dim // num_heads) % 8:
        return False
    if local_dim > MAX_PALLAS_DIM:
        return False
    item = dtype.itemsize
    C, G, L, S = local_dim, global_dim, seq_len, max_segments
    H, k = num_heads, key_dim
    halo = max((narrow_taps - 1) // 2 * narrow_dilation,
               (wide_taps - 1) // 2 * wide_dilation)
    Lp = L + 2 * halo
    row = 2 * Lp * C * item
    oh_row = 2 * Lp * lanes(S) * item
    real_col = 2 * L * lanes(1) * item
    bcast = 2 * S * C * item
    gseg = 2 * S * lanes(G) * item
    out_local = 2 * L * C * item
    out_attn = 2 * S * lanes(G) * item
    weights = (track_weight_bytes(C, narrow_taps, wide_taps, item)
               + attention_weight_bytes(C, G, k, H, item))
    temps = (track_temp_bytes(L, C)
             + L * lanes(S) * 4
             + L * C * item
             + attention_temp_bytes(L, S, G, k, H))
    return fits(row, oh_row, real_col, bcast, gseg, out_local, out_attn,
                weights, temps)
