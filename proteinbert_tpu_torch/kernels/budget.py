"""The JAX package's kernel gates, with torch dtypes.

Copies, term for term, of `proteinbert_tpu/kernels/one_pass.
pallas_onepass_supported`, `fused_block.pallas_supported` (with the
`_plan_tiled` pricing it calls), `fused_block.pallas_segments_supported`
and `attention.pallas_attention_supported`, and of the
`kernels/vmem_budget.py` primitives they price with. Each asks whether
the TPU kernel's working set fits 13 MiB of VMEM; where it does not, the
JAX package runs something else: the composition (#1 or #3, then #5) in
place of #6, the XLA reference in place of a local-track or attention
kernel. The port asks the same questions on the same shape
(`fused_block.track_route`, `attention.attention_route`,
`one_pass.onepass_route`), so each block runs the family the reference
runs.
They are predicates on shapes and dtypes only.

Conventions the formulas encode: the lane (last) dim of a VMEM block
rounds up to a multiple of 128; blocks that vary with the batch grid axis
are double-buffered; float32 temporaries price at 4 bytes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

MAX_PALLAS_DIM = 512
MAX_TILED_DIM = 2048
LANE = 128
VMEM_BUDGET = 13 * 1024 * 1024


# JAX's debug switch (`fused_block.FORCE_REFERENCE_ENV`): every local-track
# dispatch on the XLA reference. The port does not port it
# (`kernels.NOT_PORTED`): on the card it would put the plain versions on
# the main path, which the launch-or-raise rule forbids.
_FORCE_REFERENCE_ENV = "PBT_FORCE_REFERENCE_KERNEL"


def refuse_forced_reference(name: str,
                            device: Optional[torch.device]) -> None:
    """RuntimeError where a route runs on a CUDA `device` while JAX's
    force-reference switch is on (parsed as JAX parses it: unset, empty,
    "0" and "false" mean off), so that nobody trusts a forced route that
    does not happen; nothing on the CPU or for `device` None."""
    if device is None or torch.device(device).type != "cuda":
        return
    if os.environ.get(_FORCE_REFERENCE_ENV, "").strip().lower() in (
            "", "0", "false"):
        return
    raise RuntimeError(
        f"{name}: {_FORCE_REFERENCE_ENV} is set, and the port has no forced "
        f"reference route: on a CUDA device every route the kernels cover "
        f"launches its kernel. Unset it.")


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


def pick_tile(L: int) -> int:
    """The TPU kernel's row tile (`fused_block._pick_tile`)."""
    for cand in (512, 256, 128):
        if L > cand and L % cand == 0:
            return cand
    return L


def plan_tiled(C: int, seq_len: int, dtype: torch.dtype,
               narrow_taps: int = 9, wide_taps: int = 9,
               wide_dilation: int = 5, resident: bool = False,
               max_segments: int = 0):
    """(c_tile, l_tile) of the widest-channel channel-tiled plan that
    fits the VMEM budget, or (0, 0) — `fused_block._plan_tiled`, term for
    term (its `max_segments > 0` prices the segment variant)."""
    if narrow_taps != wide_taps:
        return 0, 0
    item = dtype.itemsize
    halo = max((narrow_taps - 1) // 2, (wide_taps - 1) // 2 * wide_dilation)
    seg_lanes = -(-max_segments // LANE) * LANE if max_segments else 0
    for tc in (512, 256, 128):
        if C % tc:
            continue
        for tile in (pick_tile(seq_len), 128):
            if seq_len % tile:
                continue
            conv_w = 2 * narrow_taps * C * tc * item
            dense = C * C * item
            row = 2 * (seq_len + 2 * halo) * C * item
            out = 2 * tile * C * item
            scratch = (seq_len if resident else tile) * C * 4
            finish = tile * C * (4 + 4 + 4 + item)
            seg = 0
            if max_segments:
                seg = (2 * (seq_len + 2 * halo) * seg_lanes * item
                       + 2 * max_segments * C * item
                       + tile * seg_lanes * 4)
            if (conv_w + dense + row + out + scratch + finish + seg
                    <= VMEM_BUDGET):
                return tc, tile
    return 0, 0


def pallas_supported(
    local_dim: int, seq_len: int, dtype: torch.dtype = torch.bfloat16,
    narrow_taps: int = 9, wide_taps: int = 9, wide_dilation: int = 5,
) -> bool:
    """Whether the reference runs the dense local track (and its
    prehaloed entry, on the shard's own L) on its Pallas kernel rather
    than XLA — `fused_block.pallas_supported`, term for term."""
    if not shape_prechecks(local_dim, seq_len):
        return False
    item = dtype.itemsize
    C = local_dim
    halo = max((narrow_taps - 1) // 2, (wide_taps - 1) // 2 * wide_dilation)
    tile = pick_tile(seq_len)
    if C > MAX_PALLAS_DIM:
        return plan_tiled(C, seq_len, dtype, narrow_taps, wide_taps,
                          wide_dilation)[0] > 0
    weights = track_weight_bytes(C, narrow_taps, wide_taps, item)
    row = (seq_len + 2 * halo) * C * item
    temps = track_temp_bytes(tile, C)
    return fits(weights, row, temps)


def pallas_segments_supported(
    local_dim: int, seq_len: int, max_segments: int,
    dtype: torch.dtype = torch.bfloat16,
    narrow_taps: int = 9, wide_taps: int = 9,
    wide_dilation: int = 5, narrow_dilation: int = 1,
) -> bool:
    """Whether the reference runs the packed local track on its segment
    kernel rather than XLA — `fused_block.pallas_segments_supported`,
    term for term."""
    if not shape_prechecks(local_dim, seq_len, max_segments):
        return False
    if narrow_taps % 2 == 0 or wide_taps % 2 == 0:
        return False
    if local_dim > MAX_PALLAS_DIM:
        return plan_tiled(local_dim, seq_len, dtype, narrow_taps, wide_taps,
                          wide_dilation, max_segments=max_segments)[0] > 0
    item = dtype.itemsize
    C = local_dim
    halo = max((narrow_taps - 1) // 2 * narrow_dilation,
               (wide_taps - 1) // 2 * wide_dilation)
    tile = pick_tile(seq_len)
    Lp = seq_len + 2 * halo
    weights = track_weight_bytes(C, narrow_taps, wide_taps, item)
    row = Lp * C * item
    oh_row = Lp * lanes(max_segments) * item
    bcast = max_segments * C * item
    temps = track_temp_bytes(tile, C) + tile * lanes(max_segments) * 4
    return fits(weights, row, oh_row, bcast, temps)


def pallas_attention_supported(
    local_dim: int, global_dim: int, seq_len: int, max_segments: int,
    key_dim: int, num_heads: int, dtype: torch.dtype = torch.bfloat16,
) -> bool:
    """Whether the reference runs the global attention (S = 1: dense) on
    its Pallas kernel rather than XLA —
    `attention.pallas_attention_supported`, term for term."""
    if not shape_prechecks(local_dim, seq_len, max_segments):
        return False
    if global_dim < 1 or global_dim % num_heads:
        return False
    item = dtype.itemsize
    C, G, L, S, H, k = (local_dim, global_dim, seq_len, max_segments,
                        num_heads, key_dim)
    row = 2 * L * C * item
    oh = 2 * L * lanes(S) * item
    gseg = 2 * S * lanes(G) * item
    out = 2 * S * lanes(G) * item
    weights = attention_weight_bytes(C, G, k, H, item)
    temps = attention_temp_bytes(L, S, G, k, H)
    return fits(row, oh, gseg, out, weights, temps)
