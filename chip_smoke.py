#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. build    — nvcc builds every kernel of the paths from
              `proteinbert_tpu_torch/csrc/` (one process per source, in
              parallel) for sm_90a.
2. kernels  — each kernel's wrapper against its plain PyTorch version on the
              card, in bfloat16 and float32 (TF32 off for matmul and cuDNN),
              B=8, L in {128, 512} timed and a ragged L=100:
              K1 and K2 at base width (C=G=512, H=8, k=64) with padded,
              all-pad and S=8 segment cases, plus C=128/256;
              #3 at base width with S=8 packed rows (a cross-segment pad gap,
              ids above S, an empty segment);
              #6 at C=128 (G=512, H=4, v=128) and C=256 (G=512, H=8), dense
              (a half-padded and an all-pad row) and packed (S=8, an empty
              segment that must come back +0.0), and at C=512 (G=512, H=4,
              L=128, bf16), where `fused_onepass_segments` must pick it (as
              it must for the base preset's H=8 at L=8);
              cross-segment isolation of #3, #6 and #4 bit for bit;
              #2 at ProteinBERT-Large width (C=1024, B=8) in bf16 and fp32,
              L in {128, 1024} timed, L=100 with a constant (all-<pad>) row;
              #4 at Large width (C=1024, B=8, S=8) in bf16 and fp32, L in
              {128, 1024} timed and L=100, with segment boundaries on a
              64-row conv tile edge, inside a 32-row finish tile and inside a
              tile's 20-row halo;
              K2 at Large width (C=G=1024, H=16, L=1024) dense and packed
              (S=8) timed, and at value_dim 128 (C=256, G=512, H=4);
              the prehaloed entries of K1 (C=512) and #2 (C=1024)
              (`fused_local_track_valid`), bf16 and fp32: one L=2048 row
              cut into shards of 512 / 256 rows with their neighbours' 20
              rows, each shard's centre bit for bit the whole row's
              `fused_local_track`; a middle shard against the plain
              version, timed at B=16 L=512+2*20 C=512 and B=8 L=256+2*20
              C=1024; the train phases' shapes (B=4 L=2048+2*20 C=512,
              B=8 L=1024+2*20 C=1024, zero halos) against the plain
              version;
              the int8 legs (int8 weights, quantized as the int8 serving arm
              holds them): #3-int8 at base width (S=8), K2-int8 at base width
              dense and packed and at value_dim 128, #6-int8 at C=128/256
              dense and packed and at C=512 (bf16, H=4, L=128), bf16 and
              fp32, L=512 timed and L=100 with an all-pad row and an empty
              segment: each exactly (max |diff| == 0.0) the fp leg's output on
              the dequantized weights, an empty segment +0.0. Prints
              max |kernel - plain| against its tolerance, kernel and plain ms
              (CUDA events, median of 25), the bound and launches per call,
              and each int8 leg's ms beside its fp leg's.
   gradients — every autograd Function (K1 and #2 through
              `fused_local_track` and `fused_local_track_valid`, #3 and #4
              through `fused_local_track_segments`, K2, #6): the grads of
              sum(out * r) through the kernel, fp32 and bf16, against
              float32 autograd of the backward reference (the port of the
              JAX XLA reference) on the same inputs cast up; then
              2-block fp32 Large-width train steps,
              dense and packed, their loss and grads on the card against the
              same steps on the CPU plain path, and each packed protein's
              loss terms against the same protein run alone as a dense row.
3. reference — a base-width float32 trunk through the kernels on the card
              against the plain path on the CPU, on a small input; then a
              float32 2-block base-width trunk served ragged and bucketed on
              the card, the answers within 1e-3; then the same trunk int8
              (`quant_entry` / `quant_packed_entry`) on the card against the
              CPU plain path, bucketed (K1 + K2-int8) and ragged (#3-int8 +
              K2-int8), within 1e-3.
4. serve    — three servers, random weights from a seeded torch.Generator,
              buckets (128, 256, 512), seq_len 512, bf16, max_batch 8; 24
              mixed requests (20-500 residues) from 4 threads, then drain:
              a. bucketed, base preset (6 blocks, C=G=512, 8943 annotations):
                 exactly 6 launches of K1 and of K2 per batch, none of #3/#6;
              b. ragged (`serve_mode="ragged"`, 8 segments a row), base
                 preset: exactly 6 of #3 and of K2 per batch, none of K1/#6;
              c. ragged at the ModelConfig default width (C=128, G=512, H=4,
                 6 blocks): exactly 6 of #6 per batch, none of the others.
              Each checks every answer and each embed against the same
              sequence run alone, prints requests/s and p50/p99, and a
              torch.profiler breakdown of one full 8x512 batch and the
              device memory after load. Each then runs again on the int8 arm
              (`quant="int8"`, quant_parity_every=0, same weights and
              traffic): a'. exactly 6 of K1 and of K2-int8 per batch; b'. 6 of
              #3-int8 and of K2-int8; c'. 6 of #6-int8 — none of the fp legs
              of K2, #3, #6 — its quant_report, and max |int8 - fp32 arm|
              over the answers (must be > 0). Then the parity shadow
              (quant_parity_every=1: parity_max equals the deviation measured
              outside) and 12 requests on the `int8_act` arm (a'.'s counts).
              Every kernel count is set to 0 just before each server's
              traffic and read just after it.
5. train    — `pretrain()` on the `large` preset at full depth and width
              (12 blocks, C=G=1024, H=16, 8943 annotations), bf16, seq_len
              1024, B=8, 6 steps (1 warm, 5 timed), twice:
              a. dense rows of 100-1022 residues: exactly 12 launches of #2
                 and of K2 per step and none of the others;
              b. packed rows (`make_packed_iterator`, 8 segments a row) of
                 50-500 residues: exactly 12 of #4 and of K2 per step;
              finite losses, params moved by step 2; step ms, tokens/s, MFU,
              peak memory and a split of one step (packed: also the share of
              real positions and segments a row), each printed beside the
              same step with the float32 backward (`# bf16 backward`).
              Then 2 steps each of the
              `base` preset (B=8, L=512) dense (exactly 6 of K1 and of K2
              per step) and packed (6 of #3 and of K2), and of the
              ModelConfig default width packed (6 of #6). Then sequence
              parallelism, `pretrain(..., seq_group=g)` with g a one-rank
              NCCL group made in this process:
              c. `long seq` — the `long` preset at full depth and width (6
                 blocks, C=G=512, H=8, 8943 annotations), bf16, seq_len
                 2048, B=4 (the preset's 64 rows x 2048 over 16 chips;
                 cuts: seq world 4 -> 1, data 4 -> 1), its LR 2e-4 with
                 no warmup, 6 steps: exactly 6 launches of K1's prehaloed entry per
                 step and none of the others, finite and falling loss;
                 step ms, tokens/s, MFU, peak memory, one step's split;
              d. `large seq` — the `large` preset, B=8, L=1024, 2 steps:
                 exactly 12 of #2's prehaloed entry per step.
              Counts are zeroed before each run.
6. report   — the kernel JSON line, the card's name and power limit, and the
              result line {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (dense): bf16 tensor cores, float32 CUDA cores,
# HBM bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Tolerances of kernel vs plain on the card. float32: both sum the same
# float32 products in another order (thousands of terms per output, then
# LayerNorm). bfloat16: both round at the same points, but a sum that lands
# next to a rounding boundary can round the other way, and a flipped x1 or
# softmax weight moves the output by about one bf16 step of its magnitude;
# outputs are LayerNorm-scaled (|y| < 8), where a bf16 step is 2^-5.
# #3 and #6 share K1's local-track arithmetic; #6's attention reads its own
# local output, so a flipped bf16 step there moves the attention by about
# as much as a flipped step of the local track moves the track.
TOL = {("local_track", torch.float32): 1e-4,
       ("local_track", torch.bfloat16): 0.0625,
       ("global_attention", torch.float32): 1e-4,
       ("global_attention", torch.bfloat16): 0.03125,
       ("local_track_segments", torch.float32): 1e-4,
       ("local_track_segments", torch.bfloat16): 0.0625,
       ("one_pass", torch.float32): 1e-4,
       ("one_pass", torch.bfloat16): 0.0625,
       ("local_track_tiled", torch.float32): 1e-4,
       ("local_track_tiled", torch.bfloat16): 0.0625,
       ("local_track_segments_tiled", torch.float32): 1e-4,
       ("local_track_segments_tiled", torch.bfloat16): 0.0625}
# The prehaloed entries run K1's and #2's device code: their tolerances.
for _dtype in (torch.float32, torch.bfloat16):
    TOL[("local_track_valid", _dtype)] = TOL[("local_track", _dtype)]
    TOL[("local_track_tiled_valid", _dtype)] = TOL[("local_track_tiled",
                                                     _dtype)]
# An int8 leg against its plain version: the fp leg's tolerance (it must
# give exactly the fp leg's output on the dequantized weights).
for _name in ("local_track_segments", "global_attention", "one_pass"):
    for _dtype in (torch.float32, torch.bfloat16):
        TOL[(_name + "_q8", _dtype)] = TOL[(_name, _dtype)]
# Gradients through a kernel's autograd Function against float32 autograd
# of the reference its backward differentiates, on the same inputs cast up.
# fp32: the largest |diff| as a share of the largest |grad| (the same sums,
# in cuDNN's and cuBLAS's order). bf16: the largest over inputs of
# ||g_bf16 - g_fp32|| / ||g_fp32||, the measure and limit of
# tests/test_torch_grads_dtype.py (about eight bf16 ulps): a bf16 backward
# rounds its recomputed activations, products and GELU chain rule, which
# moves each grad by about 1% in norm (0.67-1.26% on the CPU at these
# shapes).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
STEP_LOSS_TOL = 1e-4   # 2-block fp32 train step, card vs CPU plain path
STEP_GRAD_TOL = 1e-3
SOLO_LOSS_TOL = 1e-4   # fp32 per-segment loss terms, packed vs alone
# Device-code names of the hand-written kernels, as the profiler lists them.
KERNEL_NAMES = ("local_track_kernel", "attention_kernel", "onepass",
                "tiled_conv_kernel", "tiled_finish_kernel")
# The Large steps, dense and packed, as this script measured them when the
# kernels' backward still recomputed in float32 (NVIDIA H100 80GB HBM3,
# 700.00 W): one profiled step's ms, its forward, backward and optimizer
# ms, the median step ms, peak GB.
F32_BACKWARD_LARGE = {"large": (539.2, 51.2, 456.8, 29.8, 531.7, 11.22),
             "large packed": (473.1, 66.2, 381.8, 23.3, 474.4, 14.90)}
REF_TOL = 1e-3        # float32 trunk, 2 blocks: kernels vs CPU plain path
RAGGED_TOL = 1e-3     # float32 trunk, 2 blocks: ragged vs bucketed answers
SERVE_EMBED_TOL = 0.05  # bf16 trunk: served batch row vs the row run alone
BUCKETS = (128, 256, 512)
REPS = 25
DEVICE = "cuda"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median of REPS single-call CUDA-event timings, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


# ------------------------------------------------------------ phase 2

def kernel_phase(card: str):
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK, TRACK_PARAMS, attention_oh_reference,
        fused_global_attention, fused_local_track, fused_packed_attention,
        local_track_reference,
    )
    from proteinbert_tpu_torch.kernels.attention import attention_flops
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    cfg = get_preset("base").model
    gen = torch.Generator().manual_seed(1)
    dev = torch.device(DEVICE)
    block = to_device(block_init(gen, cfg), dev)
    C, G, H, k = cfg.local_dim, cfg.global_dim, cfg.num_heads, cfg.key_dim
    B = 8
    rows = {}
    print(f"# kernels vs plain on {card}: torch.backends.cuda.matmul."
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        # Weights in the activation dtype once, as the model's forward
        # casts them (LN vectors stay float32).
        cast = cast_block(block, dtype)
        track = {name: cast[name] for name in TRACK_PARAMS}
        attn = cast["attention"]
        for L in (128, 512):
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            bc = torch.randn((B, C), generator=gen).to(dev, dtype)
            got = fused_local_track(track, x, bc, 1, cfg.wide_dilation)
            want = local_track_reference(track, x, bc, 1, cfg.wide_dilation)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(torch.isfinite(got).all().item(), "local_track non-finite")
            nbytes = (2 * B * L * C + B * C + 19 * C * C) * s + 7 * C * 4
            b_ms, b_by = bound(local_track_flops(B, L, C), nbytes, dtype)
            n0 = LOCAL_TRACK.launches
            fused_local_track(track, x, bc, 1, cfg.wide_dilation)
            per_call = LOCAL_TRACK.launches - n0
            check(per_call == 1, f"local_track launched {per_call} times "
                                 "in one call")
            ms = time_ms(lambda: fused_local_track(track, x, bc, 1,
                                                   cfg.wide_dilation))
            plain = time_ms(lambda: local_track_reference(
                track, x, bc, 1, cfg.wide_dilation))
            rows[("local_track", dtype, L, "dense")] = (
                err, ms, plain, b_ms, b_by, per_call)

            g = torch.randn((B, G), generator=gen).to(dev, dtype)
            pad = torch.ones((B, L), dtype=torch.bool, device=dev)
            pad[1, L // 2:] = False   # half-padded row
            pad[2, :] = False         # all-pad row: uniform softmax
            oh = pad[..., None].float()
            got = fused_global_attention(attn, x, g, pad)
            want = attention_oh_reference(attn, x, g[:, None, :], oh,
                                          zero_empty=False).reshape(B, G)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(torch.isfinite(got).all().item(), "attention non-finite")
            nbytes = ((B * L * C + B * G * 2 + H * (G * k + 2 * C * k)) * s
                      + B * L * 4)
            b_ms, b_by = bound(attention_flops(B, L, C, G, 1, H, k), nbytes,
                               dtype)
            n0 = ATTENTION.launches
            fused_global_attention(attn, x, g, pad)
            per_call = ATTENTION.launches - n0
            check(per_call == 1, f"global_attention launched {per_call} "
                                 "times in one call")
            ms = time_ms(lambda: fused_global_attention(attn, x, g, pad))
            plain = time_ms(lambda: attention_oh_reference(
                attn, x, g[:, None, :], oh, zero_empty=False))
            rows[("global_attention", dtype, L, "dense")] = (
                err, ms, plain, b_ms, b_by, per_call)

            # S=8 packed rows, segment 8 empty everywhere: exact zeros.
            S = 8
            seg = torch.randint(0, S, (B, L), generator=gen).to(dev)
            gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
            got = fused_packed_attention(attn, x, gs, seg)
            ids = torch.arange(1, S + 1, device=dev)
            oh = (seg[..., None] == ids).float()
            want = attention_oh_reference(attn, x, gs, oh)
            torch.cuda.synchronize()
            check(bool((got[:, S - 1] == 0).all()),
                  "empty segment not exactly zero")
            err = (got.float() - want.float()).abs().max().item()
            nbytes = ((B * L * C + 2 * B * S * G + H * (G * k + 2 * C * k))
                      * s + B * L * S * 4)
            b_ms, b_by = bound(attention_flops(B, L, C, G, S, H, k), nbytes,
                               dtype)
            n0 = ATTENTION.launches
            fused_packed_attention(attn, x, gs, seg)
            per_call = ATTENTION.launches - n0
            check(per_call == 1, f"packed global_attention launched "
                                 f"{per_call} times in one call")
            ms = time_ms(lambda: fused_packed_attention(attn, x, gs, seg))
            plain = time_ms(lambda: attention_oh_reference(attn, x, gs, oh))
            rows[("global_attention", dtype, L, "S=8")] = (
                err, ms, plain, b_ms, b_by, per_call)

    # The kernels' narrower widths, with a ragged last tile (L=100 is a
    # multiple of neither kernel's row tile): correctness only.
    for width in (128, 256):
        small = dataclasses.replace(cfg, local_dim=width, global_dim=width,
                                    num_heads=width // k)
        blk = to_device(block_init(gen, small), dev)
        for dtype in (torch.bfloat16, torch.float32):
            cast = cast_block(blk, dtype)
            track = {name: cast[name] for name in TRACK_PARAMS}
            x = torch.randn((2, 100, width), generator=gen).to(dev, dtype)
            bc = torch.randn((2, width), generator=gen).to(dev, dtype)
            g = torch.randn((2, width), generator=gen).to(dev, dtype)
            pad = torch.ones((2, 100), dtype=torch.bool, device=dev)
            pad[1, 60:] = False
            got = fused_local_track(track, x, bc, 1, small.wide_dilation)
            want = local_track_reference(track, x, bc, 1, small.wide_dilation)
            got2 = fused_global_attention(cast["attention"], x, g, pad)
            want2 = attention_oh_reference(
                cast["attention"], x, g[:, None, :], pad[..., None].float(),
                zero_empty=False).reshape(2, width)
            torch.cuda.synchronize()
            for name, a, b in (("local_track", got, want),
                               ("global_attention", got2, want2)):
                err = (a.float() - b.float()).abs().max().item()
                rows[(name, dtype, 100, f"C={width}")] = (
                    err, None, None, None, None, None)

    return rows


def print_rows(card: str, rows: dict) -> None:
    """The kernel table, each row checked against its tolerance."""
    print(f"{'kernel':21s} {'dtype':9s} {'L':>4s} {'case':13s} "
          f"{'max_abs_err':>12s} {'tol':>8s} {'ms':>9s} {'plain_ms':>9s} "
          f"{'bound_ms':>9s}  bound_by   launches/call  [{card}]")
    for (name, dtype, L, case), (err, ms, plain, b_ms, b_by,
                                 per_call) in rows.items():
        tol = TOL[(name, dtype)]
        fmt = (lambda v: f"{v:9.4f}" if v is not None else f"{'-':>9s}")
        print(f"{name:21s} {str(dtype)[6:]:9s} {L:4d} {case:13s} "
              f"{err:12.3e} {tol:8.1e} {fmt(ms)} {fmt(plain)} {fmt(b_ms)}  "
              f"{b_by or '-':10s} {per_call if per_call is not None else '-'}")
        check(err <= tol, f"{name} {dtype} L={L} {case}: max_abs_err {err} "
                          f"> {tol}")


def packed_ids(gen, B: int, L: int, S: int) -> torch.Tensor:
    """(B, L) int32 segment ids as a packer lays them out, with the corners
    the kernels must get right: segments 1..S-1 of random lengths, a pad gap
    after segment 2, a run of ids above S (pad by contract), a pad tail, and
    segment S empty in every row."""
    seg = torch.zeros((B, L), dtype=torch.int32)
    lo, hi = max(1, L // (2 * S)), max(2, L // S)
    for b in range(B):
        pos = 0
        for sid in range(1, S):
            n = int(torch.randint(lo, hi, (1,), generator=gen))
            seg[b, pos:pos + n] = sid
            pos += n + (3 if sid == 2 else 0)
        seg[b, pos:pos + 5] = S + 1 + b % 3
    return seg


def tiled_ids(gen, B: int, L: int, S: int) -> torch.Tensor:
    """`packed_ids`, with row 0 laid over #4's tile edges: a boundary on
    the 64-row conv tile edge (64), one inside a 32-row finish tile (80),
    a segment that starts inside the next conv tile's 20-row halo (141,
    after a pad gap), and an id above S; each clipped to L."""
    seg = packed_ids(gen, B, L, S)
    row = torch.zeros(L, dtype=torch.int32)
    for sid, (a, b) in enumerate(((0, 64), (64, 80), (80, 138), (141, 190),
                                  (190, 200), (200, 256)), start=1):
        row[min(a, L):min(b, L)] = sid if sid != 5 else S + 2
    seg[0] = row
    return seg


def isolated(run, x: torch.Tensor, seg: torch.Tensor, sid: int, gen,
             outs) -> bool:
    """Cross-segment isolation, bit for bit: new inputs inside segment
    `sid` change nothing outside it. `run(x)` returns (local (B, L, C),
    attn (B, S, G) or None); `outs` is run(x) on the original input."""
    x2 = x.clone()
    sel = seg == sid
    x2[sel] = torch.randn((int(sel.sum()), x.shape[-1]),
                          generator=gen).to(x.device, x.dtype)
    local2, attn2 = run(x2)
    local, attn = outs
    keep = ~sel
    same = torch.equal(local2[keep], local[keep])
    moved = not torch.equal(local2[sel], local[sel])
    if attn is not None:
        others = [s for s in range(attn.shape[1]) if s != sid - 1]
        same = same and torch.equal(attn2[:, others], attn[:, others])
    return same and moved


def packed_kernel_phase(card: str, rows: dict) -> None:
    """#3 at base width (C=512, S=8) and #6 at C=128 (G=512, H=4, v=128)
    and C=256 (G=512, H=8), dense and packed, against their plain versions
    on the card; B=8, L in {128, 512} timed, L=100 ragged; cross-segment
    isolation bit for bit. #6 at C=512 in bf16 (G=512, H=4, L=128 timed;
    the base preset's H=8 at L=8), and the dispatch's choice of it."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS, ONEPASS, TRACK_PARAMS,
        fused_local_track_segments, local_track_segment_oh_reference,
        onepass_oh_reference, segment_one_hot,
    )
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.kernels.one_pass import (
        fused_onepass, fused_onepass_dense, fused_onepass_segments,
        onepass_flops,
    )
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    base = get_preset("base").model
    gen = torch.Generator().manual_seed(11)
    dev = torch.device(DEVICE)
    B, S, k, wd = 8, 8, base.key_dim, base.wide_dilation

    def launches(kernel, fn):
        n0 = kernel.launches
        fn()
        return kernel.launches - n0

    # #3: the segment-masked local track at base width.
    block = to_device(block_init(gen, base), dev)
    C = base.local_dim
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        cast = cast_block(block, dtype)
        track = {name: cast[name] for name in TRACK_PARAMS}
        for L in (128, 512, 100):
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            bs = torch.randn((B, S, C), generator=gen).to(dev, dtype)
            seg = packed_ids(gen, B, L, S).to(dev)
            oh = segment_one_hot(seg, S)

            def run(xx):
                return (fused_local_track_segments(track, xx, bs, seg, 1, wd),
                        None)

            got = run(x)
            want = local_track_segment_oh_reference(track, x, bs, oh, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got[0]).all().item(),
                  "local_track_segments non-finite")
            err = (got[0].float() - want.float()).abs().max().item()
            check(isolated(run, x, seg, 3, gen, got),
                  f"local_track_segments {dtype} L={L}: segments not "
                  "isolated bit for bit")
            timing = (None,) * 5
            if L != 100:
                nbytes = ((2 * B * L * C + B * S * C + 19 * C * C) * s
                          + B * L * 4 + 7 * C * 4)
                b_ms, b_by = bound(local_track_flops(B, L, C)
                                   + 2 * B * L * S * C, nbytes, dtype)
                per_call = launches(LOCAL_TRACK_SEGMENTS, lambda: run(x))
                check(per_call == 1, f"local_track_segments launched "
                                     f"{per_call} times in one call")
                timing = (time_ms(lambda: run(x)),
                          time_ms(lambda: local_track_segment_oh_reference(
                              track, x, bs, oh, 1, wd)),
                          b_ms, b_by, per_call)
            rows[("local_track_segments", dtype, L, "S=8")] = (err,) + timing

    # #6: the one-pass trunk at the widths the reference runs it at.
    for width, G, H in ((128, 512, 4), (256, 512, 8)):
        cfg = dataclasses.replace(base, local_dim=width, global_dim=G,
                                  num_heads=H)
        blk = to_device(block_init(gen, cfg), dev)
        v = G // H
        for dtype in (torch.bfloat16, torch.float32):
            s = dtype.itemsize
            cast = cast_block(blk, dtype)
            track = {name: cast[name] for name in TRACK_PARAMS}
            attn = cast["attention"]
            for L in (128, 512, 100):
                x = torch.randn((B, L, width), generator=gen).to(dev, dtype)
                # Dense rows: a half-padded row and an all-pad row.
                bc = torch.randn((B, 1, width), generator=gen).to(dev, dtype)
                g = torch.randn((B, 1, G), generator=gen).to(dev, dtype)
                pad = torch.ones((B, L), dtype=torch.bool, device=dev)
                pad[1, L // 2:] = False
                pad[2, :] = False
                ones = torch.ones((B, L, 1), device=dev)
                # Packed rows: S=8, segment 8 empty, 10% in-span <pad>.
                bs = torch.randn((B, S, width), generator=gen).to(dev, dtype)
                gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
                seg = packed_ids(gen, B, L, S).to(dev)
                real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
                oh = segment_one_hot(seg, S)
                cases = {
                    "dense": (lambda xx: fused_onepass(
                                  track, attn, xx, bc, g, None, pad, 1, wd,
                                  False),
                              lambda: onepass_oh_reference(
                                  track, attn, x, bc, g, ones,
                                  pad[..., None].float(), 1, wd, False,
                                  False), 1),
                    "S=8": (lambda xx: fused_onepass(
                                track, attn, xx, bs, gs, seg, real, 1, wd,
                                True),
                            lambda: onepass_oh_reference(
                                track, attn, x, bs, gs, oh,
                                real[..., None].float(), 1, wd, True, True),
                            S),
                }
                for case, (run, plain, n_seg) in cases.items():
                    got = run(x)
                    want = plain()
                    torch.cuda.synchronize()
                    check(all(torch.isfinite(t).all().item() for t in got),
                          f"one_pass {case} non-finite")
                    err = max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(got, want))
                    if case == "S=8":
                        empty = got[1][:, S - 1]
                        check(bool((empty == 0).all())
                              and not torch.signbit(empty).any(),
                              "one_pass: empty segment not exactly +0.0")
                        check(isolated(run, x, seg, 3, gen, got),
                              f"one_pass C={width} {dtype} L={L}: segments "
                              "not isolated bit for bit")
                    timing = (None,) * 5
                    if L != 100 and width == 128:
                        nbytes = ((2 * B * L * width + B * n_seg * width
                                   + 2 * B * n_seg * G + 19 * width * width
                                   + H * (G * k + width * (k + v))) * s
                                  + (2 if n_seg > 1 else 1) * B * L * 4
                                  + 7 * width * 4)
                        b_ms, b_by = bound(
                            onepass_flops(B, L, width, G, n_seg, H, k),
                            nbytes, dtype)
                        per_call = launches(ONEPASS, lambda: run(x))
                        check(per_call == 1, f"one_pass launched {per_call} "
                                             "times in one call")
                        timing = (time_ms(lambda: run(x)), time_ms(plain),
                                  b_ms, b_by, per_call)
                    rows[("one_pass", dtype, L,
                          f"C={width} {case}")] = (err,) + timing

    # #6 at C=512 (bf16 only: the rule never admits float32 there), where
    # the one-pass rule admits G=512, H=4 up to L=128; then the dispatch
    # entries must pick it there, and for the base preset's H=8 at L=8.
    dtype, width = torch.bfloat16, 512
    for G, H, L in ((512, 4, 128), (512, 8, 8)):
        cfg = dataclasses.replace(base, local_dim=width, global_dim=G,
                                  num_heads=H)
        cast = cast_block(to_device(block_init(gen, cfg), dev), dtype)
        track = {name: cast[name] for name in TRACK_PARAMS}
        attn = cast["attention"]
        x = torch.randn((B, L, width), generator=gen).to(dev, dtype)
        bs = torch.randn((B, S, width), generator=gen).to(dev, dtype)
        gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
        seg = packed_ids(gen, B, max(L, 64), S)[:, :L].to(dev)
        real = torch.ones((B, L), dtype=torch.bool, device=dev)
        pad = real.clone()
        pad[1, L // 2:] = False
        oh = segment_one_hot(seg, S)

        def packed(xx):
            return fused_onepass(track, attn, xx, bs, gs, seg, real, 1, wd,
                                 True)

        got = packed(x)
        want = onepass_oh_reference(track, attn, x, bs, gs, oh,
                                    real[..., None].float(), 1, wd, True,
                                    True)
        got_d = fused_onepass(track, attn, x, bs[:, :1], gs[:, :1], None, pad,
                              1, wd, False)
        want_d = onepass_oh_reference(
            track, attn, x, bs[:, :1], gs[:, :1],
            torch.ones((B, L, 1), device=dev), pad[..., None].float(), 1, wd,
            False, False)
        torch.cuda.synchronize()
        for case, a, b in (("S=8", got, want), ("dense", got_d, want_d)):
            check(all(torch.isfinite(t).all().item() for t in a),
                  f"one_pass C=512 {case} non-finite")
            err = max((u.float() - v.float()).abs().max().item()
                      for u, v in zip(a, b))
            timing = (None,) * 5
            if case == "S=8" and H == 4:
                check(isolated(packed, x, seg, 3, gen, got),
                      "one_pass C=512: segments not isolated bit for bit")
                nbytes = ((2 * B * L * width + B * S * width
                           + 2 * B * S * G + 19 * width * width
                           + H * (G * k + width * (k + G // H))) * 2
                          + 2 * B * L * 4 + 7 * width * 4)
                b_ms, b_by = bound(onepass_flops(B, L, width, G, S, H, k),
                                   nbytes, dtype)
                per_call = launches(ONEPASS, lambda: packed(x))
                timing = (time_ms(lambda: packed(x)),
                          time_ms(lambda: onepass_oh_reference(
                              track, attn, x, bs, gs, oh,
                              real[..., None].float(), 1, wd, True, True)),
                          b_ms, b_by, per_call)
            rows[("one_pass", dtype, L, f"C=512 H={H} {case}")] = (
                (err,) + timing)
        counts = [k.launches for k in (ONEPASS, LOCAL_TRACK_SEGMENTS,
                                       LOCAL_TRACK, ATTENTION)]
        fused_onepass_segments(track, attn, x, bs, gs, seg)
        fused_onepass_dense(track, attn, x, bs[:, 0], gs[:, 0], pad)
        moved = [k.launches - n for k, n in zip(
            (ONEPASS, LOCAL_TRACK_SEGMENTS, LOCAL_TRACK, ATTENTION), counts)]
        check(moved == [2, 0, 0, 0],
              f"C=512 G={G} H={H} L={L}: the dispatch launched "
              f"(#6, #3, K1, K2) {moved} times, want (2, 0, 0, 0)")


def large_kernel_phase(card: str, rows: dict) -> None:
    """#2 at ProteinBERT-Large width (C=1024) against K1's plain version,
    bf16 and fp32, B=8, L in {128, 1024} timed and L=100 with a constant
    row (a row of <pad> embeddings); #4 at the same width and L on packed
    rows (S=8) against #3's plain version, with isolation bit for bit; K2
    at Large width (C=G=1024, H=16, L=1024) dense and packed (S=8), and at
    value_dim 128 (C=256, G=512, H=4)."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED,
        TRACK_PARAMS, attention_oh_reference, fused_global_attention,
        fused_local_track, fused_local_track_segments,
        fused_packed_attention, local_track_reference,
        local_track_segment_oh_reference, segment_one_hot,
    )
    from proteinbert_tpu_torch.kernels.attention import attention_flops
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    large = get_preset("large").model
    gen = torch.Generator().manual_seed(21)
    dev = torch.device(DEVICE)
    block = to_device(block_init(gen, large), dev)
    C, G, H, k = large.local_dim, large.global_dim, large.num_heads, \
        large.key_dim
    wd = large.wide_dilation
    small = dataclasses.replace(large, local_dim=256, global_dim=512,
                                num_heads=4)
    v128 = to_device(block_init(gen, small), dev)

    def launches(kernel, fn):
        n0 = kernel.launches
        fn()
        return kernel.launches - n0

    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        cast = cast_block(block, dtype)
        track = {name: cast[name] for name in TRACK_PARAMS}
        attn = cast["attention"]
        for L in (128, 1024, 100):
            B = 8
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            if L == 100:
                x[1] = x[1, :1]           # every position the same vector
            bc = torch.randn((B, C), generator=gen).to(dev, dtype)
            got = fused_local_track(track, x, bc, 1, wd)
            want = local_track_reference(track, x, bc, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(),
                  "local_track_tiled non-finite")
            err = (got.float() - want.float()).abs().max().item()
            timing = (None,) * 5
            if L != 100:
                nbytes = (2 * B * L * C + B * C + 19 * C * C) * s + 7 * C * 4
                b_ms, b_by = bound(local_track_flops(B, L, C), nbytes, dtype)
                per_call = launches(LOCAL_TRACK_TILED, lambda: fused_local_track(
                    track, x, bc, 1, wd))
                check(per_call == 1, f"local_track_tiled launched {per_call} "
                                     "times in one call")
                timing = (time_ms(lambda: fused_local_track(track, x, bc, 1,
                                                            wd)),
                          time_ms(lambda: local_track_reference(track, x, bc,
                                                                1, wd)),
                          b_ms, b_by, per_call)
            rows[("local_track_tiled", dtype, L, "dense")] = (err,) + timing

        # #4: packed rows at Large width, S=8, row 0 over the tile edges.
        S = 8
        for L in (128, 1024, 100):
            B = 8
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            bs = torch.randn((B, S, C), generator=gen).to(dev, dtype)
            seg = tiled_ids(gen, B, L, S).to(dev)
            oh = segment_one_hot(seg, S)

            def run(xx):
                return (fused_local_track_segments(track, xx, bs, seg, 1, wd),
                        None)

            got = run(x)
            want = local_track_segment_oh_reference(track, x, bs, oh, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got[0]).all().item(),
                  "local_track_segments_tiled non-finite")
            err = (got[0].float() - want.float()).abs().max().item()
            for sid in (2, 3):   # row 0: boundaries at 64, 80 and 138
                check(isolated(run, x, seg, sid, gen, got),
                      f"local_track_segments_tiled {dtype} L={L}: segment "
                      f"{sid} not isolated bit for bit")
            timing = (None,) * 5
            if L != 100:
                nbytes = ((2 * B * L * C + B * S * C + 19 * C * C) * s
                          + B * L * 4 + 7 * C * 4)
                b_ms, b_by = bound(local_track_flops(B, L, C), nbytes, dtype)
                per_call = launches(LOCAL_TRACK_SEGMENTS_TILED,
                                    lambda: run(x))
                check(per_call == 1, f"local_track_segments_tiled launched "
                                     f"{per_call} times in one call")
                timing = (time_ms(lambda: run(x)),
                          time_ms(lambda: local_track_segment_oh_reference(
                              track, x, bs, oh, 1, wd)),
                          b_ms, b_by, per_call)
            rows[("local_track_segments_tiled", dtype, L, "S=8")] = (
                (err,) + timing)

        # K2's packed entry at Large width: S=8, 10% in-span <pad>.
        B, L = 8, 1024
        x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
        gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
        seg = packed_ids(gen, B, L, S).to(dev)
        real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
        oh = segment_one_hot(seg, S) * real[..., None]
        got = fused_packed_attention(attn, x, gs, seg, real)
        want = attention_oh_reference(attn, x, gs, oh)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item()
              and bool((got[:, S - 1] == 0).all()),
              "Large packed attention non-finite or empty segment not zero")
        nbytes = ((B * L * C + 2 * B * S * G + H * (G * k + 2 * C * k)) * s
                  + 2 * B * L * 4)
        b_ms, b_by = bound(attention_flops(B, L, C, G, S, H, k), nbytes, dtype)
        per_call = launches(ATTENTION, lambda: fused_packed_attention(
            attn, x, gs, seg, real))
        rows[("global_attention", dtype, L, "Large S=8")] = (
            (got.float() - want.float()).abs().max().item(),
            time_ms(lambda: fused_packed_attention(attn, x, gs, seg, real)),
            time_ms(lambda: attention_oh_reference(attn, x, gs, oh)),
            b_ms, b_by, per_call)

        # K2 at Large width, dense rows, a half-padded and an all-pad row.
        B, L = 8, 1024
        x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
        g = torch.randn((B, G), generator=gen).to(dev, dtype)
        pad = torch.ones((B, L), dtype=torch.bool, device=dev)
        pad[1, L // 2:] = False
        pad[2, :] = False
        oh = pad[..., None].float()
        got = fused_global_attention(attn, x, g, pad)
        want = attention_oh_reference(attn, x, g[:, None, :], oh,
                                      zero_empty=False).reshape(B, G)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item(), "Large attention non-finite")
        err = (got.float() - want.float()).abs().max().item()
        nbytes = ((B * L * C + B * G * 2 + H * (G * k + 2 * C * k)) * s
                  + B * L * 4)
        b_ms, b_by = bound(attention_flops(B, L, C, G, 1, H, k), nbytes, dtype)
        per_call = launches(ATTENTION, lambda: fused_global_attention(
            attn, x, g, pad))
        rows[("global_attention", dtype, L, "Large")] = (
            err, time_ms(lambda: fused_global_attention(attn, x, g, pad)),
            time_ms(lambda: attention_oh_reference(attn, x, g[:, None, :], oh,
                                                   zero_empty=False)),
            b_ms, b_by, per_call)

        # K2 at value_dim 128 (G=512, H=4), a shape the one-pass rule sends
        # to the composition in fp32 at L=512.
        a128 = cast_block(v128, dtype)["attention"]
        x = torch.randn((B, 512, 256), generator=gen).to(dev, dtype)
        g = torch.randn((B, 512), generator=gen).to(dev, dtype)
        pad = torch.ones((B, 512), dtype=torch.bool, device=dev)
        pad[1, 200:] = False
        got = fused_global_attention(a128, x, g, pad)
        want = attention_oh_reference(a128, x, g[:, None, :],
                                      pad[..., None].float(),
                                      zero_empty=False).reshape(B, 512)
        torch.cuda.synchronize()
        rows[("global_attention", dtype, 512, "v=128")] = (
            (got.float() - want.float()).abs().max().item(),
            None, None, None, None, None)


def valid_kernel_phase(card: str, rows: dict) -> None:
    """The prehaloed entries (`fused_local_track_valid`): K1's at the
    `long` preset's width (C=512) and #2's at Large width (C=1024), bf16
    and fp32. One L=2048 row set is cut into shards of 512 (C=512) or 256
    (C=1024) rows, each with its neighbours' 20 rows (zeros at the ends):
    every shard's centre must equal the same rows of `fused_local_track`
    on the whole row bit for bit, since each output row's arithmetic reads
    only its window's rows. A middle shard (real halo rows on both sides)
    is held against the plain version and, in bf16, timed at the `long`
    preset's shard shape (B=16, L=512+2*20, C=512) and at C=1024, L=256
    (B=8). The shapes the train phases give the entries on a one-rank
    group — one whole row with `halo_exchange`'s 20 zero rows each side,
    B=4, L=2048+2*20, C=512 (`train long seq`) and B=8, L=1024+2*20,
    C=1024 (`train large seq`) — are held against the plain version too."""
    import torch.nn.functional as F

    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        LOCAL_TRACK_TILED_VALID, LOCAL_TRACK_VALID, TRACK_PARAMS,
        fused_local_track, fused_local_track_valid,
        local_track_valid_reference, track_halo,
    )
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    gen = torch.Generator().manual_seed(61)
    dev = torch.device(DEVICE)
    for preset, kernel, B, Ls, Bm, Lm in (
            ("long", LOCAL_TRACK_VALID, 16, 512, 4, 2048),
            ("large", LOCAL_TRACK_TILED_VALID, 8, 256, 8, 1024)):
        cfg = get_preset(preset).model
        C, wd = cfg.local_dim, cfg.wide_dilation
        block = to_device(block_init(gen, cfg), dev)
        for dtype in (torch.bfloat16, torch.float32):
            s = dtype.itemsize
            cast = cast_block(block, dtype)
            track = {name: cast[name] for name in TRACK_PARAMS}
            H = track_halo(track, 1, wd)
            x = torch.randn((B, 2048, C), generator=gen).to(dev, dtype)
            bc = torch.randn((B, C), generator=gen).to(dev, dtype)
            xp = F.pad(x, (0, 0, H, H))
            whole = fused_local_track(track, x, bc, 1, wd)
            shards = [fused_local_track_valid(
                track, xp[:, i * Ls:(i + 1) * Ls + 2 * H], bc, 1, wd)
                for i in range(2048 // Ls)]
            torch.cuda.synchronize()
            stitched = torch.cat(shards, dim=1)
            print(f"# {kernel.name} {str(dtype)[6:]}: {len(shards)} shards "
                  f"of {Ls} rows (+2*{H}) vs the whole L=2048 row: max "
                  f"|diff| {(stitched.float() - whole.float()).abs().max().item()}"
                  f" [{card}]")
            check(torch.equal(stitched, whole),
                  f"{kernel.name} {dtype}: shard centres are not the whole "
                  "row's track bit for bit")
            xh = xp[:, Ls:2 * Ls + 2 * H].contiguous()  # real halos
            got = fused_local_track_valid(track, xh, bc, 1, wd)
            want = local_track_valid_reference(track, xh, bc, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(),
                  f"{kernel.name} non-finite")
            err = (got.float() - want.float()).abs().max().item()
            timing = (None,) * 5
            if dtype == torch.bfloat16:
                nbytes = ((B * (Ls + 2 * H) * C + B * Ls * C + B * C
                           + 19 * C * C) * s + 7 * C * 4)
                b_ms, b_by = bound(local_track_flops(B, Ls, C), nbytes, dtype)
                n0 = kernel.launches
                fused_local_track_valid(track, xh, bc, 1, wd)
                per_call = kernel.launches - n0
                check(per_call == 1, f"{kernel.name} launched {per_call} "
                                     "times in one call")
                timing = (time_ms(lambda: fused_local_track_valid(
                              track, xh, bc, 1, wd)),
                          time_ms(lambda: local_track_valid_reference(
                              track, xh, bc, 1, wd)),
                          b_ms, b_by, per_call)
            rows[(kernel.name, dtype, Ls, "shard")] = (err,) + timing
            xm = F.pad(torch.randn((Bm, Lm, C), generator=gen).to(dev, dtype),
                       (0, 0, H, H))   # the main path's shape, world 1
            bm = torch.randn((Bm, C), generator=gen).to(dev, dtype)
            got = fused_local_track_valid(track, xm, bm, 1, wd)
            want = local_track_valid_reference(track, xm, bm, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(),
                  f"{kernel.name} non-finite at the main path's shape")
            rows[(kernel.name, dtype, Lm, "main path")] = (
                (got.float() - want.float()).abs().max().item(),
                None, None, None, None, None)


# ------------------------------------------------------------ int8 legs

def q8_block(gen, cfg, dtype):
    """One block's track and attention weights as the int8 arm's forward
    holds them (`quantize_params`, then `cast_block`: quant leaves as they
    are, biases in the activation dtype, LN float32), and the same weights
    dequantized — the fp leg's operands. Returns (qtrack, qattn, track,
    attn, int8 weight bytes with their scales)."""
    from proteinbert_tpu_torch.kernels import TRACK_PARAMS, dequant_params
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )
    from proteinbert_tpu_torch.parallel.quant import (
        param_bytes, quantize_params,
    )

    q = cast_block(quantize_params(to_device(block_init(gen, cfg),
                                             torch.device(DEVICE))), dtype)
    qtrack = {name: q[name] for name in TRACK_PARAMS}
    qattn = q["attention"]
    wbytes = (param_bytes([qtrack[n]["kernel"] for n in
                           ("narrow_conv", "wide_conv", "local_dense")]),
              param_bytes(qattn))
    return qtrack, qattn, dequant_params(qtrack), dequant_params(qattn), wbytes


def q8_kernel_phase(card: str, rows: dict) -> dict:
    """The int8 legs of #3, K2 and #6 at the served shapes, bf16 and fp32:
    #3-int8 at base width (B=8, C=512, S=8); K2-int8 at base width (C=G=512,
    H=8) dense and packed (S=8) and at value_dim 128 (C=128, G=512, H=4);
    #6-int8 at C=128 (G=512, H=4) and C=256 (G=512, H=8) dense and packed,
    and at C=512 in bf16 (H=4, L=128). L=512 timed (#6 at C=512: L=128),
    and L=100 with an all-pad row and an empty segment. Each leg must give
    exactly (max |diff| == 0.0) the fp leg's output on the dequantized
    weights, lie within the fp leg's tolerance of the plain version, and
    return an empty segment as +0.0. Returns {row key: (exact diff, fp leg
    ms)}; the rows join `rows`."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_Q8, ONEPASS, ONEPASS_Q8, attention_oh_reference,
        fused_global_attention, fused_local_track_segments,
        fused_packed_attention, local_track_segment_oh_reference,
        onepass_oh_reference, segment_one_hot,
    )
    from proteinbert_tpu_torch.kernels.attention import attention_flops
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.kernels.one_pass import (
        fused_onepass, fused_onepass_segments, onepass_flops,
    )

    base = get_preset("base").model
    gen = torch.Generator().manual_seed(31)
    dev = torch.device(DEVICE)
    B, S, k, wd = 8, 8, base.key_dim, base.wide_dilation
    fp_leg = {LOCAL_TRACK_SEGMENTS_Q8: LOCAL_TRACK_SEGMENTS,
              ATTENTION_Q8: ATTENTION, ONEPASS_Q8: ONEPASS}
    extra = {}

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    def case(kernel, dtype, L, label, q_run, f_run, plain, timed, flops,
             nbytes, empty=None):
        """One int8-leg case: `q_run` the int8 leg, `f_run` the fp leg on
        the dequantized weights, `plain` its plain version; `empty` picks
        the output of an empty segment from q_run's outputs."""
        got, fp, want = as_tuple(q_run()), as_tuple(f_run()), as_tuple(plain())
        torch.cuda.synchronize()
        tag = f"{kernel.name} {str(dtype)[6:]} L={L} {label}"
        check(all(torch.isfinite(t).all().item() for t in got),
              f"{tag}: non-finite")
        exact = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(got, fp))
        check(exact == 0.0, f"{tag}: int8 leg vs fp leg on the dequantized "
                            f"weights max |diff| {exact}, want 0.0")
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        if empty is not None:
            e = empty(got)
            check(bool((e == 0).all()) and not torch.signbit(e).any(),
                  f"{tag}: empty segment not exactly +0.0")
        timing, fp_ms = (None,) * 5, None
        if timed:
            n0, f0 = kernel.launches, fp_leg[kernel].launches
            q_run()
            per_call = kernel.launches - n0
            check(per_call == 1 and fp_leg[kernel].launches == f0,
                  f"{tag}: {per_call} int8 launches and "
                  f"{fp_leg[kernel].launches - f0} fp launches in one call")
            b_ms, b_by = bound(flops, nbytes, dtype)
            timing = (time_ms(q_run), time_ms(plain), b_ms, b_by, per_call)
            fp_ms = time_ms(f_run)
        rows[(kernel.name, dtype, L, label)] = (err,) + timing
        extra[(kernel.name, dtype, L, label)] = (exact, fp_ms)

    def pad_rows(L):
        pad = torch.ones((B, L), dtype=torch.bool, device=dev)
        pad[1, L // 2:] = False   # half-padded row
        pad[2, :] = False         # all-pad row
        return pad

    def ids(L):
        seg = packed_ids(gen, B, max(L, 64), S)[:, :L]
        if L == 100:
            seg[2] = 0            # an all-pad row
        return seg.to(dev)

    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        # #3-int8 and K2-int8 at base width.
        qt, qa, ft, fa, (tbytes, abytes) = q8_block(gen, base, dtype)
        C, G, H = base.local_dim, base.global_dim, base.num_heads
        for L in (512, 100):
            timed = L == 512
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            bs = torch.randn((B, S, C), generator=gen).to(dev, dtype)
            seg = ids(L)
            oh = segment_one_hot(seg, S)
            case(LOCAL_TRACK_SEGMENTS_Q8, dtype, L, "S=8",
                 lambda: fused_local_track_segments(qt, x, bs, seg, 1, wd),
                 lambda: fused_local_track_segments(ft, x, bs, seg, 1, wd),
                 lambda: local_track_segment_oh_reference(ft, x, bs, oh, 1,
                                                          wd),
                 timed, local_track_flops(B, L, C) + 2 * B * L * S * C,
                 (2 * B * L * C + B * S * C) * s + tbytes + B * L * 4
                 + 7 * C * 4)
            g = torch.randn((B, G), generator=gen).to(dev, dtype)
            pad = pad_rows(L)
            poh = pad[..., None].float()
            case(ATTENTION_Q8, dtype, L, "dense",
                 lambda: fused_global_attention(qa, x, g, pad),
                 lambda: fused_global_attention(fa, x, g, pad),
                 lambda: attention_oh_reference(
                     fa, x, g[:, None, :], poh,
                     zero_empty=False).reshape(B, G),
                 timed, attention_flops(B, L, C, G, 1, H, k),
                 (B * L * C + 2 * B * G) * s + abytes + B * L * 4)
            gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
            case(ATTENTION_Q8, dtype, L, "S=8",
                 lambda: fused_packed_attention(qa, x, gs, seg),
                 lambda: fused_packed_attention(fa, x, gs, seg),
                 lambda: attention_oh_reference(fa, x, gs, oh),
                 timed, attention_flops(B, L, C, G, S, H, k),
                 (B * L * C + 2 * B * S * G) * s + abytes + B * L * S * 4,
                 empty=lambda out: out[0][:, S - 1])

        # #6-int8 (and K2-int8 at value_dim 128) at the narrower widths.
        for width, G, H in ((128, 512, 4), (256, 512, 8)):
            cfg = dataclasses.replace(base, local_dim=width, global_dim=G,
                                      num_heads=H)
            qt, qa, ft, fa, (tbytes, abytes) = q8_block(gen, cfg, dtype)
            for L in ((512, 100) if width == 128 else (100,)):
                timed = L == 512
                x = torch.randn((B, L, width), generator=gen).to(dev, dtype)
                bc = torch.randn((B, 1, width), generator=gen).to(dev, dtype)
                g = torch.randn((B, 1, G), generator=gen).to(dev, dtype)
                pad = pad_rows(L)
                ones = torch.ones((B, L, 1), device=dev)
                bs = torch.randn((B, S, width), generator=gen).to(dev, dtype)
                gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
                seg = ids(L)
                real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
                oh = segment_one_hot(seg, S)
                for label, n_seg, run, plain, empty in (
                        ("dense", 1,
                         lambda w, xx=x: fused_onepass(
                             w[0], w[1], xx, bc, g, None, pad, 1, wd, False),
                         lambda: onepass_oh_reference(
                             ft, fa, x, bc, g, ones, pad[..., None].float(),
                             1, wd, False, False), None),
                        ("S=8", S,
                         lambda w, xx=x: fused_onepass(
                             w[0], w[1], xx, bs, gs, seg, real, 1, wd, True),
                         lambda: onepass_oh_reference(
                             ft, fa, x, bs, gs, oh, real[..., None].float(),
                             1, wd, True, True),
                         lambda out: out[1][:, S - 1])):
                    case(ONEPASS_Q8, dtype, L, f"C={width} {label}",
                         lambda run=run: run((qt, qa)),
                         lambda run=run: run((ft, fa)), plain, timed,
                         onepass_flops(B, L, width, G, n_seg, H, k),
                         (2 * B * L * width + B * n_seg * (width + 2 * G)) * s
                         + tbytes + abytes
                         + (2 if n_seg > 1 else 1) * B * L * 4
                         + 7 * width * 4, empty)
                if width == 128 and L == 100:
                    # K2-int8's value_dim 128 instantiation.
                    case(ATTENTION_Q8, dtype, L, "v=128 S=8",
                         lambda: fused_packed_attention(qa, x, gs, seg),
                         lambda: fused_packed_attention(fa, x, gs, seg),
                         lambda: attention_oh_reference(fa, x, gs, oh),
                         False, 0, 0, empty=lambda out: out[0][:, S - 1])

    # #6-int8 at C=512 (bf16 only, as the fp leg), where the one-pass rule
    # admits G=512, H=4 up to L=128; the packed dispatch entry must pick it.
    dtype, width, G, H = torch.bfloat16, 512, 512, 4
    cfg = dataclasses.replace(base, local_dim=width, global_dim=G,
                              num_heads=H)
    qt, qa, ft, fa, (tbytes, abytes) = q8_block(gen, cfg, dtype)
    for L in (128, 100):
        x = torch.randn((B, L, width), generator=gen).to(dev, dtype)
        bs = torch.randn((B, S, width), generator=gen).to(dev, dtype)
        gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
        seg = ids(L)
        real = torch.ones((B, L), dtype=torch.bool, device=dev)
        oh = segment_one_hot(seg, S)
        case(ONEPASS_Q8, dtype, L, "C=512 H=4 S=8",
             lambda: fused_onepass(qt, qa, x, bs, gs, seg, real, 1, wd, True),
             lambda: fused_onepass(ft, fa, x, bs, gs, seg, real, 1, wd, True),
             lambda: onepass_oh_reference(ft, fa, x, bs, gs, oh,
                                          real[..., None].float(), 1, wd,
                                          True, True),
             L == 128, onepass_flops(B, L, width, G, S, H, k),
             (2 * B * L * width + B * S * (width + 2 * G)) * 2 + tbytes
             + abytes + 2 * B * L * 4 + 7 * width * 4,
             empty=lambda out: out[1][:, S - 1])
    legs = (ONEPASS_Q8, LOCAL_TRACK_SEGMENTS_Q8, ATTENTION_Q8, ONEPASS,
            LOCAL_TRACK_SEGMENTS, ATTENTION, LOCAL_TRACK)
    counts = [kk.launches for kk in legs]
    fused_onepass_segments(qt, qa, x, bs, gs, seg)
    moved = [kk.launches - n for kk, n in zip(legs, counts)]
    check(moved == [1, 0, 0, 0, 0, 0, 0],
          f"int8 C=512 H=4 L=100: the packed dispatch launched (#6-int8, "
          f"#3-int8, K2-int8, #6, #3, K2, K1) {moved} times")
    return extra


def print_q8_rows(card: str, rows: dict, extra: dict) -> None:
    """The int8 legs beside their fp legs (the int8 rows of `rows` are
    checked against their tolerance by `print_rows`)."""
    print(f"# int8 legs [{card}]: int8 leg vs fp leg on the dequantized "
          "weights (must be 0.0), int8 ms beside the fp leg's")
    for key, (exact, fp_ms) in extra.items():
        name, dtype, L, label = key
        ms = rows[key][1]
        times = (f"int8 {ms:.4f} ms, fp leg {fp_ms:.4f} ms"
                 if ms is not None else "untimed")
        print(f"#   {name:24s} {str(dtype)[6:]:9s} L={L:<4d} {label:15s} "
              f"exact {exact:.1e}  {times}")


# ------------------------------------------------------------ gradients

def grad_phase(card: str) -> None:
    """Each autograd Function on the card: the grads of sum(out * r)
    (every float input: weights, activations, broadcast and global rows)
    through the kernel wrapper (K1, #2, #3, #4, K2, #6, and K1's and #2's
    prehaloed entry), fp32 and bf16, against float32 autograd of the
    function its backward differentiates (the port of the JAX XLA
    reference) on the same inputs cast up to float32. The wrapper's
    backward IS autograd of that reference at the activation dtype, so the
    fp32 cases check only the plumbing (every input gets a finite grad of
    the right value); the bf16 cases hold the bf16 backward the trainer
    runs (cuDNN's bf16 convs, bf16 GEMMs) against a float32 one, which a
    wrong bf16 backward on the card fails. The kernels' forward plays no
    part in the grads: `kernel_phase` gates it."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        TRACK_PARAMS, attention_oh_grad_reference, fused_attention,
        fused_local_track, fused_local_track_segments,
        fused_local_track_valid, local_track_grad_reference,
        local_track_segment_oh_grad_reference,
        local_track_valid_grad_reference, onepass_oh_grad_reference,
        segment_one_hot,
    )
    from proteinbert_tpu_torch.kernels.one_pass import fused_onepass
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    gen = torch.Generator().manual_seed(31)
    dev = torch.device(DEVICE)
    base, large = get_preset("base").model, get_preset("large").model
    default = ModelConfig()
    blocks = {name: to_device(block_init(gen, cfg), dev)
              for name, cfg in (("base", base), ("large", large),
                                ("default", default))}
    B, L, S = 2, 128, 8

    def grads(fn, inputs):
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        total = sum((o.float() * rr).sum() for o, rr in zip(outs, r_of(outs)))
        return torch.autograd.grad(total, [t for t in leaves(inputs)])

    r_cache = {}

    def r_of(outs):
        key = tuple(tuple(o.shape) for o in outs)
        if key not in r_cache:
            r_cache[key] = [torch.randn(o.shape, generator=gen).to(dev)
                            for o in outs]
        return r_cache[key]

    def leaves(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in leaves(v)]
        if torch.is_tensor(tree) and tree.requires_grad:
            return [tree]
        return []

    def rg(tree, dtype=None):
        """Fresh leaf copies that require grad (cast to dtype if given)."""
        if isinstance(tree, dict):
            return {k: rg(v, dtype) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rg(v, dtype) for v in tree)
        return tree.detach().to(dtype or tree.dtype).requires_grad_(True)

    for dtype in (torch.bfloat16, torch.float32):
        def rand(*shape):
            return torch.randn(shape, generator=gen).to(dev, dtype)

        seg = packed_ids(gen, B, L, S).to(dev)
        oh = segment_one_hot(seg, S)
        real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
        cases = {}
        for name, width in (("K1", "base"), ("#2", "large")):
            cast = cast_block(blocks[width], dtype)
            C = cast["local_ln1"]["scale"].shape[0]
            track = rg({n: cast[n] for n in TRACK_PARAMS})
            x, bc = rg(rand(B, L, C)), rg(rand(B, C))
            cases[name] = (
                lambda t, xx, bb: fused_local_track(t, xx, bb, 1, 5),
                lambda t, xx, bb: local_track_grad_reference(t, xx, bb, 1, 5),
                (track, x, bc))
            cases[name + "v"] = (   # the prehaloed entry, 20 halo rows
                lambda t, xx, bb: fused_local_track_valid(t, xx, bb, 1, 5),
                lambda t, xx, bb: local_track_valid_grad_reference(
                    t, xx, bb, 1, 5),
                (rg({n: cast[n] for n in TRACK_PARAMS}),
                 rg(rand(B, L + 40, C)), rg(rand(B, C))))
        cast = cast_block(blocks["base"], dtype)
        C, G = base.local_dim, base.global_dim
        track = rg({n: cast[n] for n in TRACK_PARAMS})
        cases["#3"] = (
            lambda t, xx, bb: fused_local_track_segments(t, xx, bb, seg, 1, 5),
            lambda t, xx, bb: local_track_segment_oh_grad_reference(
                t, xx, bb, oh, 1, 5),
            (track, rg(rand(B, L, C)), rg(rand(B, S, C))))
        cast = cast_block(blocks["large"], dtype)
        C = large.local_dim
        cases["#4"] = (
            lambda t, xx, bb: fused_local_track_segments(t, xx, bb, seg, 1, 5),
            lambda t, xx, bb: local_track_segment_oh_grad_reference(
                t, xx, bb, oh, 1, 5),
            (rg({n: cast[n] for n in TRACK_PARAMS}), rg(rand(B, L, C)),
             rg(rand(B, S, C))))
        cast = cast_block(blocks["base"], dtype)
        C = base.local_dim
        attn = rg(cast["attention"])
        cases["K2"] = (
            lambda a, xx, gg: fused_attention(a, xx, gg, oh * real[..., None]),
            lambda a, xx, gg: attention_oh_grad_reference(
                a, xx, gg, oh * real[..., None]),
            (attn, rg(rand(B, L, C)), rg(rand(B, S, G))))
        cast = cast_block(blocks["default"], dtype)
        C, G = default.local_dim, default.global_dim
        track = rg({n: cast[n] for n in TRACK_PARAMS})
        attn = rg(cast["attention"])
        cases["#6"] = (
            lambda t, a, xx, bb, gg: fused_onepass(t, a, xx, bb, gg, seg,
                                                   real, 1, 5, True),
            lambda t, a, xx, bb, gg: onepass_oh_grad_reference(
                t, a, xx, bb, gg, oh, real[..., None].float(), 1, 5, True,
                True),
            (track, attn, rg(rand(B, L, C)), rg(rand(B, S, C)),
             rg(rand(B, S, G))))
        for name, (kernel_fn, plain_fn, inputs) in cases.items():
            got = grads(kernel_fn, inputs)
            want = grads(plain_fn, rg(inputs, torch.float32))
            torch.cuda.synchronize()
            check(all(torch.isfinite(a).all().item() for a in got),
                  f"{name} grads non-finite")
            if dtype == torch.float32:
                scale = max(w.abs().max().item() for w in want)
                err = max((a - b).abs().max().item()
                          for a, b in zip(got, want)) / max(scale, 1e-30)
                metric = "max |kernel - fp32 ref| / max|grad|"
            else:
                err = max(((a.float() - b).norm()
                           / b.norm().clamp_min(1e-30)).item()
                          for a, b in zip(got, want))
                metric = "max over inputs ||bf16 - fp32 ref|| / ||fp32 ref||"
            print(f"# grad {name:4s} {str(dtype)[6:]:9s} {len(got):3d} inputs: "
                  f"{metric} {err:.3e} (tol {GRAD_TOL[dtype]:.1e}) [{card}]")
            check(err <= GRAD_TOL[dtype], f"{name} {dtype} grads: {err}")


def reference_step_phase(card: str) -> None:
    """A 2-block fp32 train step at Large width (C=G=1024, H=16, 8943
    annotations), B=2, L=128: the loss and every grad on the card (through
    #2 and K2) against the same params and corrupted batch on the CPU
    plain path; then the optimizer update on the card."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.corruption import corrupt_batch
    from proteinbert_tpu_torch.kernels import ATTENTION, LOCAL_TRACK_TILED
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.schedule import make_optimizer, tree_leaves

    large = get_preset("large")
    cfg = large.replace(
        model=dataclasses.replace(large.model, dtype="float32", num_blocks=2),
        optimizer=dataclasses.replace(large.optimizer, warmup_steps=0,
                                      schedule="constant"))
    params = init(cfg.model, torch.Generator().manual_seed(41), device="cpu")
    rng = np.random.default_rng(41)
    tokens = rng.integers(4, 26, (2, 128)).astype(np.int32)
    tokens[:, 0], tokens[0, 90], tokens[0, 91:] = 1, 2, 0
    ann = (rng.random((2, cfg.model.num_annotations)) < 0.01).astype(
        np.float32)
    X, Y, W = corrupt_batch(torch.Generator().manual_seed(42),
                            torch.from_numpy(tokens), torch.from_numpy(ann))
    want_g, want_m = ts.loss_and_grads(params, X, Y, W, cfg)
    dev = torch.device(DEVICE)
    on = {k: {n: t.to(dev) for n, t in d.items()} for k, d in
          (("X", X), ("Y", Y), ("W", W))}
    card_params = to_device(params, dev)
    n0 = (LOCAL_TRACK_TILED.launches, ATTENTION.launches)
    got_g, got_m = ts.loss_and_grads(card_params, on["X"], on["Y"], on["W"],
                                     cfg)
    torch.cuda.synchronize()
    check((LOCAL_TRACK_TILED.launches - n0[0], ATTENTION.launches - n0[1])
          == (2, 2), "reference step did not run #2 and K2 once a block")
    loss_err = abs(float(got_m["loss"]) - float(want_m["loss"]))
    grad_err = max((a.cpu() - b).abs().max().item()
                   for a, b in zip(got_g, want_g))
    print(f"# reference step: 2-block fp32 Large width, B=2 L=128, card vs "
          f"CPU plain path: loss {float(got_m['loss']):.6f} |diff| "
          f"{loss_err:.3e} (tol {STEP_LOSS_TOL}), grads max |diff| "
          f"{grad_err:.3e} over {len(got_g)} tensors (tol {STEP_GRAD_TOL}) "
          f"[{card}]")
    check(loss_err <= STEP_LOSS_TOL, f"reference step loss {loss_err}")
    check(grad_err <= STEP_GRAD_TOL, f"reference step grads {grad_err}")
    tx = make_optimizer(cfg.optimizer)
    before = [t.clone() for t in tree_leaves(card_params)]
    ts.gradient_update(tx, card_params, got_g, tx.init(card_params))
    after = tree_leaves(card_params)
    check(all(torch.isfinite(t).all().item() for t in after)
          and any(not torch.equal(a, b) for a, b in zip(before, after)),
          "the optimizer update on the card did not move the params")


def packed_reference_phase(card: str) -> None:
    """A 2-block fp32 PACKED train step at Large width (C=G=1024, H=16,
    8943 annotations), B=2, L=128, S=4: the loss and every grad on the
    card (through #4 and K2) against the same params and corrupted batch
    on the CPU plain path. Then each packed protein's loss terms
    (`packed_segment_losses` on the clean batch) against the same protein
    run alone on the card as a dense row of its own length (through #2
    and K2), as the JAX test_packed_vs_solo_per_sequence_parity does."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.corruption import (
        corrupt_packed_batch, packed_weights, pretrain_weights,
    )
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED,
    )
    from proteinbert_tpu_torch.models import proteinbert
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.loss import (
        packed_segment_losses, pretrain_loss,
    )

    large = get_preset("large")
    cfg = large.replace(
        model=dataclasses.replace(large.model, dtype="float32", num_blocks=2))
    params = init(cfg.model, torch.Generator().manual_seed(43), device="cpu")
    rng = np.random.default_rng(43)
    B, L, S, A = 2, 128, 4, cfg.model.num_annotations
    tokens = np.zeros((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    # Row 0: three proteins and a pad tail; row 1: four, filling the row.
    for r, spans in enumerate(((40, 50, 30), (60, 20, 38, 10))):
        pos = 0
        for sid, n in enumerate(spans, start=1):
            tokens[r, pos + 1:pos + n - 1] = rng.integers(4, 26, n - 2)
            tokens[r, pos], tokens[r, pos + n - 1] = 1, 2
            seg[r, pos:pos + n] = sid
            pos += n
    ann = (rng.random((B, S, A)) < 0.01).astype(np.float32)
    tok, sg, an = (torch.from_numpy(a) for a in (tokens, seg, ann))
    X, Y, W = corrupt_packed_batch(torch.Generator().manual_seed(44), tok,
                                   sg, an)
    want_g, want_m = ts.loss_and_grads(params, X, Y, W, cfg, sg)
    dev = torch.device(DEVICE)
    on = {k: {n: t.to(dev) for n, t in d.items()} for k, d in
          (("X", X), ("Y", Y), ("W", W))}
    card_params = to_device(params, dev)
    n0 = (LOCAL_TRACK_SEGMENTS_TILED.launches, ATTENTION.launches)
    got_g, got_m = ts.loss_and_grads(card_params, on["X"], on["Y"], on["W"],
                                     cfg, sg.to(dev))
    torch.cuda.synchronize()
    check((LOCAL_TRACK_SEGMENTS_TILED.launches - n0[0],
           ATTENTION.launches - n0[1]) == (2, 2),
          "packed reference step did not run #4 and K2 once a block")
    loss_err = abs(float(got_m["loss"]) - float(want_m["loss"]))
    grad_err = max((a.cpu() - b).abs().max().item()
                   for a, b in zip(got_g, want_g))
    print(f"# reference step packed: 2-block fp32 Large width, B=2 L=128 "
          f"S=4, card vs CPU plain path: loss {float(got_m['loss']):.6f} "
          f"|diff| {loss_err:.3e} (tol {STEP_LOSS_TOL}), grads max |diff| "
          f"{grad_err:.3e} over {len(got_g)} tensors (tol {STEP_GRAD_TOL}) "
          f"[{card}]")
    check(loss_err <= STEP_LOSS_TOL, f"packed reference step loss {loss_err}")
    check(grad_err <= STEP_GRAD_TOL, f"packed reference step grads "
                                     f"{grad_err}")

    # Packed vs solo, clean tokens, on the card.
    sg = sg.to(dev)
    Yc = {"local": tok.to(dev), "global": an.to(dev)}
    with torch.no_grad():
        ll, gl = proteinbert.apply(card_params, Yc["local"], Yc["global"],
                                   cfg.model, segment_ids=sg)
        per_seg = packed_segment_losses(
            ll, gl, Yc, packed_weights(Yc["local"], sg, Yc["global"]), sg)
        worst, n, n0 = 0.0, 0, LOCAL_TRACK_TILED.launches
        for r in range(B):
            for s in range(1, S + 1):
                mask = sg[r] == s
                if not mask.any():
                    continue
                toks = Yc["local"][r][mask][None]
                a = Yc["global"][r, s - 1][None]
                ll1, gl1 = proteinbert.apply(card_params, toks, a, cfg.model)
                _, m1 = pretrain_loss(ll1, gl1, {"local": toks, "global": a},
                                      pretrain_weights(toks, a))
                for k, k1 in (("local", "local_loss"),
                              ("global", "global_loss")):
                    worst = max(worst, abs(float(per_seg[k][r, s - 1])
                                           - float(m1[k1])))
                n += 1
    check(LOCAL_TRACK_TILED.launches - n0 == 2 * n,
          "the solo rows did not run #2 once a block")
    print(f"# packed vs solo: {n} proteins, per-segment loss terms packed "
          f"(#4) vs each alone as a dense row (#2): max |diff| {worst:.3e} "
          f"(tol {SOLO_LOSS_TOL}) [{card}]")
    check(worst <= SOLO_LOSS_TOL, f"packed vs solo loss terms: {worst}")


# ------------------------------------------------------------ train

def synthetic_proteins(n: int, lo: int, hi: int, num_annotations: int,
                       seed: int):
    """n random proteins of lo..hi residues with ~0.5% positive
    annotations (the density of `make_random_proteins`)."""
    from proteinbert_tpu_torch.data.vocab import ALPHABET

    rng = np.random.default_rng(seed)
    letters = np.array(list(ALPHABET))
    seqs = ["".join(letters[rng.integers(0, len(letters),
                                         int(rng.integers(lo, hi + 1)))])
            for _ in range(n)]
    ann = (rng.random((n, num_annotations)) < 0.005).astype(np.float32)
    return seqs, ann


def train_run(card: str, label: str, cfg, steps: int, per_step: dict,
              residues: tuple, seed: int, seq_group=None):
    """`pretrain()` for `steps` steps with every kernel count at 0: the
    launches of each step (exactly per_step[name], 0 for a kernel not
    named), finite losses, params moved by step 2. `cfg.data.packing`
    feeds it `make_packed_iterator` (cfg.data.pack_max_segments a row),
    else `make_pretrain_iterator`; `seq_group` trains sequence-parallel
    over that group. Returns (the out dict, per-step wall ms, launches,
    peak bytes, a clean batch, the batches it trained on)."""
    from proteinbert_tpu_torch.data.dataset import (
        InMemoryPretrainingDataset, make_pretrain_iterator,
    )
    from proteinbert_tpu_torch.data.packing import make_packed_iterator
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.train_state import create_train_state
    from proteinbert_tpu_torch.train.trainer import pretrain

    B, L = cfg.data.batch_size, cfg.data.seq_len
    packed = cfg.data.packing
    seqs, ann = synthetic_proteins((40 if packed else 4) * B, *residues,
                                   cfg.model.num_annotations, seed)
    ds = InMemoryPretrainingDataset(seqs, ann, L)

    def batches():
        if packed:
            return make_packed_iterator(
                ds, B, seed=seed, max_segments=cfg.data.pack_max_segments)
        return make_pretrain_iterator(ds, B, seed=seed)

    batch = next(batches())
    trained = []

    def recorded(it):
        for b in it:
            trained.append(b)
            yield b

    state = create_train_state(torch.Generator().manual_seed(seed), cfg,
                               device=DEVICE)
    start = [t.clone() for t in tree_leaves(state.params)]
    marks = []

    def log_fn(step, m):
        # Called after the step's metrics reached the host (a sync).
        marks.append((step, time.perf_counter(), m["loss"],
                      {k.name: k.launches for k in KERNELS}))
        if step == 2:
            marks[-1] += (any(not torch.equal(a, b) for a, b in
                              zip(start, tree_leaves(state.params))),)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = pretrain(cfg, recorded(batches()), state=state, log_fn=log_fn,
                   device=DEVICE, seq_group=seq_group)
    total = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    check(len(marks) == steps, f"{label}: {len(marks)} log points")
    prev_t, prev_n = t0, {k.name: 0 for k in KERNELS}
    walls = []
    for mark in marks:
        step, t, loss, counts = mark[:4]
        check(np.isfinite(loss), f"{label}: step {step} loss {loss}")
        for name, n in counts.items():
            got = n - prev_n[name]
            check(got == per_step.get(name, 0),
                  f"{label}: step {step} launched {name} {got} times, want "
                  f"{per_step.get(name, 0)}")
        walls.append((t - prev_t) * 1e3)
        prev_t, prev_n = t, counts
    check(marks[1][4], f"{label}: params unchanged after step 2")
    losses = ", ".join(f"{m[2]:.4f}" for m in marks)
    print(f"# train {label}: {steps} steps B={B} L={L}, losses [{losses}], "
          f"launches {total}")
    return out, walls, total, peak, batch, trained


def profile_step(card: str, label: str, state, batch, cfg,
                 seq_group=None) -> dict:
    """Where one train step's time goes: synchronized phases (corrupt +
    copy, forward, backward, optimizer; the packed loss for a packed
    batch; with `seq_group`, the sequence-parallel forward and its
    gathered loss), then torch.profiler over one whole step for the
    device's busy share and the largest kernels. Returns the phases' ms
    and the step's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from proteinbert_tpu_torch.parallel import (
        gather_seq, make_seq_parallel_train_step, seq_parallel_apply,
    )
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.loss import pretrain_loss
    from proteinbert_tpu_torch.train.schedule import (
        make_optimizer, tree_leaves,
    )

    if seq_group is None:
        def forward_loss(X, Y, W, seg):
            return ts.forward_loss(state.params, X, Y, W, cfg, seg)[0]

        def train_step():
            ts.train_step(state, batch, cfg)
    else:   # a one-rank group: the whole row is this rank's slice
        def forward_loss(X, Y, W, seg):
            ll, gl = seq_parallel_apply(seq_group, state.params, X["local"],
                                        X["global"], cfg.model)
            return pretrain_loss(gather_seq(ll, seq_group), gl, Y, W)[0]

        step_fn = make_seq_parallel_train_step(seq_group, cfg)

        def train_step():
            step_fn(state, batch)

    leaves = tree_leaves(state.params)
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    X, Y, W, seg = ts.corrupt_for_step(state, batch, cfg)
    mark()
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        loss = forward_loss(X, Y, W, seg)
        mark()
        grads = torch.autograd.grad(loss, leaves)
        mark()
    for t in leaves:
        t.requires_grad_(False)
    tx = make_optimizer(cfg.optimizer)
    ts.gradient_update(tx, state.params, grads, state.opt_state, loss, True)
    mark()
    names = ("corrupt + host->device", "forward (kernels + plain ops)",
             "backward (activation-dtype recompute + grads)", "optimizer")
    wall = marks[-1] - marks[0]
    print(f"# profile {label} [{card}]: one step {wall * 1e3:.1f} ms, "
          "phases synchronized:")
    phases = {"step": wall * 1e3}
    for name, a, b in zip(names, marks, marks[1:]):
        phases[name.split()[0]] = (b - a) * 1e3
        print(f"#   {(b - a) * 1e3:9.1f} ms {100 * (b - a) / wall:5.1f}%  "
              f"{name}")

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step()
        torch.cuda.synchronize()
    prof_wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + ms)
    if not by_name:
        print(f"# profile {label}: the profiler recorded no device time "
              "(device breakdown not measured)")
        return phases
    busy = sum(t for _, t in by_name.values())
    ours = sum(t for name, (_, t) in by_name.items()
               if any(k in name for k in KERNEL_NAMES))
    print(f"# profile {label} [{card}]: profiled step wall {prof_wall:.1f} "
          f"ms, device busy {busy:.1f} ms ({100 * busy / prof_wall:.1f}%; "
          f"host gaps {100 * (1 - busy / prof_wall):.1f}%), hand-written "
          f"forward kernels {ours:.1f} ms ({100 * ours / busy:.1f}% of busy)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"#   {t:9.3f} ms {100 * t / busy:5.1f}%  x{n:<4d} {name[:80]}")
    phases["busy"] = busy
    return phases


def train_phases(card: str) -> dict:
    """The trained paths: Large dense (#2 + K2) and packed (#4 + K2), each
    printed beside the same step with the float32 backward, base dense (K1 + K2) and packed (#3 + K2), the default width
    packed (#6); then sequence-parallel over a one-rank NCCL group: the
    `long` preset (K1's prehaloed entry) and Large (#2's); returns each
    kernel's launches summed over the runs."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED,
        LOCAL_TRACK_TILED_VALID, LOCAL_TRACK_VALID, ONEPASS,
    )
    from proteinbert_tpu_torch.train.metrics import peak_flops
    from proteinbert_tpu_torch.train.schedule import tree_leaves

    def preset(name, B, L, steps, packed=False, model=None):
        p = get_preset(name)
        return p.replace(
            model=model or p.model,
            data=dataclasses.replace(p.data, batch_size=B, seq_len=L,
                                     packing=packed, pack_max_segments=8),
            train=dataclasses.replace(p.train, max_steps=steps, log_every=1,
                                      eval_every=0))

    totals = {}

    def add(launches):
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n

    for packed, kernel, residues in (
            (False, LOCAL_TRACK_TILED, (100, 1022)),
            (True, LOCAL_TRACK_SEGMENTS_TILED, (50, 500))):
        label = "large packed" if packed else "large"
        large = preset("large", 8, 1024, 6, packed)
        out, walls, launches, peak, batch, trained = train_run(
            card, label, large, 6, {kernel.name: 12, ATTENTION.name: 12},
            residues, 0)
        add(launches)
        perf = out["perf"]
        med = statistics.median(walls[1:])
        n_params = sum(t.numel() for t in tree_leaves(out["state"].params))
        m = large.model
        rows = ""
        if packed:
            seg = np.concatenate([b["segment_ids"] for b in trained])
            rows = (f"; real (segment > 0) positions "
                    f"{(seg > 0).mean():.4f} of B*L, segments a row "
                    f"{seg.max(axis=1).mean():.3f} over {len(trained)} "
                    f"batches")
        print(f"# train {label} [{card}]: {m.num_blocks} blocks "
              f"C={m.local_dim} G={m.global_dim} H={m.num_heads} "
              f"A={m.num_annotations}, {m.dtype}, B=8 L=1024, {n_params} "
              f"params; step ms median of 5 {med:.1f} (steps "
              f"{', '.join(f'{w:.1f}' for w in walls)}); pretrain perf "
              f"{perf['step_ms']:.1f} ms/step, {perf['tokens_per_sec']:.0f} "
              f"tokens/s (B*L positions), MFU "
              f"{perf.get('mfu', float('nan')):.4f} of "
              f"{peak_flops(torch.device(DEVICE), 'bfloat16') or float('nan'):.3g}"
              f" FLOP/s; max_memory_allocated {peak / 1e9:.2f} GB{rows}")
        ph = profile_step(card, f"train {label}, one step B=8 L=1024",
                          out["state"], batch, large)
        was = F32_BACKWARD_LARGE[label]
        print(f"# bf16 backward, train {label} [{card}]: one profiled step "
              f"{ph['step']:.1f} ms (float32 backward: {was[0]}), forward "
              f"{ph['forward']:.1f} ({was[1]}), backward "
              f"{ph['backward']:.1f} ({was[2]}), optimizer "
              f"{ph['optimizer']:.1f} ({was[3]}); step median "
              f"{med:.1f} ms ({was[4]}); max_memory_allocated "
              f"{peak / 1e9:.2f} GB ({was[5]})")

    default = ModelConfig()
    for label, cfg, per_step, residues in (
            ("base", preset("base", 8, 512, 2),
             {LOCAL_TRACK.name: 6, ATTENTION.name: 6}, (100, 510)),
            ("base packed", preset("base", 8, 512, 2, True),
             {LOCAL_TRACK_SEGMENTS.name: 6, ATTENTION.name: 6}, (50, 250)),
            ("default width packed",
             preset("base", 8, 512, 2, True, default),
             {ONEPASS.name: 6}, (50, 250))):
        out, walls, launches, peak, _, _ = train_run(
            card, label, cfg, 2, per_step, residues, 1)
        add(launches)
        m = cfg.model
        print(f"# train {label} [{card}]: {m.num_blocks} blocks "
              f"C={m.local_dim} G={m.global_dim} H={m.num_heads}, {m.dtype}, "
              f"B=8 L=512, step ms {', '.join(f'{w:.1f}' for w in walls)}; "
              f"max_memory_allocated {peak / 1e9:.2f} GB")

    # Sequence parallelism on one card: a one-rank NCCL group, so the
    # halo exchange pads and the softmax sums stay local (no collective).
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    group = dist.group.WORLD
    try:
        # `long` (configs/config.py:411-423): B=4, the preset's 64 rows x
        # 2048 over 16 chips; its LR (2e-4) from step 0, without its
        # 10,000-step warmup, so that 6 steps move the loss.
        long_cfg = preset("long", 4, 2048, 6)
        long_cfg = long_cfg.replace(optimizer=dataclasses.replace(
            long_cfg.optimizer, schedule="constant", warmup_steps=0))
        out, walls, launches, peak, batch, _ = train_run(
            card, "long seq", long_cfg, 6, {LOCAL_TRACK_VALID.name: 6},
            (200, 2046), 2, seq_group=group)
        add(launches)
        losses = [h["loss"] for h in out["history"]]
        check(losses[-1] < losses[0], f"long seq: loss did not fall: "
                                      f"{losses}")
        perf = out["perf"]
        m = long_cfg.model
        n_params = sum(t.numel() for t in tree_leaves(out["state"].params))
        print(f"# train long seq [{card}]: seq group of 1 (NCCL), "
              f"{m.num_blocks} blocks C={m.local_dim} G={m.global_dim} "
              f"H={m.num_heads} A={m.num_annotations}, {m.dtype}, B=4 "
              f"L=2048, {n_params} params; reported cuts: seq world 4 -> 1, "
              f"data 4 -> 1, no LR warmup; step ms median of 5 "
              f"{statistics.median(walls[1:]):.1f} (steps "
              f"{', '.join(f'{w:.1f}' for w in walls)}); pretrain perf "
              f"{perf['step_ms']:.1f} ms/step, {perf['tokens_per_sec']:.0f} "
              f"tokens/s (B*L positions), MFU "
              f"{perf.get('mfu', float('nan')):.4f}; max_memory_allocated "
              f"{peak / 1e9:.2f} GB")
        profile_step(card, "train long seq, one step B=4 L=2048",
                     out["state"], batch, long_cfg, seq_group=group)
        large_seq = preset("large", 8, 1024, 2)
        out, walls, launches, peak, _, _ = train_run(
            card, "large seq", large_seq, 2,
            {LOCAL_TRACK_TILED_VALID.name: 12}, (100, 1022), 3,
            seq_group=group)
        add(launches)
        m = large_seq.model
        print(f"# train large seq [{card}]: seq group of 1 (NCCL), "
              f"{m.num_blocks} blocks C={m.local_dim}, {m.dtype}, B=8 "
              f"L=1024, step ms "
              f"{', '.join(f'{w:.1f}' for w in walls)}; max_memory_allocated "
              f"{peak / 1e9:.2f} GB")
    finally:
        dist.destroy_process_group()
    return totals


# ------------------------------------------------------------ phase 3

def reference_phase():
    """A base-width float32 trunk (2 blocks) through the kernels on the
    card against the plain path on the CPU, embed on 3 short sequences."""
    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.models.proteinbert import init, to_device

    base = get_preset("base")
    cfg = base.replace(
        model=dataclasses.replace(base.model, dtype="float32", num_blocks=2),
        data=dataclasses.replace(base.data, seq_len=128))
    params = init(cfg.model, torch.Generator().manual_seed(2), device="cpu")
    seqs = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWY" * 5, "GG"]
    want = inference.embed(params, cfg, seqs, batch_size=4, device="cpu")
    got = inference.embed(to_device(params, torch.device(DEVICE)), cfg,
                          seqs, batch_size=4, device=DEVICE)
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    print(f"# reference: float32 trunk C=G=512, 2 blocks, L=128, kernels on "
          f"card vs plain on CPU: max_abs_err {err:.3e} (tol {REF_TOL})")
    check(err <= REF_TOL, f"trunk vs plain CPU path: {err} > {REF_TOL}")


def traffic(n: int, seed: int):
    """`n` mixed requests of 20-500 residues, kinds in turn; each
    predict_residues request masks 3 positions with '?'."""
    from proteinbert_tpu_torch.data.vocab import ALPHABET
    from proteinbert_tpu_torch.serve.dispatch import KINDS

    rnd = random.Random(seed)
    reqs = []
    for i in range(n):
        length = rnd.randint(20, 500)
        seq = "".join(rnd.choice(ALPHABET) for _ in range(length))
        kind = KINDS[i % 3]
        if kind == "predict_residues":
            pos = rnd.sample(range(length), 3)
            seq = "".join("?" if j in pos else c for j, c in enumerate(seq))
        reqs.append((kind, seq))
    return reqs


def max_answer_diff(reqs, got, want, same_fills: bool = True) -> float:
    """Largest |difference| over two servers' answers to the same
    requests; with `same_fills` a filled residue string that differs fails
    outright (two arms of different weights may fill differently)."""
    worst = 0.0
    for (kind, _), a, b in zip(reqs, got, want):
        if kind == "embed":
            pairs = [(a[k], b[k]) for k in ("global", "local_mean")]
        elif kind == "predict_go":
            pairs = [(a, b)]
        else:
            check(a[0] == b[0] or not same_fills,
                  "predict_residues fills differ")
            pairs = [(a[1], b[1])]
        for u, v in pairs:
            check(u.shape == v.shape, f"{kind} shapes {u.shape} {v.shape}")
            worst = max(worst, float(np.abs(u - v).max()))
    return worst


def ragged_parity_phase() -> None:
    """A float32 base-width trunk (2 blocks) served ragged and bucketed on
    the card: the same requests, the answers within RAGGED_TOL."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.server import Server

    base = get_preset("base")
    cfg = base.replace(model=dataclasses.replace(
        base.model, dtype="float32", num_blocks=2))
    params = init(cfg.model, torch.Generator().manual_seed(5), device=DEVICE)
    reqs = traffic(12, seed=1)
    answers = {}
    for mode in ("bucketed", "ragged"):
        srv = Server(params, cfg, device=DEVICE, buckets=BUCKETS,
                     max_batch=8, max_wait_s=0.005, cache_size=0,
                     serve_mode=mode, warm_kinds=())
        srv.start()
        futures = [srv.submit(kind, seq) for kind, seq in reqs]
        check(srv.drain(timeout=300), f"{mode} parity server drain timed out")
        answers[mode] = [f.result(timeout=0) for f in futures]
    err = max_answer_diff(reqs, answers["ragged"], answers["bucketed"])
    print(f"# ragged vs bucketed: float32 trunk C=G=512, 2 blocks, "
          f"{len(reqs)} requests on the card: max_abs_err {err:.3e} "
          f"(tol {RAGGED_TOL})")
    check(err <= RAGGED_TOL, f"ragged vs bucketed: {err} > {RAGGED_TOL}")


def q8_reference_phase() -> None:
    """A base-width float32 int8 trunk (2 blocks, L=128) through the
    quantized entries on the card — the int8 legs on the path — against
    the same entries on the CPU plain path, bucketed (`quant_entry`: K1
    on dequantized track weights, K2-int8) and ragged
    (`quant_packed_entry`: #3-int8, K2-int8)."""
    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION_Q8, KERNELS, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS_Q8,
    )
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.parallel.quant import (
        quant_entry, quant_packed_entry, quantize_params,
    )

    base = get_preset("base")
    cfg = base.replace(
        model=dataclasses.replace(base.model, dtype="float32", num_blocks=2),
        data=dataclasses.replace(base.data, seq_len=128))
    qcpu = quantize_params(init(cfg.model, torch.Generator().manual_seed(2),
                                device="cpu"))
    qdev = to_device(qcpu, torch.device(DEVICE))
    seqs = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWY" * 5, "GG"]
    tokens = inference._tokenize_masked(seqs, 128, "count")
    A = cfg.model.num_annotations
    ann = np.zeros((3, A), np.float32)
    # Ragged: two short sequences packed into row 0 at spans 32 and 16 (a
    # pad tail after them), the long one alone in row 1.
    ptoks = np.zeros((2, 128), np.int32)
    pseg = np.zeros((2, 128), np.int32)
    pos = 0
    for s, (seq, span) in enumerate(((seqs[0], 32), (seqs[2], 16))):
        t = inference._tokenize_masked([seq], 128, "count")[0, :span]
        ptoks[0, pos:pos + span], pseg[0, pos:pos + span] = t, s + 1
        pos += span
    ptoks[1], pseg[1] = tokens[1], 1
    pann = np.zeros((2, 2, A), np.float32)
    for label, fn, arrays, want_launch in (
            ("bucketed", quant_entry("embed"), (tokens, ann),
             {LOCAL_TRACK.name, ATTENTION_Q8.name}),
            ("ragged", quant_packed_entry("embed"), (ptoks, pseg, pann),
             {LOCAL_TRACK_SEGMENTS_Q8.name, ATTENTION_Q8.name})):
        want = inference.run_batch(fn, qcpu, cfg, *arrays, device="cpu")
        for kk in KERNELS:
            kk.launches = 0
        got = inference.run_batch(fn, qdev, cfg, *arrays, device=DEVICE)
        ran = {kk.name for kk in KERNELS if kk.launches}
        check(ran == want_launch, f"int8 reference {label}: launched {ran}, "
                                  f"want {want_launch}")
        err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        print(f"# reference int8 {label}: float32 int8 trunk C=G=512, 2 "
              f"blocks, L=128, int8 legs on card vs plain on CPU: max_abs_err "
              f"{err:.3e} (tol {REF_TOL}), kernels {sorted(ran)}")
        check(err <= REF_TOL, f"int8 trunk {label} vs plain CPU path: "
                              f"{err} > {REF_TOL}")


# ------------------------------------------------------------ phase 4

def serve_phase(card: str, label: str, cfg, mode: str, per_batch: dict,
                seed: int, quant: str = "fp32", n_requests: int = 24,
                alone: bool = True):
    """One server over random weights (seed `seed`) on the `quant` arm:
    `n_requests` mixed requests from 4 threads with every kernel count at 0,
    then drain. Checks every answer, the launches (exactly per_batch[name]
    per batch, 0 for a kernel not named) and, with `alone`, each embed
    against the same sequence run alone. Prints the device memory the
    loaded server holds (weights and all: `torch.cuda.memory_allocated()`
    before the weights are made and after the server is built, the caller's
    reference to the weights dropped) and, on an int8 arm, its
    `quant_report`. Returns (server, launches, answers)."""
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.dispatch import KINDS
    from proteinbert_tpu_torch.serve.server import Server

    gc.collect()  # an earlier server's reference cycles
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    params = init(cfg.model, torch.Generator().manual_seed(seed),
                  device=DEVICE)
    srv = Server(params, cfg, device=DEVICE, buckets=BUCKETS, max_batch=8,
                 max_wait_s=0.005, queue_depth=64, cache_size=256,
                 warm_kinds=KINDS, serve_mode=mode, pack_max_segments=8,
                 quant=quant, quant_parity_every=0)
    del params
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - mem0
    print(f"# serve {label}: device memory after load {held} bytes "
          f"({held / 2**20:.2f} MiB) [{card}]")
    if quant != "fp32":
        report = srv.stats()["quant"]
        print(f"# serve {label}: quant_report {json.dumps(report)}")
        check(report["fp32_resident"] == "host", "fp32 tree not on the host")
    t0 = time.perf_counter()
    srv.start()
    print(f"# serve {label}: warmup {time.perf_counter() - t0:.2f} s")

    reqs = traffic(n_requests, seed=0)
    futures = [None] * len(reqs)
    submitted = [0.0] * len(reqs)
    finished = [None] * len(reqs)

    def client(idx):
        for i in idx:
            kind, seq = reqs[i]
            submitted[i] = time.perf_counter()
            futures[i] = srv.submit(kind, seq)
            futures[i].add_done_callback(
                lambda f, i=i: finished.__setitem__(i, time.perf_counter()))

    for k in KERNELS:
        k.launches = 0
    threads = [threading.Thread(target=client,
                                args=(range(j, len(reqs), 4),))
               for j in range(4)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    check(not any(t.is_alive() for t in threads), "client threads hung")
    check(srv.drain(timeout=300), "drain timed out")
    wall = time.perf_counter() - t_start
    launches = {k.name: k.launches for k in KERNELS}
    results = [f.result(timeout=0) for f in futures]
    latency = [b - a for a, b in zip(submitted, finished)]
    stats = srv.stats()
    batches = stats["batches"]
    print(f"# serve {label}: {len(reqs)} requests in {batches} batches "
          f"({stats['batched_rows']} rows), launches {launches}")
    check(stats["completed"] == len(reqs), f"completed {stats['completed']}")
    check(batches > 0, "no batch dispatched")
    for name, n in launches.items():
        want = per_batch.get(name, 0) * batches
        check(n == want, f"{label}: {name} launched {n} times for {batches} "
                         f"batches, want {want}")

    A = cfg.model.num_annotations
    worst = 0.0
    for (kind, seq), res in zip(reqs, results):
        if kind == "embed":
            check(res["global"].shape == (cfg.model.global_dim,)
                  and res["local_mean"].shape == (cfg.model.local_dim,),
                  "embed shapes")
            check(all(np.isfinite(v).all() for v in res.values()),
                  "embed non-finite")
            if alone:
                solo = embed_alone(srv, seq)
                for key in ("global", "local_mean"):
                    worst = max(worst,
                                float(np.abs(solo[key] - res[key]).max()))
        elif kind == "predict_go":
            check(res.shape == (A,) and np.isfinite(res).all()
                  and ((res >= 0) & (res <= 1)).all(), "predict_go probs")
        else:
            filled, probs = res
            L = srv.dispatcher.bucket_len(len(seq))
            check(len(filled) == len(seq) and "?" not in filled,
                  "predict_residues fill")
            check(probs.shape == (L, cfg.model.vocab_size)
                  and np.isfinite(probs).all(), "predict_residues probs")
    if alone:
        print(f"# serve {label}: embed served vs alone (same mode, one "
              f"request in the batch) max_abs_err {worst:.3e} "
              f"(tol {SERVE_EMBED_TOL})")
        check(worst <= SERVE_EMBED_TOL, f"served embed vs alone: {worst}")

    lat = sorted(latency)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
    print(f"# serve {label} [{card}]: {len(reqs) / wall:.2f} requests/s, "
          f"p50 {p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms "
          f"(client-side, {len(reqs)} requests, 4 threads)")
    return srv, launches, results


def embed_alone(srv, seq: str) -> dict:
    """`seq` embedded through the server's own dispatcher as the only
    request of its batch: a bucketed batch of one row, or a packed batch
    whose first row holds it at position 0 (every other row empty)."""
    from proteinbert_tpu_torch import inference

    disp = srv.dispatcher
    span = disp.bucket_len(len(seq))
    toks = inference._tokenize_masked([seq], disp.cfg.data.seq_len,
                                      "count")[:, :span]
    if srv.serve_mode == "bucketed":
        return {k: v[0] for k, v in disp.run("embed", toks).items()}
    R, L = disp.rows_per_batch, disp.cfg.data.seq_len
    tokens = np.zeros((R, L), np.int32)
    seg = np.zeros((R, L), np.int32)
    tokens[0, :span], seg[0, :span] = toks[0], 1
    ann = np.zeros((R, disp.max_segments, disp.cfg.model.num_annotations),
                   np.float32)
    return disp.run_packed("embed", tokens, seg, ann, [(0, 0, 0, span)])[0]


def full_ragged_batch(srv):
    """One full packed embed batch for a ragged server: 8 rows x 512
    tokens, each row three segments at spans 256, 128, 128 filled to
    <sos> residues <eos>."""
    disp = srv.dispatcher
    R, L, S = disp.rows_per_batch, disp.cfg.data.seq_len, disp.max_segments
    rng = np.random.default_rng(4)
    tokens = np.zeros((R, L), np.int32)
    seg = np.zeros((R, L), np.int32)
    riders = []
    for r in range(R):
        start = 0
        for s, span in enumerate((256, 128, 128)):
            tokens[r, start] = 1
            tokens[r, start + 1:start + span - 1] = rng.integers(4, 26,
                                                                 span - 2)
            tokens[r, start + span - 1] = 2
            seg[r, start:start + span] = s + 1
            riders.append((r, s, start, span))
            start += span
    ann = np.zeros((R, S, disp.cfg.model.num_annotations), np.float32)
    return tokens, seg, ann, riders


def profile_batch(card: str, label: str, run) -> None:
    """Where one full served batch's time goes: torch.profiler over one
    call of `run` (a dispatcher call that ends in a device→host copy) —
    device time by kernel name, and the device's busy share of the wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(5):  # unprofiled: the profiler slows the host side
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + ms)
    busy = sum(t for _, t in by_name.values())
    if not by_name:
        print(f"# profile {label}: the profiler recorded no device time "
              "(device breakdown not measured)")
        return
    print(f"# profile {label} [{card}]: wall {wall_ms:.3f} ms (median of 5, "
          f"unprofiled), device busy {busy:.3f} ms (profiled run; "
          f"{100 * busy / wall_ms:.1f}% of wall)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"#   {t:9.3f} ms {100 * t / busy:5.1f}%  x{n:<4d} {name[:80]}")
    print(f"# profile {label}: host ops by self CPU time (profiled, so "
          "inflated; shares only)")
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"#   host {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<4d} {e.key[:70]}")


def serve_phases(card: str) -> dict:
    """The three served paths (bucketed base, ragged base, ragged at the
    ModelConfig default width), each on the fp32 arm and then on the int8
    arm (same weights and traffic); then the int8 arm's parity shadow and
    the `int8_act` arm. Returns each kernel's launches summed over the
    traffic runs."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_Q8, ONEPASS, ONEPASS_Q8,
    )

    base = get_preset("base")
    default = base.replace(model=ModelConfig())
    rng = np.random.default_rng(3)
    tokens = rng.integers(4, 26, (8, 512)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 1, 2
    totals = {}
    # (label, config, mode, fp32 launches per batch, int8 launches per batch)
    servers = (
        ("bucketed base", base, "bucketed",
         {LOCAL_TRACK.name: 6, ATTENTION.name: 6},
         {LOCAL_TRACK.name: 6, ATTENTION_Q8.name: 6}),
        ("ragged base", base, "ragged",
         {LOCAL_TRACK_SEGMENTS.name: 6, ATTENTION.name: 6},
         {LOCAL_TRACK_SEGMENTS_Q8.name: 6, ATTENTION_Q8.name: 6}),
        ("ragged default width", default, "ragged",
         {ONEPASS.name: 6}, {ONEPASS_Q8.name: 6}),
    )
    reqs = traffic(24, seed=0)
    for label, cfg, mode, per_fp, per_q8 in servers:
        answers = {}
        for quant, per_batch in (("fp32", per_fp), ("int8", per_q8)):
            name = label if quant == "fp32" else f"{label} int8"
            srv, launches, answers[quant] = serve_phase(
                card, name, cfg, mode, per_batch, seed=0, quant=quant)
            for kname, n in launches.items():
                totals[kname] = totals.get(kname, 0) + n
            if mode == "bucketed":
                profile_batch(card, f"{name}, one embed batch 8x512",
                              lambda: srv.dispatcher.run("embed", tokens))
            else:
                packed = full_ragged_batch(srv)
                profile_batch(card, f"{name}, one packed embed batch 8x512 "
                              "(24 segments)",
                              lambda: srv.dispatcher.run_packed("embed",
                                                                *packed))
            del srv
        diff = max_answer_diff(reqs, answers["int8"], answers["fp32"],
                               same_fills=False)
        print(f"# serve {label} int8: max |int8 - fp32 arm| over the "
              f"{len(reqs)} answers {diff:.6e}")
        check(diff > 0, f"{label}: the int8 arm answered exactly as the fp32 "
                        "arm (were the int8 weights used?)")
    q8_parity_phase(card, base)
    srv, launches, answers = serve_phase(
        card, "bucketed base int8_act", base, "bucketed",
        {LOCAL_TRACK.name: 6, ATTENTION_Q8.name: 6}, seed=0,
        quant="int8_act", n_requests=12, alone=False)
    for kname, n in launches.items():
        totals[kname] = totals.get(kname, 0) + n
    return totals


def q8_parity_phase(card: str, base) -> None:
    """The int8 arm's fp32 parity shadow: a bucketed base dispatcher with
    quant_parity_every=1 runs 3 embed batches (4 rows, L=128 and 256); each
    runs the shadow, and `quant_report["parity_max"]` must equal the worst
    deviation measured outside against an fp32 dispatcher on the same
    weights."""
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.dispatch import (
        BucketDispatcher, parity_max,
    )

    params = init(base.model, torch.Generator().manual_seed(0),
                  device=DEVICE)
    disp = BucketDispatcher(params, base, buckets=BUCKETS, max_batch=4,
                            device=DEVICE, quant="int8",
                            quant_parity_every=1)
    fp32 = BucketDispatcher(params, base, buckets=BUCKETS, max_batch=4,
                            device=DEVICE)
    disp.warmup(("embed",))
    check(disp._quant_batches == 0, "warmup consumed the parity cadence")
    rng = np.random.default_rng(9)
    worst = 0.0
    for L in (128, 256, 128):
        toks = rng.integers(4, 26, (4, L)).astype(np.int32)
        toks[:, 0], toks[:, -1] = 1, 2
        toks[3, L // 2:] = 0
        toks[3, L // 2 - 1] = 2
        out = disp.run("embed", toks)
        worst = max(worst, parity_max(out, fp32.run("embed", toks)))
    report = disp.quant_report
    print(f"# serve parity: bucketed base int8, quant_parity_every=1, 3 "
          f"batches: parity_samples {report.get('parity_samples')}, "
          f"parity_max {report.get('parity_max')}, measured outside "
          f"{worst:.9f}, fp32 tree {report['fp32_resident']} [{card}]")
    check(report.get("parity_samples") == 3, "parity samples != 3")
    check(report["fp32_resident"] == "device", "shadow tree not on device")
    check(report["parity_max"] == round(worst, 9) and worst > 0,
          f"parity_max {report['parity_max']} != measured {worst}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, KERNELS, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_Q8, LOCAL_TRACK_SEGMENTS_TILED,
        LOCAL_TRACK_TILED, LOCAL_TRACK_TILED_VALID, LOCAL_TRACK_VALID,
        ONEPASS, ONEPASS_Q8,
    )
    from proteinbert_tpu_torch.kernels.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build_all(KERNELS)
    print(f"# build: {time.perf_counter() - t0:.1f} s")
    for k in KERNELS:
        regs = [int(w) for w in re.findall(r"Used (\d+) registers",
                                           k.ptxas_log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             k.ptxas_log)]
        print(f"#   {k.name}: {len(regs)} instantiations, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores "
              f"max {max(spills, default=0)} bytes")

    t0 = time.perf_counter()
    rows = kernel_phase(card)
    packed_kernel_phase(card, rows)
    large_kernel_phase(card, rows)
    valid_kernel_phase(card, rows)
    q8_extra = q8_kernel_phase(card, rows)
    print_rows(card, rows)
    print_q8_rows(card, rows, q8_extra)
    print(f"# kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grad_phase(card)
    reference_phase()
    reference_step_phase(card)
    packed_reference_phase(card)
    ragged_parity_phase()
    q8_reference_phase()
    print(f"# gradients and references: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = serve_phases(card)
    print(f"# serve: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in train_phases(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# train: {time.perf_counter() - t0:.1f} s")

    # (source, TPU launch site, the served shape its row was timed at)
    ported = {
        LOCAL_TRACK.name: (
            "proteinbert_tpu_torch/csrc/local_track.cu",
            "proteinbert_tpu/kernels/fused_block.py:804", 512, "dense",
            "B=8 L=512 C=512 bf16"),
        LOCAL_TRACK_SEGMENTS.name: (
            "proteinbert_tpu_torch/csrc/local_track_segments.cu",
            "proteinbert_tpu/kernels/fused_block.py:1134", 512, "S=8",
            "B=8 L=512 C=512 S=8 bf16"),
        ATTENTION.name: (
            "proteinbert_tpu_torch/csrc/global_attention.cu",
            "proteinbert_tpu/kernels/attention.py:319", 512, "dense",
            "B=8 L=512 C=G=512 H=8 k=64 S=1 bf16"),
        ONEPASS.name: (
            "proteinbert_tpu_torch/csrc/one_pass.cu",
            "proteinbert_tpu/kernels/one_pass.py:380", 512, "C=128 S=8",
            "B=8 L=512 C=128 G=512 H=4 k=64 v=128 S=8 bf16"),
        LOCAL_TRACK_TILED.name: (
            "proteinbert_tpu_torch/csrc/local_track_tiled.cu",
            "proteinbert_tpu/kernels/fused_block.py:881", 1024, "dense",
            "B=8 L=1024 C=1024 bf16"),
        LOCAL_TRACK_SEGMENTS_TILED.name: (
            "proteinbert_tpu_torch/csrc/local_track_segments_tiled.cu",
            "proteinbert_tpu/kernels/fused_block.py:1220", 1024, "S=8",
            "B=8 L=1024 C=1024 S=8 bf16"),
        LOCAL_TRACK_SEGMENTS_Q8.name: (
            "proteinbert_tpu_torch/csrc/local_track_segments_q8.cu",
            "proteinbert_tpu/kernels/fused_block.py:1134", 512, "S=8",
            "B=8 L=512 C=512 S=8 bf16, int8 weights"),
        ATTENTION_Q8.name: (
            "proteinbert_tpu_torch/csrc/global_attention_q8.cu",
            "proteinbert_tpu/kernels/attention.py:319", 512, "dense",
            "B=8 L=512 C=G=512 H=8 k=64 S=1 bf16, int8 weights"),
        ONEPASS_Q8.name: (
            "proteinbert_tpu_torch/csrc/one_pass_q8.cu",
            "proteinbert_tpu/kernels/one_pass.py:380", 512, "C=128 S=8",
            "B=8 L=512 C=128 G=512 H=4 k=64 v=128 S=8 bf16, int8 weights"),
        LOCAL_TRACK_VALID.name: (
            "proteinbert_tpu_torch/csrc/local_track_valid.cu",
            "proteinbert_tpu/kernels/fused_block.py:804", 512, "shard",
            "B=16 L=512+2*20 C=512 bf16, prehaloed"),
        LOCAL_TRACK_TILED_VALID.name: (
            "proteinbert_tpu_torch/csrc/local_track_tiled_valid.cu",
            "proteinbert_tpu/kernels/fused_block.py:881", 256, "shard",
            "B=8 L=256+2*20 C=1024 bf16, prehaloed"),
    }
    report = []
    for k in KERNELS:
        src, tpu, L, case, shape = ported[k.name]
        err, ms, plain, b_ms, b_by, _ = rows[(k.name, torch.bfloat16, L,
                                              case)]
        check(launches[k.name] > 0, f"{k.name} never launched on a served "
                                    "or trained path")
        row = {"name": k.name, "route": "cuda", "source": src,
               "replaces": tpu, "launches": launches[k.name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "status": "ported", "shape": shape}
        key = (k.name, torch.bfloat16, L, case)
        if key in q8_extra:  # an int8 leg: its fp leg's time on the same call
            row["fp_leg_ms"] = q8_extra[key][1]
        report.append(row)
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())


