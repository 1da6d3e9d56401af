#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase large   # the Large-width local track only
    python3 chip_smoke.py --phase base    # K1, #3, K2 and int8 legs' times
    python3 chip_smoke.py --phase k2      # the same as --phase base
    python3 chip_smoke.py --phase default # #6 and #6-int8's times
    python3 chip_smoke.py --phase resume  # checkpoint, SIGTERM, resume
    python3 chip_smoke.py --phase serve   # the served paths and their gates
    python3 chip_smoke.py --phase serve-times  # their numbers only
    python3 chip_smoke.py --phase finetune  # fine-tune, then predict_task
    python3 chip_smoke.py --phase neighbors # map, index, /v1/neighbors;
                                            # the int8 arm at Large

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
              #2 and #4 in bf16 at C=640 and C=2048 (B=2, L=200);
              #4 at Large width (C=1024, B=8, S=8) in bf16 and fp32, L in
              {128, 1024} timed and L=100, with segment boundaries on and
              beside the 64-row tile edges (bf16 finish pass, fp32 conv
              pass) and the 128-row bf16 conv tile edge, inside a 32-row
              finish tile and inside a tile's 20-row halo;
              the conv pass and the finish pass of K1, #3 (B=8, L=C=512),
              #2, #4 (B=8, L=C=1024) and the prehaloed entries of K1
              (B=16, L=512+2*20) and #2 timed apart by torch.profiler's
              kernel names (`# passes`), #3-int8 with its dequantize pass
              beside its fp leg, and so K2's bf16 passes (query,
              projection, softmax; the int8 leg's dequantize pass) at base
              width (B=8, L=512) and Large width (L=1024), dense and S=8,
              and #6's bf16 passes (query, conv, finish, projection,
              softmax) at C=128, B=8, L=512, dense and S=8;
              the HGMMA and UTMALDG counts `cuobjdump -sass` finds in the
              libraries of K1, its prehaloed entry, #3, #3-int8, #2, its
              prehaloed entry, #4, both K2 entries and both #6 legs
              (`# SASS`), and an
              equal-FLOP torch.matmul GEMM yardstick (never called by the
              port);
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
              dense and packed, at value_dim 128 and at Large width
              (L=1024, C=G=1024, H=16, bf16, dense and S=8, timed with
              its passes beside its fp leg), #6-int8 at C=128/256
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
              traffic and read just after it. Each served shape is a CUDA
              graph captured at start() (`serve/dispatch.WarmShape`), so
              the counts hold with every replay credited; each server
              prints its graphs' pool bytes after warmup, the host ms from
              submit to a full batch's replay enqueued, and when each
              request was answered. On each of the six paths: one full
              embed batch replayed equals its eager run bit for bit; the
              24 requests submitted before start() to a server at
              pipeline_depth 2 and to one at depth 1 are answered bit for
              bit alike, each future sealed once, inflight_max <= depth;
              both servers' event streams pass read_events(strict=True)
              and the schema validator (one serve_request a request, one
              serve_batch a batch, serve_start first, serve_end drained
              last); the depth-2 server answers one request of each kind
              over HTTP on 127.0.0.1 exactly as in process, a bad body
              400 and a predict_task for an unknown head the typed 404.
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
6. resume   — `resume_phase`: a pretraining run that survives, through
              `pretrain(..., checkpointer=, telemetry=)`: `large` dense at
              full depth and width (B=8, L=1024, 6 steps, saves every 3)
              and `base` packed (B=8, L=512, 4 steps, saves every 2), each
              run at peak LR uninterrupted with synchronous saves, then
              with staged saves and SIGTERM from log_fn (step 4 / 2), then
              resumed by a fresh state and a new Checkpointer: the
              restored state bit for bit the saved one, the staged saves
              held against the synchronous ones and the final state
              (RESUME_STATE_TOL, a planted fault beyond it), two staged
              saves racing train-stream work and in-place updates read
              back bit for bit, the resumed losses within
              RESUME_LOSS_TOL of the uninterrupted run's, exact launch
              counts a step (12 #2 + 12 K2 / 6 #3 + 6 K2), a valid event
              stream; and, at Large, the boundary's cost (the walls of the
              steps holding a synchronous and a staged save against the
              median step, the stage's seconds until it landed, the
              checkpoint's bytes). The checkpoints go to a temporary
              directory under build/, removed afterwards.
   long hdf5 — `long_hdf5_phase`, `# train long hdf5`: the `long` preset
              (6 blocks, C=G=512, H=8, 8943 annotations), bf16, B=16, 8
              steps, from a seeded HDF5 corpus of 4096 proteins (lengths
              log-normal, median 350, capped at 3000) in the reference
              schema, through `HDF5PretrainingDataset`, the bucketed
              iterator (512 / 1024 / 2048) and pretrain's prefetch thread
              (depth 2); without h5py the same rows come from memory. Cuts:
              global batch 64 over 4 replicas -> 16, seq world 4 -> 1, no
              LR warmup. Gates: the prefetched stream equals the
              iterator's own byte for byte; exactly 6 K1 + 6 K2 a step;
              finite losses. Prints step ms, tokens/s and MFU by bucket,
              data_wait_s, data_batches_total, the pad fraction and peak
              memory.
7. finetune — `finetune_phase`, `# finetune base`: a float32 2-block
              base-width fine-tune step on the card against the CPU plain
              path (loss <= 1e-4, grads <= 1e-3) for both tasks; then the
              `base` trunk in bf16 fine-tuned (B=8, L=512, 4 steps) for
              token_classification (8 classes) and sequence_regression (1
              output), freeze_trunk False and True, each head registered
              in a HeadRegistry: exactly 6 K1 + 6 K2 a step, the frozen
              trunk bit for bit; step ms, tokens/s, peak memory.
              `serve_task_phase`, `# serve base predict_task`: bucketed and
              ragged servers, fp32 and int8 arms, over that trunk with the
              two frozen-trunk heads: 24 predict_task requests (exactly 6
              K1 or #3 (int8: #3-int8 ragged) + 6 K2 (int8: K2-int8) a
              batch); the fp32 bucketed answers bit for bit
              `predict_task_rows` run eagerly on the card; one full batch
              replayed bit for bit the eager trunk and tails; the int8 arm
              off the fp32 one; a hot-added third head captures no trunk
              graph; a removed head -> the typed unknown_head; a head
              fine-tuned with its trunk -> TrunkMismatchError; HTTP
              /v1/predict_task and /v1/heads* (fp32 arms). Prints each
              server's graph pool and a full batch's wall and busy share.
8. neighbors — `neighbors_phase`, `# neighbors base ...`: the `base` trunk
              in bf16 maps 8192 seeded proteins (`corpus_rows`: log-normal
              lengths, median 350, a third truncated at the 510-residue
              window) plus three poisoned records (empty, non-string, a
              control character) into a store (`mapper.run_map`: buckets
              128/256/512, rows_per_batch 8, 8 segments, 2 shards of
              256-record blocks). Gates: exactly 6 #3 + 6 K2 per packed
              batch and nothing else; `verify_store` ok and complete; a run
              stopped by `max_blocks` and resumed, and one with
              `pipeline=False`, write the uninterrupted store byte for byte
              (`store_digests`); the poisoned records quarantined with their
              typed reasons. `build_index` with its defaults (64 centroids,
              256-vector blocks, seed 0): `verify_index` ok, bytes ratio
              <= 0.30, recall@10 at nprobe 64 (a full probe) >= 0.95
              against float32 `exact_topk`. `Server(index=, nprobe=8)`
              bucketed and ragged (fp32 arm): 64 neighbours and the same 64
              embeds submitted before `start()`; each answer equals
              `lookup_one` over its own served embed vector bit for bit;
              graphs and pool equal the index-free server's; launches
              exactly the embed batches' (6 K1 or #3 + 6 K2); the outcome
              funnel; HTTP `/v1/neighbors` = in process, k=0 400; an index
              of another trunk -> TrunkMismatchError, none -> ValueError.
              Prints the map's sequences/s, residues/s, batches, busy share
              (a profiled 512-record run), commit_s and overlap_s; the
              build's host seconds, recall@10 at nprobe 8; the lookup's ms
              at Q=1 and lookups/s at Q=64 (nprobe 8 and 64); the served
              neighbours' p50 / p99 split into the embed leg and `lookup`.
              `large_int8_phase`, `# serve bucketed|ragged large[ int8]`:
              the `large` preset (12 blocks, C=G=1024, H=16) in bf16,
              buckets 256/512/1024, one batch class (max_batch 8), fp32 and
              int8 arms, 16 embed requests submitted before `start()`:
              exactly 12 #2 (ragged: #4) and 12 K2 (int8: K2-int8) per
              batch, none of the others; one full batch's replay equals its
              eager run bit for bit; the int8 answers off the fp32 ones by
              a finite nonzero amount (printed). Prints weight_bytes_ratio,
              the graphs' pool bytes and a full batch's wall and busy share.
9. report   — the kernel JSON line, the card's name and power limit, and the
              result line {"ok": true, "device": {...}} last.

`--phase large` runs the build, the SASS check, the Large-width kernel
phases (#2, #4, K2 at Large width with its passes, the prehaloed entries)
and the yardstick, and prints no result line. `--phase base` (or its
older name `--phase k2`) runs the build and `base_phase`: the wall, host
enqueue time and device time by pass of K1, K1's prehaloed entry, #3,
#3-int8 and K2 (and K2-int8) at the kernel table's shapes, no gate and no
result line; it also runs on the parent commit's package, so one call can
time both. `--phase default` does the same for #6 and #6-int8 in bf16
(`default_phase`: B=8, C=128, G=512, H=4, v=128 at L=512 and L=128, dense
and S=8, and C=512, H=4, L=128, S=8), each beside the composition K1 or
#3, then K2, on the same inputs. `--phase resume` runs the build and
`resume_phase` alone: its gates and the boundary's numbers, no result
line. `--phase serve` runs the build and phase 4 alone, every gate, no
result line; `--phase serve-times` runs phase 4's six servers with their
launch gates and numbers but without the replay, depth, event and HTTP
gates, which need this tree's package, so it also runs on a parent
commit's package (copy this script into its `git archive`).
`--phase finetune` runs the build and phase 7 alone, every gate, no
result line. `--phase neighbors` runs the build and phase 8 alone
(`neighbors_phase`, then `large_int8_phase`), every gate, no result
line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
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
# A resumed run's losses against the uninterrupted run's, relative to
# max(1, |loss|): the restored state is bit for bit the saved one, but
# cuDNN's backward convolutions may pick non-deterministic algorithms, so
# two runs of the same steps may differ in the last bits of the grads.
RESUME_LOSS_TOL = 1e-3
# A resumed run's final state against the uninterrupted run's, and a
# staged checkpoint against a synchronous one of the same step in another
# run (`state_drift`: the params' update, each Adam moment, the plateau's
# loss averages, each relative). Zeroing the moments on restore lands far
# beyond it (the `resume` phase checks that too).
RESUME_STATE_TOL = 1e-2
# GPU clock cycles of `torch.cuda._sleep` that hold the train stream
# about 1 s in `staged_ordering_check` (H100 SXM: up to 1.98 GHz).
SLEEP_CYCLES = 2_000_000_000
# Device-code names of the hand-written kernels, as the profiler lists them.
KERNEL_NAMES = ("local_track_kernel", "attention_kernel", "onepass",
                "tiled_conv_kernel", "wgmma_conv_kernel",
                "tiled_finish_kernel", "wgmma_finish_kernel",
                "dequant_track_kernel", "attn_query_kernel",
                "wgmma_attn_kernel", "attn_softmax_kernel",
                "dequant_kv_kernel")
# The passes of one call, by the profiler's kernel names: the local track
# in bf16 (K1, its prehaloed entry, #3, #2, #4: conv, finish; #3-int8 also
# its dequantize pass; K1 and #3 before their Hopper passes, and float32,
# the one-launch plan) and K2 in bf16 (query, projection, softmax; the int8
# leg also its dequantize pass; float32, and K2 before its Hopper passes,
# the one-block-per-(head, row) plan).
TRACK_PASSES = (("conv pass", "conv_kernel"), ("finish pass", "finish_kernel"),
                ("dequantize", "dequant_track_kernel"),
                ("one-launch plan", "local_track_kernel"))
K2_PASSES = (("query", "attn_query_kernel"),
             ("projection", "wgmma_attn_kernel"),
             ("softmax", "attn_softmax_kernel"),
             ("dequant", "dequant_kv_kernel"),
             ("one-block plan", "attention_kernel"))
# #6's passes in bf16 (PR 10: the int8 leg's dequantize pass, query and
# mask ids, conv, finish, projection, softmax); before PR 10, and in
# float32, the one-launch cluster plan.
ONEPASS_PASSES = (("dequantize", "onepass_dequant_kernel"),
                  ("query", "onepass_query_kernel"),
                  ("conv", "conv_kernel"),
                  ("finish", "finish_kernel"),
                  ("projection", "wgmma_attn_kernel"),
                  ("softmax", "attn_softmax_kernel"),
                  ("cluster plan", "onepass_kernel"))
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


def device_ms_by_name(fn, reps: int = 10, tries: int = 3) -> dict:
    """Device ms per call of each kernel `fn` launches, by name, from
    torch.profiler over `reps` calls after a warm one; {} where the
    profiler records no device time in `tries` attempts (it now and then
    records none for one window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms = (e.time_range.end - e.time_range.start) / 1e3 / reps
                by_name[e.name] = by_name.get(e.name, 0.0) + ms
        if by_name:
            break
    return by_name


def print_passes(card: str, label: str, fn, passes=TRACK_PASSES) -> None:
    """The device ms per call of each pass of one kernel call (#2 / #4:
    conv and finish; K2: `K2_PASSES`) by the profiler's kernel names, and
    their sum."""
    by_name = device_ms_by_name(fn)
    if not by_name:
        print(f"# passes {label}: the profiler recorded no device time "
              "(not measured)")
        return
    split = {}
    for name, ms in by_name.items():
        m = re.search(r"(\w+_kernel)\b", name)
        short = m.group(1) if m else name[:40]
        split[short] = split.get(short, 0.0) + ms
    got = {label_: sum(ms for n, ms in split.items() if key in n)
           for label_, key in passes}
    got = {k: v for k, v in got.items() if v > 0}
    device = sum(got.values())
    names = ", ".join(f"{n} {ms:.4f}" for n, ms in sorted(split.items()))
    shown = ", ".join(f"{k} {v:.4f} ms" for k, v in got.items())
    print(f"# passes {label} [{card}]: {shown} per call; device "
          f"{device:.4f} ms (torch.profiler, 10 calls: {names})")


def enqueue_us(fn, n: int = 50) -> float:
    """The host's time to issue one call: n calls without a sync (the card
    is faster than the host here, so none waits on it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def print_timed(card: str, tag: str, label: str, fn, passes) -> None:
    """One call's wall ms, host enqueue time and device ms by pass."""
    print(f"# {tag} {label}: wall {time_ms(fn):.4f} ms, host enqueue "
          f"{enqueue_us(fn):.1f} us a call [{card}]")
    print_passes(card, label, fn, passes)


def ptxas_functions(log: str):
    """(kernel name and template arguments, registers, spill-store bytes)
    for each entry function `nvcc -Xptxas -v` reported."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.match(r"_ZN3pbt\d+(\w+?_kernel)(I\w*?E)?", m.group(1))
            name = "".join(k.groups("")) if k else m.group(1)[:48]
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def sass_line(card: str, kernels) -> None:
    """The wgmma and TMA instructions `cuobjdump -sass` finds in each
    library; every one must have both (K1, #3, #2, #4, their prehaloed
    entries and int8 leg, both K2 entries)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("# SASS: not checked (the toolkit has no cuobjdump)")
        return
    for k in kernels:
        sass = subprocess.run([tool, "-sass", str(k.library_path())],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        hgmma, utmaldg = sass.count("HGMMA"), sass.count("UTMALDG")
        print(f"# SASS {k.name}: HGMMA {hgmma}, UTMALDG {utmaldg} [{card}]")
        check(hgmma > 0 and utmaldg > 0,
              f"{k.name}: no wgmma or no TMA load in its SASS")


def gemm_yardstick(card: str) -> None:
    """One equal-FLOP torch.matmul yardstick for #2 / #4 at B=8, L=C=1024
    bf16: (B·L, 9C)·(9C, C) twice plus (B·L, C)·(C, C). A GEMM yardstick,
    not a library time for the function: the port never calls it."""
    B, L, C = 8, 1024, 1024
    gen = torch.Generator().manual_seed(71)
    dev = torch.device(DEVICE)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    a, w, a2, w2 = rand(B * L, 9 * C), rand(9 * C, C), rand(B * L, C), \
        rand(C, C)
    ms = time_ms(lambda: (a @ w, a @ w, a2 @ w2))
    flops = 2 * B * L * C * C * 19
    print(f"# GEMM yardstick (equal FLOPs, not the function; the port "
          f"never calls it): torch.matmul (B*L, 9C)@(9C, C) x2 + (B*L, "
          f"C)@(C, C), bf16, B=8 L=C=1024: {ms:.4f} ms, "
          f"{flops / ms / 1e9:.1f} TFLOP/s [{card}]")


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
            if dtype == torch.bfloat16 and L == 512:
                print_passes(card, "local_track bf16 B=8 L=512 C=512",
                             lambda: fused_local_track(track, x, bc, 1,
                                                       cfg.wide_dilation))

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
                      + B * L)
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
            if dtype == torch.bfloat16 and L == 512:
                print_passes(card, "global_attention bf16 B=8 L=512 C=G=512 "
                                   "H=8 dense",
                             lambda: fused_global_attention(attn, x, g, pad),
                             K2_PASSES)

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
                      * s + B * L * seg.element_size())
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
            if dtype == torch.bfloat16 and L == 512:
                print_passes(card, "global_attention bf16 B=8 L=512 C=G=512 "
                                   "H=8 S=8",
                             lambda: fused_packed_attention(attn, x, gs, seg),
                             K2_PASSES)

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


def base_phase(card: str) -> None:
    """`--phase base` (also `--phase k2`): the base-width kernels at the
    kernel table's shapes, bf16 under inference mode as served — K1 (B=8,
    L=C=512), K1's prehaloed entry (B=16, L=512+2*20, C=512), #3 (B=8,
    L=C=512, S=8), #3-int8 and K2-int8 beside their fp legs, and K2 at
    base (B=8 L=512 C=G=512 H=8) and Large (B=8 L=1024 C=G=1024 H=16)
    width, dense and S=8: each call's wall ms (median of 25 CUDA-event
    timings), host enqueue time and device ms by pass. It uses only the
    entries' public wrappers, so the same script times the parent commit's
    package in the same call (copy it into a checkout of the parent)."""
    import torch.nn.functional as F

    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        TRACK_PARAMS, dequant_params, fused_global_attention,
        fused_local_track, fused_local_track_segments,
        fused_local_track_valid, fused_packed_attention, track_halo,
    )
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )
    from proteinbert_tpu_torch.parallel.quant import quantize_params

    dev = torch.device(DEVICE)

    def timed(label, fn, passes=K2_PASSES):
        print_timed(card, "base", label, fn, passes)

    for name, L in (("base", 512), ("large", 1024)):
        cfg = get_preset(name).model
        gen = torch.Generator().manual_seed(5)
        blk = to_device(block_init(gen, cfg), dev)
        cast = cast_block(blk, torch.bfloat16)
        attn = cast["attention"]
        B, C, G, S = 8, cfg.local_dim, cfg.global_dim, 8
        x = torch.randn((B, L, C), generator=gen).to(dev, torch.bfloat16)
        g = torch.randn((B, G), generator=gen).to(dev, torch.bfloat16)
        gs = torch.randn((B, S, G), generator=gen).to(dev, torch.bfloat16)
        pad = torch.ones((B, L), dtype=torch.bool, device=dev)
        pad[1, L // 2:] = False
        seg = torch.randint(0, S + 1, (B, L), generator=gen).to(dev)
        with torch.inference_mode():
            timed(f"K2 {name} dense B=8 L={L}",
                  lambda: fused_global_attention(attn, x, g, pad))
            timed(f"K2 {name} S=8 B=8 L={L}",
                  lambda: fused_packed_attention(attn, x, gs, seg))
            if name != "base":
                continue
            wd = cfg.wide_dilation
            track = {n: cast[n] for n in TRACK_PARAMS}
            bc = torch.randn((B, C), generator=gen).to(dev, torch.bfloat16)
            bs = torch.randn((B, S, C), generator=gen).to(dev, torch.bfloat16)
            timed("K1 base dense B=8 L=512",
                  lambda: fused_local_track(track, x, bc, 1, wd),
                  TRACK_PASSES)
            H = track_halo(track, 1, wd)
            xh = F.pad(torch.randn((16, L, C), generator=gen),
                       (0, 0, H, H)).to(dev, torch.bfloat16)
            bh = torch.randn((16, C), generator=gen).to(dev, torch.bfloat16)
            timed(f"K1 prehaloed base B=16 L=512+2*{H}",
                  lambda: fused_local_track_valid(track, xh, bh, 1, wd),
                  TRACK_PASSES)
            timed("#3 base S=8 B=8 L=512",
                  lambda: fused_local_track_segments(track, x, bs, seg, 1,
                                                     wd), TRACK_PASSES)
            q = cast_block(quantize_params(blk), torch.bfloat16)
            qa, fa = q["attention"], dequant_params(q["attention"])
            timed("K2-int8 base dense",
                  lambda: fused_global_attention(qa, x, g, pad))
            timed("K2-int8 fp leg base dense",
                  lambda: fused_global_attention(fa, x, g, pad))
            timed("K2-int8 base S=8",
                  lambda: fused_packed_attention(qa, x, gs, seg))
            timed("K2-int8 fp leg base S=8",
                  lambda: fused_packed_attention(fa, x, gs, seg))
            qt = {n: q[n] for n in TRACK_PARAMS}
            ft = dequant_params(qt)
            timed("#3-int8 base S=8", lambda: fused_local_track_segments(
                qt, x, bs, seg, 1, wd), TRACK_PASSES)
            timed("#3-int8 fp leg base S=8",
                  lambda: fused_local_track_segments(ft, x, bs, seg, 1, wd),
                  TRACK_PASSES)


def default_phase(card: str) -> None:
    """`--phase default`: #6 and #6-int8 in bf16 under inference mode as
    served, at the ModelConfig default width (B=8, C=128, G=512, H=4,
    v=128) at L=512 and L=128, dense and S=8, and at C=512, H=4, L=128,
    S=8 (the kernel table's shapes): each call's wall ms (median of 25
    CUDA-event timings), host enqueue time and device ms by pass, and
    beside it the composition the one-pass rule chooses against on the
    same inputs (K1 or #3, then K2, or their int8 legs). Then where #6
    runs six times: one full ragged 8 x 512 embed batch of a default-width
    server on the fp32 and the int8 arm, and a default-width packed train
    step (B=8, L=512), each through torch.profiler (`# profile` lines:
    wall and device busy). It uses only the package's public entries, so
    it also times the parent commit's package."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        ONEPASS, TRACK_PARAMS, fused_global_attention, fused_local_track,
        fused_local_track_segments, fused_onepass_dense,
        fused_onepass_segments, fused_packed_attention,
    )
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, init, to_device,
    )
    from proteinbert_tpu_torch.parallel.quant import quantize_params
    from proteinbert_tpu_torch.serve.server import Server

    dev = torch.device(DEVICE)
    base = get_preset("base").model
    wd = base.wide_dilation
    gen = torch.Generator().manual_seed(13)
    B, S = 8, 8
    for C, G, H, lengths in ((128, 512, 4, (512, 128)), (512, 512, 4, (128,))):
        cfg = dataclasses.replace(base, local_dim=C, global_dim=G,
                                  num_heads=H)
        blk = to_device(block_init(gen, cfg), dev)
        cast = cast_block(blk, torch.bfloat16)
        q = cast_block(quantize_params(blk), torch.bfloat16)
        legs = {"": ({n: cast[n] for n in TRACK_PARAMS}, cast["attention"]),
                "-int8": ({n: q[n] for n in TRACK_PARAMS}, q["attention"])}
        for L in lengths:
            x = torch.randn((B, L, C), generator=gen).to(dev, torch.bfloat16)
            bc = torch.randn((B, C), generator=gen).to(dev, torch.bfloat16)
            bs = torch.randn((B, S, C), generator=gen).to(dev, torch.bfloat16)
            g = torch.randn((B, G), generator=gen).to(dev, torch.bfloat16)
            gs = torch.randn((B, S, G), generator=gen).to(dev,
                                                          torch.bfloat16)
            seg = packed_ids(gen, B, L, S).to(dev)
            real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
            pad = torch.ones((B, L), dtype=torch.bool, device=dev)
            pad[1, L // 2:] = False
            cases = (("S=8", lambda t, a: fused_onepass_segments(
                          t, a, x, bs, gs, seg, real, 1, wd),
                      lambda t, a: fused_packed_attention(
                          a, fused_local_track_segments(t, x, bs, seg, 1, wd),
                          gs, seg, real)),
                     ("dense", lambda t, a: fused_onepass_dense(
                          t, a, x, bc, g, pad, 1, wd),
                      lambda t, a: fused_global_attention(
                          a, fused_local_track(t, x, bc, 1, wd), g, pad)))
            for case, onepass, composed in cases:
                if C == 512 and case == "dense":
                    continue
                shape = f"B=8 L={L} C={C} G={G} H={H} {case}"
                for leg, (track, attn) in legs.items():
                    with torch.inference_mode():
                        print_timed(card, "default", f"#6{leg} {shape}",
                                    lambda: onepass(track, attn),
                                    ONEPASS_PASSES)
                        print_timed(card, "default",
                                    f"composition{leg} {shape}",
                                    lambda: composed(track, attn),
                                    TRACK_PASSES + K2_PASSES)

    cfg = get_preset("base").replace(model=ModelConfig())
    for quant in ("fp32", "int8"):
        srv = Server(init(cfg.model, torch.Generator().manual_seed(0),
                          device=DEVICE), cfg, device=DEVICE,
                     buckets=BUCKETS, max_batch=8, serve_mode="ragged",
                     pack_max_segments=8, quant=quant, quant_parity_every=0)
        packed = full_ragged_batch(srv)
        profile_batch(card, f"default width ragged {quant}, one packed embed "
                            "batch 8x512 (24 segments)",
                      lambda: srv.dispatcher.run_packed("embed", *packed))
        check(srv.drain(timeout=300), "drain timed out")
        del srv
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=8, seq_len=512,
                                 packing=True, pack_max_segments=8),
        train=dataclasses.replace(cfg.train, max_steps=2, log_every=1,
                                  eval_every=0))
    out, _, _, _, batch, _ = train_run(card, "default width packed", cfg, 2,
                                       {ONEPASS.name: 6}, (50, 250), 1)
    profile_step(card, "train default width packed, one step B=8 L=512",
                 out["state"], batch, cfg)


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
    """`packed_ids`, with row 0 laid over #4's tile edges: boundaries
    beside (62) and on (64) the bf16 finish pass's 64-row edge and the
    float32 conv pass's 64-row tile edge, one inside a 32-row finish tile
    (80), a boundary on the bf16 conv pass's 128-row tile edge (128) with
    boundaries beside it (126, 131), a segment that starts inside the next
    tile's 20-row halo (141, after a pad gap), and an id above S; each
    clipped to L."""
    seg = packed_ids(gen, B, L, S)
    row = torch.zeros(L, dtype=torch.int32)
    for sid, (a, b) in enumerate(((0, 62), (62, 64), (64, 80), (80, 126),
                                  (126, 128), (128, 131), (131, 138),
                                  (141, 190)), start=1):
        row[min(a, L):min(b, L)] = sid
    row[min(190, L):min(200, L)] = S + 2
    row[min(200, L):min(256, L)] = 1   # far from segment 1's first run
    seg[0] = row
    return seg


TILE_EDGE_SIDS = (2, 3, 4, 5, 6)   # row 0's segments on and beside the edges


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
                if dtype == torch.bfloat16 and L == 512:
                    print_passes(card, "local_track_segments bf16 B=8 L=512 "
                                       "C=512 S=8", lambda: run(x))
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
                        if dtype == torch.bfloat16 and L == 512:
                            print_passes(card, f"one_pass bf16 B=8 L=512 "
                                               f"C=128 {case}",
                                         lambda: run(x), ONEPASS_PASSES)
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
                if L == 1024:
                    print_passes(card, f"local_track_tiled {str(dtype)[6:]} "
                                       "B=8 L=C=1024",
                                 lambda: fused_local_track(track, x, bc, 1,
                                                           wd))
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
            for sid in TILE_EDGE_SIDS:
                if not bool((seg == sid).any()):   # clipped away at L=100
                    continue
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
                if L == 1024:
                    print_passes(card, f"local_track_segments_tiled "
                                       f"{str(dtype)[6:]} B=8 L=C=1024 S=8",
                                 lambda: run(x))
            rows[("local_track_segments_tiled", dtype, L, "S=8")] = (
                (err,) + timing)

        # #2 and #4 at the other ends of their widths, bf16: C=640 (a last
        # 128-column round of the finish pass's 256-column rounds) and
        # C=2048 (32-row finish tiles), B=2, L=200.
        for Cw in ((640, 2048) if dtype == torch.bfloat16 else ()):
            wide = cast_block(to_device(block_init(
                gen, dataclasses.replace(large, local_dim=Cw)), dev), dtype)
            tw = {name: wide[name] for name in TRACK_PARAMS}
            x = torch.randn((2, 200, Cw), generator=gen).to(dev, dtype)
            bc = torch.randn((2, Cw), generator=gen).to(dev, dtype)
            bs = torch.randn((2, S, Cw), generator=gen).to(dev, dtype)
            seg = tiled_ids(gen, 2, 200, S).to(dev)
            for name, got, want in (
                    ("local_track_tiled", fused_local_track(tw, x, bc, 1, wd),
                     local_track_reference(tw, x, bc, 1, wd)),
                    ("local_track_segments_tiled",
                     fused_local_track_segments(tw, x, bs, seg, 1, wd),
                     local_track_segment_oh_reference(
                         tw, x, bs, segment_one_hot(seg, S), 1, wd))):
                torch.cuda.synchronize()
                check(torch.isfinite(got).all().item(), f"{name} C={Cw} "
                                                        "non-finite")
                rows[(name, dtype, 200, f"C={Cw}")] = (
                    (got.float() - want.float()).abs().max().item(),
                    None, None, None, None, None)
            del wide, tw

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
                  + B * L * (seg.element_size() + 1))
        b_ms, b_by = bound(attention_flops(B, L, C, G, S, H, k), nbytes, dtype)
        per_call = launches(ATTENTION, lambda: fused_packed_attention(
            attn, x, gs, seg, real))
        rows[("global_attention", dtype, L, "Large S=8")] = (
            (got.float() - want.float()).abs().max().item(),
            time_ms(lambda: fused_packed_attention(attn, x, gs, seg, real)),
            time_ms(lambda: attention_oh_reference(attn, x, gs, oh)),
            b_ms, b_by, per_call)
        if dtype == torch.bfloat16:
            print_passes(card, "global_attention bf16 B=8 L=C=G=1024 H=16 S=8",
                         lambda: fused_packed_attention(attn, x, gs, seg,
                                                        real), K2_PASSES)

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
                  + B * L)
        b_ms, b_by = bound(attention_flops(B, L, C, G, 1, H, k), nbytes, dtype)
        per_call = launches(ATTENTION, lambda: fused_global_attention(
            attn, x, g, pad))
        rows[("global_attention", dtype, L, "Large")] = (
            err, time_ms(lambda: fused_global_attention(attn, x, g, pad)),
            time_ms(lambda: attention_oh_reference(attn, x, g[:, None, :], oh,
                                                   zero_empty=False)),
            b_ms, b_by, per_call)
        if dtype == torch.bfloat16:
            print_passes(card, "global_attention bf16 B=8 L=C=G=1024 H=16 "
                               "dense",
                         lambda: fused_global_attention(attn, x, g, pad),
                         K2_PASSES)

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
                print_passes(card, f"{kernel.name} bf16 B={B} "
                                   f"L={Ls}+2*{H} C={C}",
                             lambda: fused_local_track_valid(
                                 track, xh, bc, 1, wd))
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
            if timed and dtype == torch.bfloat16:
                print_passes(card, "local_track_segments_q8 bf16 B=8 L=512 "
                                   "C=512 S=8",
                             lambda: fused_local_track_segments(
                                 qt, x, bs, seg, 1, wd))
                print_passes(card, "local_track_segments (its fp leg) bf16 "
                                   "B=8 L=512 C=512 S=8",
                             lambda: fused_local_track_segments(
                                 ft, x, bs, seg, 1, wd))
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
                 (B * L * C + 2 * B * G) * s + abytes + B * L)
            gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
            case(ATTENTION_Q8, dtype, L, "S=8",
                 lambda: fused_packed_attention(qa, x, gs, seg),
                 lambda: fused_packed_attention(fa, x, gs, seg),
                 lambda: attention_oh_reference(fa, x, gs, oh),
                 timed, attention_flops(B, L, C, G, S, H, k),
                 (B * L * C + 2 * B * S * G) * s + abytes
                 + B * L * seg.element_size(),
                 empty=lambda out: out[0][:, S - 1])
            if timed and dtype == torch.bfloat16:
                for label, q_run, f_run in (
                        ("dense", lambda: fused_global_attention(qa, x, g, pad),
                         lambda: fused_global_attention(fa, x, g, pad)),
                        ("S=8", lambda: fused_packed_attention(qa, x, gs, seg),
                         lambda: fused_packed_attention(fa, x, gs, seg))):
                    print_passes(card, f"global_attention_q8 bf16 B=8 L=512 "
                                       f"C=G=512 H=8 {label}", q_run,
                                 K2_PASSES)
                    print_passes(card, f"global_attention (its fp leg) bf16 "
                                       f"B=8 L=512 C=G=512 H=8 {label}",
                                 f_run, K2_PASSES)

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

    # K2-int8 at Large width (C=G=1024, H=16, k=64), bf16: the int8 arm at
    # Large runs it (`large_int8_phase`), dense and packed.
    large = get_preset("large").model
    dtype, L = torch.bfloat16, 1024
    qt, qa, ft, fa, (tbytes, abytes) = q8_block(gen, large, dtype)
    C, G, H = large.local_dim, large.global_dim, large.num_heads
    x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
    g = torch.randn((B, G), generator=gen).to(dev, dtype)
    gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
    pad = pad_rows(L)
    seg = ids(L)
    oh = segment_one_hot(seg, S)
    case(ATTENTION_Q8, dtype, L, "Large dense",
         lambda: fused_global_attention(qa, x, g, pad),
         lambda: fused_global_attention(fa, x, g, pad),
         lambda: attention_oh_reference(
             fa, x, g[:, None, :], pad[..., None].float(),
             zero_empty=False).reshape(B, G),
         True, attention_flops(B, L, C, G, 1, H, k),
         (B * L * C + 2 * B * G) * 2 + abytes + B * L)
    case(ATTENTION_Q8, dtype, L, "Large S=8",
         lambda: fused_packed_attention(qa, x, gs, seg),
         lambda: fused_packed_attention(fa, x, gs, seg),
         lambda: attention_oh_reference(fa, x, gs, oh),
         True, attention_flops(B, L, C, G, S, H, k),
         (B * L * C + 2 * B * S * G) * 2 + abytes
         + B * L * seg.element_size(),
         empty=lambda out: out[0][:, S - 1])
    for label, q_run, f_run in (
            ("dense", lambda: fused_global_attention(qa, x, g, pad),
             lambda: fused_global_attention(fa, x, g, pad)),
            ("S=8", lambda: fused_packed_attention(qa, x, gs, seg),
             lambda: fused_packed_attention(fa, x, gs, seg))):
        print_passes(card, f"global_attention_q8 bf16 B=8 L=1024 C=G=1024 "
                           f"H=16 {label}", q_run, K2_PASSES)
        print_passes(card, f"global_attention (its fp leg) bf16 B=8 L=1024 "
                           f"C=G=1024 H=16 {label}", f_run, K2_PASSES)

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
              residues: tuple, seed: int, seq_group=None, source=None,
              telemetry=None):
    """`pretrain()` for `steps` steps with every kernel count at 0: the
    launches of each step (exactly per_step[name], 0 for a kernel not
    named), finite losses, params moved by step 2. `source` (a callable
    returning a fresh batch iterator) feeds it when given, else
    `cfg.data.packing` picks `make_packed_iterator` (cfg.data.
    pack_max_segments a row) or `make_pretrain_iterator` over synthetic
    proteins; `seq_group` trains sequence-parallel over that group. The
    batches come through pretrain's prefetch thread when
    cfg.data.prefetch_depth > 0. Returns (the out dict, per-step wall ms,
    launches, peak bytes, a clean batch, the batches it trained on)."""
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
    if source is not None:
        batches = source
    else:
        seqs, ann = synthetic_proteins((40 if packed else 4) * B, *residues,
                                       cfg.model.num_annotations, seed)
        ds = InMemoryPretrainingDataset(seqs, ann, L)

        def batches():
            if packed:
                return make_packed_iterator(
                    ds, B, seed=seed,
                    max_segments=cfg.data.pack_max_segments)
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
                   device=DEVICE, seq_group=seq_group, telemetry=telemetry)
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
    # The prefetch thread may have made batches past the last step.
    return out, walls, total, peak, batch, trained[:steps]


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


def train_preset(name, B, L, steps, packed=False, model=None):
    """A preset at batch B, length L, `steps` steps logged every step, no
    eval (packed: 8 segments a row)."""
    from proteinbert_tpu_torch.configs import get_preset

    p = get_preset(name)
    return p.replace(
        model=model or p.model,
        data=dataclasses.replace(p.data, batch_size=B, seq_len=L,
                                 packing=packed, pack_max_segments=8),
        train=dataclasses.replace(p.train, max_steps=steps, log_every=1,
                                  eval_every=0))


def train_phases(card: str) -> dict:
    """The trained paths: Large dense (#2 + K2) and packed (#4 + K2), each
    printed beside the same step with the float32 backward, base dense (K1 + K2) and packed (#3 + K2), the default width
    packed (#6); then sequence-parallel over a one-rank NCCL group: the
    `long` preset (K1's prehaloed entry) and Large (#2's); returns each
    kernel's launches summed over the runs."""
    from proteinbert_tpu_torch.configs import ModelConfig
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED,
        LOCAL_TRACK_TILED_VALID, LOCAL_TRACK_VALID, ONEPASS,
    )
    from proteinbert_tpu_torch.train.metrics import peak_flops
    from proteinbert_tpu_torch.train.schedule import tree_leaves

    totals = {}

    def add(launches):
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n

    for packed, kernel, residues in (
            (False, LOCAL_TRACK_TILED, (100, 1022)),
            (True, LOCAL_TRACK_SEGMENTS_TILED, (50, 500))):
        label = "large packed" if packed else "large"
        large = train_preset("large", 8, 1024, 6, packed)
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
              f"{perf['step_ms']:.1f} ms/step, {perf['residues_per_sec_per_chip']:.0f} "
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
            ("base", train_preset("base", 8, 512, 2),
             {LOCAL_TRACK.name: 6, ATTENTION.name: 6}, (100, 510)),
            ("base packed", train_preset("base", 8, 512, 2, True),
             {LOCAL_TRACK_SEGMENTS.name: 6, ATTENTION.name: 6}, (50, 250)),
            ("default width packed",
             train_preset("base", 8, 512, 2, True, default),
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
        long_cfg = train_preset("long", 4, 2048, 6)
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
              f"{perf['step_ms']:.1f} ms/step, {perf['residues_per_sec_per_chip']:.0f} "
              f"tokens/s (B*L positions), MFU "
              f"{perf.get('mfu', float('nan')):.4f}; max_memory_allocated "
              f"{peak / 1e9:.2f} GB")
        profile_step(card, "train long seq, one step B=4 L=2048",
                     out["state"], batch, long_cfg, seq_group=group)
        large_seq = train_preset("large", 8, 1024, 2)
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


# ------------------------------------------------------------ resume

def resume_run(label: str, cfg, fac, per_step: dict, ckpt=None,
               tele=None, on_log=None):
    """`pretrain()` on the iterator factory `fac`, fresh from the config's
    seed or restored from `ckpt`'s newest step, with every kernel count at
    0: exactly per_step[name] launches of each kernel a step (0 for a
    kernel not named) and finite losses. `on_log(step)` runs in log_fn
    before the step's mark is taken (a SIGTERM, a wait). Returns (out,
    {step: loss}, {step: wall ms since the previous mark}, seconds from
    the last mark to the return, the run's launches)."""
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.train.trainer import pretrain

    marks = []

    def log_fn(step, m):
        if on_log is not None:
            on_log(step)
        marks.append((step, time.perf_counter(), m["loss"],
                      {k.name: k.launches for k in KERNELS}))

    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = pretrain(cfg, fac, checkpointer=ckpt, log_fn=log_fn,
                   telemetry=tele, device=DEVICE)
    t_end = time.perf_counter()
    launches = {k.name: k.launches for k in KERNELS}
    prev_t, prev_n = t0, {k.name: 0 for k in KERNELS}
    losses, walls = {}, {}
    for step, t, loss, counts in marks:
        check(np.isfinite(loss), f"{label}: step {step} loss {loss}")
        for name, n in counts.items():
            got = n - prev_n[name]
            check(got == per_step.get(name, 0),
                  f"{label}: step {step} launched {name} {got} times, want "
                  f"{per_step.get(name, 0)}")
        losses[step] = loss
        walls[step] = (t - prev_t) * 1e3
        prev_t, prev_n = t, counts
    return out, losses, walls, t_end - prev_t, launches


def read_state(directory: str, step: int) -> dict:
    """The host tree of a checkpoint step, as `train.Checkpointer` wrote
    it (`train.checkpoint.state_tree`'s layout)."""
    from proteinbert_tpu_torch.train.checkpoint import STATE_FILE

    return torch.load(os.path.join(directory, str(step), STATE_FILE),
                      map_location="cpu", weights_only=True)


def host_state(state) -> dict:
    """A TrainState as the host tree a checkpoint of it holds."""
    from proteinbert_tpu_torch.train.checkpoint import state_tree

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [put(v) for v in x]
        return x.to("cpu", copy=True) if torch.is_tensor(x) else x

    return put(state_tree(state))


def tree_tensors(tree) -> list:
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def trees_equal(x, y) -> bool:
    """Two host trees bit for bit: structure, scalars, dtypes, values."""
    if isinstance(x, dict):
        return (isinstance(y, dict) and x.keys() == y.keys()
                and all(trees_equal(x[k], y[k]) for k in x))
    if isinstance(x, (list, tuple)):
        return (isinstance(y, (list, tuple)) and len(x) == len(y)
                and all(trees_equal(a, b) for a, b in zip(x, y)))
    if torch.is_tensor(x):
        return (torch.is_tensor(y) and x.dtype == y.dtype
                and torch.equal(x, y))
    return x == y


def state_drift(x: dict, y: dict, base: dict) -> float:
    """How far a checkpoint tree x lies from y, a tree of the same step from
    another run: the largest of ||x - y|| / ||y - base|| over the params
    (the update since `base`, the params both runs started from),
    ||x - y|| / ||y|| over each Adam moment, and |x - y| / max(1, |y|)
    over the plateau's two loss averages; inf where the step, the Adam
    count, the generator state or the plateau's counters and scale
    differ. 0.0 for trees bit for bit equal."""
    ox, oy = x["opt_state"], y["opt_state"]
    px, py = ox["plateau"] or {}, oy["plateau"] or {}
    losses = ("best_value", "avg_value")
    if (x["step"] != y["step"] or ox["count"] != oy["count"]
            or not torch.equal(x["generator"], y["generator"])
            or px.keys() != py.keys()
            or not all(torch.equal(px[k], py[k]) for k in px
                       if k not in losses)):
        return float("inf")

    def sq(ts):
        return sum(float(torch.linalg.vector_norm(t.float())) ** 2
                   for t in ts)

    def rel(xs, ys, zero):
        num = sq([a - b for a, b in zip(xs, ys, strict=True)])
        den = sq([b - z for b, z in zip(ys, zero, strict=True)])
        return 0.0 if num == 0 else (num / den) ** 0.5 if den else \
            float("inf")

    px_l, py_l = tree_tensors(x["params"]), tree_tensors(y["params"])
    drifts = [rel(px_l, py_l, tree_tensors(base))]
    for k in ("mu", "nu"):
        ys = tree_tensors(oy[k])
        drifts.append(rel(tree_tensors(ox[k]), ys,
                          [torch.zeros_like(t) for t in ys]))
    drifts += [abs(float(px[k]) - float(py[k])) / max(1.0, abs(float(py[k])))
               for k in losses if k in px]
    return max(drifts)


def staged_ordering_check(state, directory: str) -> str:
    """The staged save's device ordering, on `state` (modified in place):
    two stages back to back, each snapshot queued on the train stream
    behind ~1 s of `torch.cuda._sleep` (the step before the boundary still
    running) and followed at once by an in-place update of every param
    and moment (the next step). The saver thread holds stage 1 back 3 s
    before its copy to the host, and stage 2 not at all. S0 being the
    state before, stage 1 must hold -S0 and stage 2 -2 S0, bit for bit: a
    side stream that did not wait for the snapshot's event copies stage
    2's buffer before the snapshot lands (stage 2 holds -S0), a snapshot
    off the train stream races the update, and a second snapshot that did
    not wait for the first stage to land overwrites the buffer under it
    (stage 1 holds -2 S0). Returns a line for the log."""
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.schedule import tree_leaves

    class Held(Checkpointer):
        holds = [3.0, 0.0]

        def _snapshot(self, st):
            torch.cuda._sleep(SLEEP_CYCLES)
            return super()._snapshot(st)

        def _stage_fetch(self, snapshot):
            time.sleep(self.holds.pop(0))
            return super()._stage_fetch(snapshot)

    def moved(tree):                            # params and moments
        o = tree["opt_state"]
        return tree_tensors([tree["params"], o["mu"], o["nu"]])

    leaves = (tree_leaves(state.params) + state.opt_state.mu
              + state.opt_state.nu)
    s0 = moved(host_state(state))
    ck = Held(directory, max_to_keep=2)
    t0 = time.perf_counter()
    torch._foreach_neg_(leaves)                 # the boundary: -S0
    ck.save_staged(1, state)
    torch._foreach_mul_(leaves, 2.0)            # the next update: -2 S0
    ck.save_staged(2, state)
    torch._foreach_neg_(leaves)                 # the next update: 2 S0
    ck.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held = []
    for step, factor in ((1, -1.0), (2, -2.0)):
        tree = read_state(directory, step)
        got = moved(tree)
        held.append(all(torch.equal(g, w * factor)
                        for g, w in zip(got, s0, strict=True)))
        del tree, got
    check(held == [True, True],
          f"staged ordering: stage 1 holds -S0 {held[0]}, stage 2 holds "
          f"-2 S0 {held[1]}: a staged snapshot is torn")
    return (f"staged ordering held ({len(leaves)} tensors, two stages "
            f"behind ~1 s of train-stream work each, stage 1's host copy "
            f"held back 3 s; {wall:.1f} s)")


def sigterm_at(kill: int):
    """An on_log hook sending this process SIGTERM at step `kill`."""
    def on_log(step):
        if step == kill:
            os.kill(os.getpid(), signal.SIGTERM)
    return on_log


def timed_checkpointer(directory: str, **kw):
    """A Checkpointer that records, in `.times`, the seconds its copies to
    the host of staged snapshots (`_stage_fetch`, the first one pinning
    its buffers) and its writes (`_write_step`, fsync included) take."""
    from proteinbert_tpu_torch.train import Checkpointer

    class Timed(Checkpointer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.times = []

        def _stage_fetch(self, snapshot):
            t0 = time.perf_counter()
            out = super()._stage_fetch(snapshot)
            self.times.append(("host copy", time.perf_counter() - t0))
            return out

        def _write_step(self, step, host_tree, data_state):
            t0 = time.perf_counter()
            super()._write_step(step, host_tree, data_state)
            self.times.append((f"write {step}", time.perf_counter() - t0))

    return Timed(directory, **kw)


def span_ms(tele, name: str) -> list:
    """Durations (ms) of the host spans `name` a Telemetry(spans=True)
    collected."""
    return [e["dur"] / 1e3 for e in tele.spans.to_perfetto()["traceEvents"]
            if e.get("name") == name]


def resume_phase(card: str) -> dict:
    """A pretraining run that survives on the card, through `pretrain` and
    `train.Checkpointer`, for `large` dense at full width and depth (B=8,
    L=1024, 6 steps, saves every 3, SIGTERM at step 4; #2 + K2) and `base`
    packed (B=8, L=512, 8 segments a row, 4 steps, saves every 2, SIGTERM
    at step 2; #3 + K2, the packed iterator's skip_batches replay), each
    at the preset's peak learning rate from step 1 (no warmup):
    a. an uninterrupted run with synchronous saves (max_to_keep 2);
    b. the same run with staged saves, sent SIGTERM from log_fn: it must
       return preempted with the newest step at the kill;
    c. a fresh state and a new Checkpointer resume b to the end;
    e. c again with the Adam moments zeroed on restore (a planted fault);
    d. (Large only) 7 steps with staged saves at 3 and 6, log_fn waiting at
       step 5 for the first stage to land, so step 7 holds a steady-state
       staged boundary (buffers made, no stage in flight before it); then
       `staged_ordering_check` on its final state.
    Gates: the state restored from b's newest step is b's final state bit
    for bit; c's staged save at its last step is c's final state bit for
    bit; b's staged save at the first boundary and c's final state lie
    within RESUME_STATE_TOL of a's (`state_drift`) and e's final state
    beyond it; c's losses are finite and within RESUME_LOSS_TOL of a's
    (bit-equality of the losses and states is printed); exact launch
    counts a step in every run; the event stream of b and c validates.
    Prints the boundary's cost at
    Large (not a gate): the wall of the step holding a synchronous save
    (a), the first staged save (b) and a steady one (d) against their
    runs' median step, the boundary's time on the train thread (its span),
    the saver thread's copy to the host and write seconds, the stages'
    seconds until they landed, the preemption save's and the restore's
    seconds, and the checkpoint's bytes. The checkpoints live in a
    temporary directory under build/, removed at the end; a disk that
    cannot hold three of them fails the phase. Returns each kernel's
    launches summed over the runs."""
    from proteinbert_tpu_torch.data.dataset import (
        InMemoryPretrainingDataset, make_pretrain_iterator,
    )
    from proteinbert_tpu_torch.data.packing import make_packed_iterator
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK_SEGMENTS, LOCAL_TRACK_TILED,
    )
    from proteinbert_tpu_torch.obs import Telemetry, read_events
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.checkpoint import STATE_FILE
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.train_state import create_train_state

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="resume-", dir=build)
    totals = {}
    try:
        for (label, name, B, L, steps, every, kill, packed, per_step,
             residues, seed) in (
                ("large", "large", 8, 1024, 6, 3, 4, False,
                 {LOCAL_TRACK_TILED.name: 12, ATTENTION.name: 12},
                 (100, 1022), 0),
                ("base packed", "base", 8, 512, 4, 2, 2, True,
                 {LOCAL_TRACK_SEGMENTS.name: 6, ATTENTION.name: 6},
                 (50, 250), 1)):
            # The peak learning rate from step 1 (warmup 0, the plateau
            # kept): the steps move the params, the Adam moments and the
            # loss, so the gates see the optimizer state.
            cfg = train_preset(name, B, L, steps, packed)
            cfg = cfg.replace(optimizer=dataclasses.replace(
                cfg.optimizer, warmup_steps=0))
            sync_cfg, staged_cfg = (cfg.replace(checkpoint=dataclasses.replace(
                cfg.checkpoint, every_steps=every, overlap=o))
                for o in (False, True))
            seqs, ann = synthetic_proteins((40 if packed else 4) * B,
                                           *residues,
                                           cfg.model.num_annotations, seed)
            ds = InMemoryPretrainingDataset(seqs, ann, L)

            def fac(skip, ds=ds, B=B, packed=packed, seed=seed):
                if packed:
                    return make_packed_iterator(ds, B, seed=seed,
                                                max_segments=8,
                                                skip_batches=skip)
                return make_pretrain_iterator(ds, B, seed=seed,
                                              skip_batches=skip)

            tag = label.replace(" ", "_")
            ck = timed_checkpointer(os.path.join(root, f"{tag}-a"),
                                    max_to_keep=2, async_save=False)
            out, loss_a, wall_a, _, n = resume_run(
                f"resume {label} a", sync_cfg, fac, per_step, ckpt=ck)
            ck.close()
            times_a = dict(ck.times)
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            check(ck.all_steps() == [every, steps],
                  f"resume {label} a: steps {ck.all_steps()}")
            st = out["state"]
            leaves = (tree_leaves(st.params) + st.opt_state.mu
                      + st.opt_state.nu)
            state_bytes = sum(t.numel() * t.element_size() for t in leaves)
            file_bytes = os.path.getsize(os.path.join(
                ck.directory, str(steps), STATE_FILE))
            # a's synchronous checkpoints, held against b's and c's staged
            # ones of the same steps.
            a_every = read_state(ck.directory, every)
            a_final = read_state(ck.directory, steps)
            del leaves, ck
            shutil.rmtree(os.path.join(root, f"{tag}-a"))
            free = shutil.disk_usage(root).free
            check(free >= 3 * file_bytes,
                  f"resume {label}: {free} bytes free under {root}, the "
                  f"phase needs three checkpoints of {file_bytes} bytes")
            del out, st
            gc.collect()
            torch.cuda.empty_cache()

            events = os.path.join(root, f"{tag}-events.jsonl")
            tele = Telemetry(events_path=events, flight_dir=root, spans=True)
            ck = timed_checkpointer(os.path.join(root, f"{tag}-b"),
                                    max_to_keep=2)
            out_b, loss_b, wall_b, preempt_s, n = resume_run(
                f"resume {label} b", staged_cfg, fac, per_step, ckpt=ck,
                tele=tele, on_log=sigterm_at(kill))
            ck.close()
            times_b = ck.times
            span_b = span_ms(tele, "ckpt_boundary_staged")
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            check(out_b["preempted"] and ck.latest_step() == kill
                  and sorted(loss_b) == list(range(1, kill + 1)),
                  f"resume {label} b: preempted {out_b['preempted']}, "
                  f"newest step {ck.latest_step()}, want {kill}")
            del ck
            gc.collect()
            torch.cuda.empty_cache()

            template = create_train_state(
                torch.Generator().manual_seed(cfg.train.seed), cfg,
                device=DEVICE)
            ck = Checkpointer(os.path.join(root, f"{tag}-b"))
            t0 = time.perf_counter()
            restored, data = ck.restore(template)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            ck.close()
            restored_host = host_state(restored)
            held = trees_equal(restored_host, host_state(out_b["state"]))
            check(held, f"resume {label}: the restored state is not the "
                        "saved one bit for bit")
            check(data == {"batches_consumed": kill},
                  f"resume {label}: data item {data}")
            # b's staged save at step `every` against a's synchronous one
            # (two runs: held within RESUME_STATE_TOL, bit-equality shown).
            init_params = host_state(template)["params"]
            kill_params = restored_host["params"]
            b_every = read_state(ck.directory, every)
            drift_b = state_drift(b_every, a_every, init_params)
            bit_b = trees_equal(b_every, a_every)
            check(drift_b <= RESUME_STATE_TOL,
                  f"resume {label}: b's staged checkpoint at step {every} "
                  f"lies {drift_b} from a's synchronous one > "
                  f"{RESUME_STATE_TOL}")
            del template, restored, restored_host, out_b, ck, b_every
            del a_every, init_params
            gc.collect()
            torch.cuda.empty_cache()

            ck = Checkpointer(os.path.join(root, f"{tag}-b"), max_to_keep=2)
            out_c, loss_c, _, _, n = resume_run(
                f"resume {label} c", staged_cfg, fac, per_step, ckpt=ck,
                tele=tele)
            ck.close()
            tele.close()
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            check(out_c["state"].step == steps and not out_c["preempted"]
                  and sorted(loss_c) == list(range(kill + 1, steps + 1)),
                  f"resume {label} c: ended at {out_c['state'].step}, "
                  f"steps {sorted(loss_c)}")
            # c's staged save at its last step is c's final state bit for
            # bit (one run); c's final state against a's (two runs).
            c_final = read_state(ck.directory, steps)
            check(trees_equal(c_final, host_state(out_c["state"])),
                  f"resume {label}: c's staged checkpoint at step {steps} "
                  "is not c's final state bit for bit")
            drift_c = state_drift(c_final, a_final, kill_params)
            bit_c = trees_equal(c_final, a_final)
            check(drift_c <= RESUME_STATE_TOL,
                  f"resume {label}: c's final state lies {drift_c} from "
                  f"a's > {RESUME_STATE_TOL}")
            del out_c, ck, c_final
            gc.collect()
            torch.cuda.empty_cache()

            # e. the gates' power: c again, from b's step `kill`, with a
            # planted fault, the Adam moments zeroed on restore. Nothing
            # is written (the directory holds step `steps` already).
            class ZeroMoments(Checkpointer):
                def restore(self, state_like, step=None, fallback=True):
                    st, data = super().restore(state_like, step=kill)
                    for t in st.opt_state.mu + st.opt_state.nu:
                        t.zero_()
                    return st, data

            ck = ZeroMoments(os.path.join(root, f"{tag}-b"), max_to_keep=2)
            out_e, loss_e, _, _, n = resume_run(
                f"resume {label} e", staged_cfg, fac, per_step, ckpt=ck)
            ck.close()
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            drift_e = state_drift(host_state(out_e["state"]), a_final,
                                  kill_params)
            check(drift_e > RESUME_STATE_TOL,
                  f"resume {label}: a resume with the Adam moments zeroed "
                  f"lies {drift_e} from a's final state, within "
                  f"{RESUME_STATE_TOL}: the gate cannot see the moments")
            del out_e, ck, a_final, kill_params
            shutil.rmtree(os.path.join(root, f"{tag}-b"))
            gc.collect()
            torch.cuda.empty_cache()

            def rel(x, y):
                return abs(x - y) / max(1.0, abs(y))

            worst = max(rel(loss_c[s], loss_a[s]) for s in loss_c)
            worst_e = max(rel(loss_e[s], loss_a[s]) for s in loss_e)
            check(worst <= RESUME_LOSS_TOL,
                  f"resume {label}: resumed losses {loss_c} against the "
                  f"uninterrupted {loss_a}: {worst} > {RESUME_LOSS_TOL}")
            bit = all(loss_c[s] == loss_a[s] for s in loss_c)
            before = max(rel(loss_b[s], loss_a[s]) for s in loss_b)
            recs = read_events(events, strict=True)
            kinds = {r["event"] for r in recs}
            check({"run_start", "step", "ckpt_stage", "requeue",
                   "run_end"} <= kinds, f"resume {label}: events {kinds}")
            outcomes = [r["outcome"] for r in recs if r["event"] == "run_end"]
            check(outcomes == ["preempted", "completed"],
                  f"resume {label}: run_end outcomes {outcomes}")
            landed = [r for r in recs if r["event"] == "ckpt_stage"
                      and r["phase"] == "landed"]

            def fmt(d):
                return ", ".join(f"{d[s]:.6f}" for s in sorted(d))

            print(f"# resume {label} [{card}]: B={B} L={L}, {steps} steps, "
                  f"saves every {every}; a uninterrupted (synchronous "
                  f"saves), b SIGTERM at step {kill} (staged saves), c "
                  f"resumed from step {kill} by a fresh state and a new "
                  f"Checkpointer: restored state bit for bit the saved one "
                  f"(held; restore {restore_s:.2f} s); losses a [{fmt(loss_a)}]"
                  f", b [{fmt(loss_b)}], c [{fmt(loss_c)}]; steps "
                  f"{kill + 1}-{steps} max |c - a| / max(1, |a|) {worst:.3g}"
                  f" (tol {RESUME_LOSS_TOL}), bit for bit: "
                  f"{'yes' if bit else 'no'}; steps 1-{kill} max |b - a| "
                  f"{before:.3g}; state drift (RESUME_STATE_TOL "
                  f"{RESUME_STATE_TOL}): b's staged step {every} against a's"
                  f" synchronous {drift_b:.3g} (bit for bit: "
                  f"{'yes' if bit_b else 'no'}), c's final state against "
                  f"a's {drift_c:.3g} (bit for bit: "
                  f"{'yes' if bit_c else 'no'}), c's staged step {steps} "
                  f"c's final state bit for bit (held); planted fault e "
                  f"(Adam moments zeroed on restore): drift {drift_e:.3g}"
                  f" (caught), losses [{fmt(loss_e)}], max |e - a| / "
                  f"max(1, |a|) {worst_e:.3g}; launches a step {per_step} "
                  f"in a, b, c and e; "
                  f"{len(recs)} events valid ({', '.join(sorted(kinds))})")
            if label != "large":
                continue
            # d. the steady-state staged boundary: 7 steps, stages at 3
            # and 6; log_fn waits at step 5 for the first stage to land
            # (a run's boundaries are far apart), so step 7 holds a stage
            # whose buffers exist and that no earlier stage holds back.
            steady_cfg = train_preset(name, B, L, 7, packed).replace(
                checkpoint=staged_cfg.checkpoint, optimizer=cfg.optimizer)
            tele_d = Telemetry(spans=True)
            ck = timed_checkpointer(os.path.join(root, f"{tag}-d"),
                                    max_to_keep=1)

            def settle(step, ck=ck):
                if step == 5:
                    ck.wait()

            out_d, _, wall_d, _, n = resume_run(
                f"resume {label} d", steady_cfg, fac, per_step, ckpt=ck,
                tele=tele_d, on_log=settle)
            ck.close()
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            times_d = ck.times
            span_d = span_ms(tele_d, "ckpt_boundary_staged")
            # After the timed runs: its pinned buffers, once freed, stay
            # in the host allocator's cache and would make b's first
            # stage look like a steady one.
            ordering = staged_ordering_check(
                out_d["state"], os.path.join(root, f"{tag}-ordering"))
            shutil.rmtree(os.path.join(root, f"{tag}-ordering"))
            print(f"# resume {label} [{card}]: {ordering}")
            del ck, out_d
            gc.collect()
            torch.cuda.empty_cache()

            def med(walls, skip):
                return statistics.median(w for s, w in walls.items()
                                         if s not in skip)

            def fmt_walls(walls):
                return ", ".join(f"{walls[s]:.1f}" for s in sorted(walls))

            def fmt_times(times):
                return ", ".join(f"{k} {v:.3f} s" for k, v in times)

            b_step = every + 1            # the step after the boundary
            med_a = med(wall_a, (1, b_step))
            med_b = med(wall_b, (1, b_step))
            med_d = med(wall_d, (1, 4, 5, 7))
            stage_s = ", ".join(f"{r['overlap_s']:.3f}" for r in landed)
            print(f"# resume boundary {label} [{card}]: step walls ms a "
                  f"[{fmt_walls(wall_a)}], b [{fmt_walls(wall_b)}], d "
                  f"[{fmt_walls(wall_d)}]; synchronous save at step "
                  f"{every} (a): step {b_step} {wall_a[b_step]:.1f} ms "
                  f"against the median step {med_a:.1f} ms "
                  f"(+{wall_a[b_step] - med_a:.1f}; {fmt_times(times_a.items())}"
                  f"); first staged save (b): step {b_step} "
                  f"{wall_b[b_step]:.1f} ms against {med_b:.1f} ms "
                  f"(+{wall_b[b_step] - med_b:.1f}), boundary on the train "
                  f"thread {', '.join(f'{x:.1f}' for x in span_b)} ms, saver "
                  f"thread {fmt_times(times_b)}; steady staged save (d, "
                  f"step 6): step 7 {wall_d[7]:.1f} ms against "
                  f"{med_d:.1f} ms (+{wall_d[7] - med_d:.1f}), boundary on "
                  f"the train thread {', '.join(f'{x:.1f}' for x in span_d)}"
                  f" ms, saver thread {fmt_times(times_d)}; b and c's stages "
                  f"landed after {stage_s} s (overlap_s); preemption save at "
                  f"step {kill} {preempt_s:.2f} s; restore {restore_s:.2f} s;"
                  f" state {state_bytes} bytes in float32 params and Adam "
                  f"moments, state.pt {file_bytes} bytes")
    finally:
        shutil.rmtree(root, ignore_errors=True)
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
    if hasattr(srv.dispatcher, "graph_pool_bytes"):
        torch.cuda.synchronize()
        pool = srv.dispatcher.graph_pool_bytes()
        print(f"# serve {label}: {srv.dispatcher.executable_count} CUDA "
              f"graphs, their pool holds {pool} bytes ({pool / 2**20:.2f} "
              f"MiB) after warmup; device memory allocated "
              f"{torch.cuda.memory_allocated() - mem0} bytes [{card}]")

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

    done_ms = sorted(round((f - t_start) * 1e3, 1) for f in finished)
    print(f"# serve {label}: requests done at (ms after the clients "
          f"started) {done_ms}; queue wait {stats.get('queue_wait')}; "
          f"pipeline {stats.get('pipeline')}; graphs "
          f"{stats.get('executables')}")
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


def enqueue_ms(srv, batch) -> float:
    """Median host ms from submit to the batch's replay enqueued (the
    async entry's return; each batch is finalized after), over 10 full
    embed batches."""
    disp = srv.dispatcher
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        if srv.serve_mode == "bucketed":
            handle = disp.run_timed_async("embed", batch, timed=False)
        else:
            handle = disp.run_packed_timed_async("embed", *batch,
                                                 timed=False)
        times.append((time.perf_counter() - t0) * 1e3)
        handle.finalize()
    return statistics.median(times)


def replay_equals_eager(label: str, srv, batch) -> None:
    """One full embed batch through the server's warm shape (a graph
    replay) against the same batch run eagerly through the same batch
    function on the same weights: bit for bit (the kernels are
    deterministic)."""
    from proteinbert_tpu_torch import inference

    disp = srv.dispatcher
    quantized, params = disp._arm()
    graphs = disp.executable_count
    if srv.serve_mode == "bucketed":
        got = disp.run("embed", batch)
        ann = np.zeros((batch.shape[0], disp.cfg.model.num_annotations),
                       np.float32)
        want = inference.run_batch(disp._fn("embed", quantized), params,
                                   disp.cfg, batch, ann, device=DEVICE)
        pairs = [(got[k], want[k]) for k in want]
    else:
        tokens, seg, ann, riders = batch
        got = disp.run_packed("embed", tokens, seg, ann, riders)
        host = inference.run_batch(disp._packed_fn("embed", quantized),
                                   params, disp.cfg, tokens, seg, ann,
                                   device=DEVICE)
        pairs = [(g[k], host[k][r, s]) for g, (r, s, _, _) in
                 zip(got, riders) for k in ("global", "local_mean")]
    check(disp.executable_count == graphs, f"{label}: a warm shape was "
                                           "captured again")
    diff = max(float(np.abs(a.astype(np.float64) - b).max())
               for a, b in pairs)
    exact = all(np.array_equal(a, b) for a, b in pairs)
    print(f"# serve {label}: graph replay vs eager run of one full embed "
          f"batch: max |diff| {diff:.3e}, bit for bit {exact}")
    check(exact, f"{label}: graph replay differs from the eager run "
                 f"({diff})")


def http_post(url: str, payload) -> tuple:
    """(status, JSON body) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_round_trips(label: str, srv) -> tuple:
    """One round trip of each kind through `serve/http.py` over
    127.0.0.1, each answer held against the same request submitted in
    process right after it (cache off, so both ran on the card, each
    alone in its batch: exact), then a bad body (400) and a predict_task
    for a head the server does not hold (the typed 404). Returns (the
    requests answered, two a kind; the requests rejected, one)."""
    import urllib.request

    from proteinbert_tpu_torch.serve.http import make_http_server

    httpd = make_http_server(srv, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    worst = 0.0
    try:
        for kind, seq in traffic(3, seed=7):  # one of each kind
            status, body = http_post(f"{base}/v1/{kind}", {"seq": seq})
            check(status == 200, f"{label}: HTTP {kind} answered {status}: "
                                 f"{body}")
            want = srv.submit(kind, seq).result(timeout=120)
            if kind == "embed":
                for key in ("global", "local_mean"):
                    worst = max(worst, float(np.abs(np.asarray(
                        body[key], np.float32) - want[key]).max()))
            elif kind == "predict_go":
                worst = max(worst, float(np.abs(np.asarray(
                    body["probs"], np.float32) - want).max()))
            else:
                check(body["filled"] == want[0],
                      f"{label}: HTTP predict_residues fill differs")
        bad, _ = http_post(f"{base}/v1/embed", {"nope": 1})
        route, body = http_post(f"{base}/v1/predict_task",
                                {"seq": "MKT", "head_id": "nope"})
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(30)
    print(f"# serve {label}: HTTP round trip of each kind over 127.0.0.1 vs "
          f"in process: max |diff| {worst:.3e} (tol 0), fills equal; bad "
          f"body {bad}, /v1/predict_task of an unknown head {route} "
          f"{body.get('type')}, /healthz ok {health.get('ok')}")
    check(worst == 0.0, f"{label}: HTTP answers differ by {worst}")
    check(bad == 400 and route == 404 and body.get("type") == "unknown_head"
          and health.get("ok") is True,
          f"{label}: HTTP status mapping {bad}/{route}/{health.get('ok')}")
    return 6, 1


def same_answer(kind: str, a, b) -> bool:
    if kind == "embed":
        return all(np.array_equal(a[k], b[k]) for k in ("global",
                                                         "local_mean"))
    if kind == "predict_go":
        return np.array_equal(a, b)
    return a[0] == b[0] and np.array_equal(a[1], b[1])


def depth_parity(card: str, label: str, cfg, mode: str, seed: int,
                 quant: str) -> None:
    """The 24-request traffic at pipeline_depth 2 and then 1, on fresh
    servers over the same weights, every request submitted before
    start() so both form the same batches: the answers bit for bit the
    same, every future sealed once, inflight_max at most the depth. Both
    servers carry telemetry: the event stream passes
    read_events(strict=True) and the schema validator, one serve_request
    a request and one serve_batch a batch. The depth-2 server also
    answers `http_round_trips` while it is live."""
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.obs import Telemetry, read_events
    from proteinbert_tpu_torch.obs.events import validate_record
    from proteinbert_tpu_torch.serve.dispatch import KINDS
    from proteinbert_tpu_torch.serve.server import Server

    reqs = traffic(24, seed=0)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="serve-", dir=build)
    answers = {}
    try:
        for depth in (2, 1):
            gc.collect()
            params = init(cfg.model, torch.Generator().manual_seed(seed),
                          device=DEVICE)
            path = os.path.join(root, f"events-{depth}.jsonl")
            tele = Telemetry(events_path=path)
            srv = Server(params, cfg, device=DEVICE, buckets=BUCKETS,
                         max_batch=8, max_wait_s=0.005, queue_depth=64,
                         cache_size=0, warm_kinds=KINDS, serve_mode=mode,
                         pack_max_segments=8, quant=quant,
                         quant_parity_every=0, telemetry=tele,
                         pipeline_depth=depth)
            del params
            sealed = [0] * len(reqs)
            futures = []
            for i, (kind, seq) in enumerate(reqs):
                f = srv.submit(kind, seq)
                f.add_done_callback(
                    lambda f, i=i: sealed.__setitem__(i, sealed[i] + 1))
                futures.append(f)
            srv.start()
            answers[depth] = [f.result(timeout=300) for f in futures]
            extra, rejected = (http_round_trips(label, srv) if depth == 2
                               else (0, 0))
            check(srv.drain(timeout=300), f"{label}: depth {depth} drain "
                                          "timed out")
            tele.close()
            stats = srv.stats()
            pipe = stats["pipeline"]
            recs = read_events(path, strict=True)
            for rec in recs:
                validate_record(rec)
            events = [r["event"] for r in recs]
            print(f"# serve {label} depth {depth}: {stats['batches']} "
                  f"batches, inflight_max {pipe['inflight_max']}, overlap "
                  f"ratio {pipe['overlap_ratio']}, finalize "
                  f"{pipe['finalize_seconds_total']} s; {len(recs)} events "
                  f"valid ({events.count('serve_request')} serve_request, "
                  f"{events.count('serve_batch')} serve_batch)")
            check(sealed == [1] * len(reqs), f"{label}: depth {depth} "
                                             f"sealed {sealed}")
            check(stats["completed"] == len(reqs) + extra,
                  f"{label}: depth {depth} completed {stats['completed']}")
            check(1 <= pipe["inflight_max"] <= depth,
                  f"{label}: inflight_max {pipe['inflight_max']} at depth "
                  f"{depth}")
            check(events[0] == "serve_start" and events[-1] == "serve_end"
                  and recs[-1]["outcome"] == "drained",
                  f"{label}: event stream {events[0]} .. {events[-1]}")
            check(events.count("serve_request")
                  == len(reqs) + extra + rejected
                  and events.count("serve_batch") == stats["batches"]
                  and stats["rejected"]["unknown_head"] == rejected,
                  f"{label}: {events.count('serve_request')} serve_request, "
                  f"{events.count('serve_batch')} serve_batch events")
            del srv
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = all(same_answer(kind, a, b) for (kind, _), a, b in
               zip(reqs, answers[2], answers[1]))
    print(f"# serve {label}: depth 2 answers bit for bit depth 1's: {same} "
          f"({len(reqs)} requests) [{card}]")
    check(same, f"{label}: pipelining changed an answer")


def serve_phases(card: str, gates: bool = True) -> dict:
    """The three served paths (bucketed base, ragged base, ragged at the
    ModelConfig default width), each on the fp32 arm and then on the int8
    arm (same weights and traffic): the traffic with its launch gates and
    numbers, the profile of one full batch and, with warm shapes, the
    host time to enqueue one. With `gates`, each also holds a graph
    replay against the eager run (`replay_equals_eager`) and depth 2
    against depth 1 with the event stream and HTTP (`depth_parity`);
    then the int8 arm's parity shadow and the `int8_act` arm. Without
    (`--phase serve-times`, which also runs on the parent commit's
    package), only the numbers. Returns each kernel's launches summed
    over the traffic runs."""
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
                batch = tokens
                profile_batch(card, f"{name}, one embed batch 8x512",
                              lambda: srv.dispatcher.run("embed", tokens))
            else:
                batch = full_ragged_batch(srv)
                profile_batch(card, f"{name}, one packed embed batch 8x512 "
                              "(24 segments)",
                              lambda: srv.dispatcher.run_packed("embed",
                                                                *batch))
            if hasattr(srv.dispatcher, "graph_pool_bytes"):
                print(f"# serve {name} [{card}]: host ms from submit to the "
                      f"replay enqueued, one full embed batch "
                      f"{enqueue_ms(srv, batch):.3f} (median of 10)")
            if gates:
                replay_equals_eager(name, srv, batch)
            del srv
            if gates:
                depth_parity(card, name, cfg, mode, seed=0, quant=quant)
        diff = max_answer_diff(reqs, answers["int8"], answers["fp32"],
                               same_fills=False)
        print(f"# serve {label} int8: max |int8 - fp32 arm| over the "
              f"{len(reqs)} answers {diff:.6e}")
        check(diff > 0, f"{label}: the int8 arm answered exactly as the fp32 "
                        "arm (were the int8 weights used?)")
    if not gates:
        return totals
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


# ---------------------------------------------------- corpus to task head

def corpus_rows(n: int, num_annotations: int, seed: int):
    """n seeded proteins, lengths log-normal with a median of 350 residues
    (sigma 0.9) capped at 3000, so that the `long` preset's buckets 512,
    1024 and 2048 all fill, and (n, A) annotation masks at ~0.5%."""
    from proteinbert_tpu_torch.data.vocab import ALPHABET

    rng = np.random.default_rng(seed)
    lengths = np.clip(np.round(rng.lognormal(np.log(350), 0.9, n)), 1,
                      3000).astype(np.int64)
    letters = np.frombuffer("".join(ALPHABET).encode(), np.uint8)
    seqs = [letters[rng.integers(0, len(letters), int(L))].tobytes().decode()
            for L in lengths]
    masks = rng.random((n, num_annotations)) < 0.005
    return seqs, lengths, masks


def write_corpus(path: str, seqs, lengths, masks) -> None:
    """The reference's HDF5 corpus schema: `seqs`, `seq_lengths`,
    `annotation_masks` (bool), `included_annotations`, `uniprot_ids`."""
    import h5py

    str_dt = h5py.string_dtype()
    with h5py.File(path, "w") as f:
        f.create_dataset(
            "included_annotations", dtype=str_dt,
            data=np.array([f"GO:{i:07d}".encode()
                           for i in range(masks.shape[1])], dtype=object))
        f.create_dataset("uniprot_ids", dtype=str_dt,
                         data=np.array([f"R{i}".encode()
                                        for i in range(len(seqs))],
                                       dtype=object))
        f.create_dataset("seqs", dtype=str_dt, chunks=(1024,),
                         data=np.array(seqs, dtype=object))
        f.create_dataset("seq_lengths", data=lengths.astype(np.int32))
        f.create_dataset("annotation_masks", data=masks,
                         chunks=(256, masks.shape[1]))


def long_hdf5_phase(card: str) -> dict:
    """`# train long hdf5`: the `long` preset (6 blocks, C=G=512, H=8,
    8943 annotations) in bf16 pretrains from a seeded HDF5 corpus of 4096
    proteins (4 blocks of 1024 rows) through `HDF5PretrainingDataset`,
    `make_bucketed_iterator` (buckets 512 / 1024 / 2048) and pretrain's
    prefetch thread (depth 2): B=16, 8 steps, the LR without warmup. Cuts:
    global batch 64 over 4 data replicas -> one replica's 16 rows, seq
    world 4 -> 1 (the whole row on one card), no LR warmup. Without h5py
    the same rows come from `InMemoryPretrainingDataset` (one printed
    line says so). Gates: the prefetched stream equals the iterator's own
    byte for byte and in order; exactly 6 launches of K1 and of K2 a step
    and none of the others; finite losses. Returns the launches."""
    from proteinbert_tpu_torch.data.dataset import (
        HDF5PretrainingDataset, InMemoryPretrainingDataset,
        make_bucketed_iterator,
    )
    from proteinbert_tpu_torch.data.prefetch import prefetch
    from proteinbert_tpu_torch.kernels import ATTENTION, LOCAL_TRACK
    from proteinbert_tpu_torch.obs import Telemetry, read_events
    from proteinbert_tpu_torch.train.metrics import peak_flops, train_flops

    cfg = train_preset("long", 16, 2048, 8)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, prefetch_depth=2),
        optimizer=dataclasses.replace(cfg.optimizer, schedule="constant",
                                      warmup_steps=0))
    B, buckets = cfg.data.batch_size, cfg.data.buckets
    t0 = time.perf_counter()
    seqs, lengths, masks = corpus_rows(4096, cfg.model.num_annotations, 13)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="corpus-", dir=build)
    try:
        try:
            import h5py  # noqa: F401
            path = os.path.join(root, "corpus.h5")
            write_corpus(path, seqs, lengths, masks)
            mb = os.path.getsize(path) / 1e6
            print(f"# train long hdf5: corpus of {len(seqs)} proteins "
                  f"(median {int(np.median(lengths))}, max {lengths.max()} "
                  f"residues), {mb:.1f} MB HDF5, written in "
                  f"{time.perf_counter() - t0:.1f} s")

            def dataset():
                return HDF5PretrainingDataset(path, cfg.data.seq_len,
                                              crop_seed=7)
        except ImportError:
            print(f"# train long hdf5: h5py absent on {card}, rows fed from "
                  "InMemoryPretrainingDataset")
            mem = InMemoryPretrainingDataset(seqs, masks, cfg.data.seq_len,
                                             crop_seed=7)

            def dataset():
                return mem

        def stream():
            return make_bucketed_iterator(dataset(), B, buckets, seed=0)

        direct = [b for _, b in zip(range(8), stream())]
        it = prefetch(stream(), 2)
        ahead = [next(it) for _ in range(8)]
        it.close()
        same = all(a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
            for k in a) for a, b in zip(direct, ahead))
        events = os.path.join(root, "events.jsonl")
        tele = Telemetry(events_path=events)
        try:
            out, walls, launches, peak, _, trained = train_run(
                card, "long hdf5", cfg, 8,
                {LOCAL_TRACK.name: 6, ATTENTION.name: 6}, (0, 0), 0,
                source=stream, telemetry=tele)
        finally:
            tele.close()
        steps = [r for r in read_events(events, strict=True)
                 if r["event"] == "step"]
        wait = [r.get("data_wait_s") for r in steps]
        gauges = tele.metrics.snapshot()["gauges"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = same and all(
        a["tokens"].tobytes() == b["tokens"].tobytes()
        and a["annotations"].tobytes() == b["annotations"].tobytes()
        for a, b in zip(trained, direct))
    Ls = [b["tokens"].shape[1] for b in trained]
    print(f"# train long hdf5: the prefetched stream equals the iterator's "
          f"own, byte for byte and in order ({len(direct)} batches, pretrain "
          f"trained on the same): {same}; bucket of each step {Ls}")
    check(same and len(trained) == 8, "long hdf5: the prefetched stream "
                                      "differs from the iterator's")
    pad = float(np.mean([(b["tokens"] == 0).mean() for b in trained]))
    peak_rate = peak_flops(torch.device(DEVICE), cfg.model.dtype)
    by_bucket = []
    for L in buckets:
        ms = [w for w, l in zip(walls, Ls) if l == L]
        if not ms:
            by_bucket.append(f"L={L}: not run")
            continue
        med = statistics.median(ms)
        mfu = train_flops(cfg.model, B, L) / (med / 1e3) / peak_rate
        by_bucket.append(f"L={L}: median {med:.1f} ms of {len(ms)} "
                         f"({', '.join(f'{w:.1f}' for w in ms)}), "
                         f"{B * L / (med / 1e3):.0f} tokens/s, MFU "
                         f"{mfu:.4f}")
    for L in buckets:   # where one step's time goes, per bucket
        batch = next((b for b in trained if b["tokens"].shape[1] == L), None)
        if batch is not None:
            profile_step(card, f"train long hdf5, one step B={B} L={L}",
                         out["state"], batch, cfg)
    m = cfg.model
    print(f"# train long hdf5 [{card}]: {m.num_blocks} blocks C={m.local_dim} "
          f"G={m.global_dim} H={m.num_heads} A={m.num_annotations}, "
          f"{m.dtype}, B={B}, buckets {list(buckets)}; reported cuts: global "
          f"batch 64 over 4 data replicas -> 16 rows, seq world 4 -> 1, no "
          f"LR warmup; step ms by bucket (the first step of a shape "
          f"included): {'; '.join(by_bucket)}; data_wait_s at each log "
          f"point {wait}; data_batches_total "
          f"{gauges.get('data_batches_total')}; pad fraction of the B*L "
          f"grid {pad:.4f}; max_memory_allocated {peak / 1e9:.2f} GB")
    return launches


def finetune_phase(card: str, registry_dir: str) -> tuple:
    """`# finetune base`: the `base` trunk (the paper's 6 x 512 model,
    8943 annotations) in bf16, seeded random weights, fine-tuned through
    `train.finetune.finetune` on seeded task data (B=8, L=512, 4 steps)
    for token_classification with 8 classes and sequence_regression with
    1 output, each with freeze_trunk False and True; each trained head is
    registered in a `HeadRegistry` at `registry_dir`. First a float32
    2-block base-width step on the card against the same step on the CPU
    plain path (loss <= STEP_LOSS_TOL, grads <= STEP_GRAD_TOL) for both
    tasks. Gates: exactly 6 K1 + 6 K2 launches a step (the backward is
    the recompute of the XLA reference, no kernel); under freeze_trunk
    the trunk bit for bit the pretrained one; finite losses. Returns
    (the launches, the resident trunk's params, {(kind, frozen): head
    id})."""
    from proteinbert_tpu_torch.configs import (
        FinetuneConfig, OptimizerConfig, TaskConfig, get_preset,
    )
    from proteinbert_tpu_torch.data.synthetic import make_task_batches
    from proteinbert_tpu_torch.heads import HeadRegistry
    from proteinbert_tpu_torch.kernels import ATTENTION, KERNELS, LOCAL_TRACK
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.train import finetune as ft

    KERNELS_BY_NAME = {k.name: k for k in KERNELS}
    from proteinbert_tpu_torch.train.schedule import tree_leaves

    base = get_preset("base")
    opt = OptimizerConfig(learning_rate=1e-4, warmup_steps=0,
                          schedule="constant")
    tasks = (("token_classification", 8), ("sequence_regression", 1))

    # float32, 2 blocks, card vs CPU (the Large fp32 gate's limits)
    small = dataclasses.replace(base.model, dtype="float32", num_blocks=2)
    params = init(small, torch.Generator().manual_seed(51), device="cpu")
    for kind, n_out in tasks:
        cfg = FinetuneConfig(model=small, optimizer=opt,
                             task=TaskConfig(kind=kind, num_outputs=n_out))
        (batch,) = make_task_batches(8, np.random.default_rng(52), kind,
                                     n_out, 512, 8)
        state = ft.create_finetune_state(torch.Generator().manual_seed(53),
                                         cfg, params, device="cpu")
        want_g, want_m = ft.loss_and_grads(
            state.params, {k: torch.from_numpy(v) for k, v in batch.items()},
            cfg)
        card_params = to_device(state.params, torch.device(DEVICE))
        n0 = (LOCAL_TRACK.launches, ATTENTION.launches)
        got_g, got_m = ft.loss_and_grads(
            card_params, {k: torch.from_numpy(v).to(DEVICE)
                          for k, v in batch.items()}, cfg)
        torch.cuda.synchronize()
        check((LOCAL_TRACK.launches - n0[0], ATTENTION.launches - n0[1])
              == (2, 2), "finetune reference step did not run K1 and K2 "
                         "once a block")
        loss_err = abs(float(got_m["loss"]) - float(want_m["loss"]))
        grad_err = max((a.cpu() - b).abs().max().item()
                       for a, b in zip(got_g, want_g))
        print(f"# finetune reference step {kind}: 2-block fp32 base width, "
              f"B=8 L=512, card vs CPU plain path: loss "
              f"{float(got_m['loss']):.6f} |diff| {loss_err:.3e} (tol "
              f"{STEP_LOSS_TOL}), grads max |diff| {grad_err:.3e} over "
              f"{len(got_g)} tensors (tol {STEP_GRAD_TOL}) [{card}]")
        check(loss_err <= STEP_LOSS_TOL, f"finetune step loss {loss_err}")
        check(grad_err <= STEP_GRAD_TOL, f"finetune step grads {grad_err}")

    trunk = init(base.model, torch.Generator().manual_seed(61),
                 device=DEVICE)
    registry = HeadRegistry(registry_dir)
    totals = {}
    heads = {}
    B, L = 8, 512
    for kind, n_out in tasks:
        batches = make_task_batches(32, np.random.default_rng(62), kind,
                                    n_out, L, B)
        for frozen in (False, True):
            label = f"{kind} freeze_trunk={frozen}"
            cfg = FinetuneConfig(
                model=base.model, optimizer=opt,
                task=TaskConfig(kind=kind, num_outputs=n_out,
                                freeze_trunk=frozen, epochs=1))
            marks = []

            def timed(batches=batches):
                # A step is the wall between two marks, the card synced:
                # one before each batch, one when the loop asks for more.
                for b in batches:
                    torch.cuda.synchronize()
                    marks.append((time.perf_counter(),
                                  {k.name: k.launches for k in KERNELS}))
                    yield b
                torch.cuda.synchronize()
                marks.append((time.perf_counter(),
                              {k.name: k.launches for k in KERNELS}))

            for k in KERNELS:
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = ft.finetune(cfg, lambda epoch: timed(),
                              pretrained_trunk=trunk, device=DEVICE,
                              registry=registry,
                              register_name=f"{kind}-{frozen}")
            peak = torch.cuda.max_memory_allocated()
            walls = []
            for (t0, n0), (t1, n1) in zip(marks, marks[1:]):
                walls.append((t1 - t0) * 1e3)
                for name in n1:
                    want = {LOCAL_TRACK.name: 6, ATTENTION.name: 6}.get(name,
                                                                        0)
                    check(n1[name] - n0[name] == want,
                          f"finetune {label}: a step launched {name} "
                          f"{n1[name] - n0[name]} times, want {want}")
            check(len(walls) == 4, f"finetune {label}: {len(walls)} steps")
            for name, n in marks[-1][1].items():
                check(n == KERNELS_BY_NAME[name].launches,
                      f"finetune {label}: {name} launched after the steps")
                totals[name] = totals.get(name, 0) + n
            hist = out["history"][-1]
            check(all(np.isfinite(v) for k, v in hist.items()
                      if k.startswith("train_")), f"finetune {label}: "
                                                  f"{hist}")
            if frozen:
                same = all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(out["state"].params["trunk"]),
                    tree_leaves({k: v for k, v in trunk.items()
                                 if k not in ("local_head", "global_head")})))
                print(f"# finetune {label}: trunk after 4 steps bit for bit "
                      f"the pretrained one: {same}")
                check(same, f"finetune {label}: the frozen trunk moved")
            heads[(kind, frozen)] = out["head_id"]
            profile_finetune_step(card, f"finetune base {label}, one step "
                                  f"B={B} L={L}", out["state"], batches[0],
                                  cfg)
            med = statistics.median(walls[1:])
            m = cfg.model
            print(f"# finetune base {label} [{card}]: {m.num_blocks} blocks "
                  f"C={m.local_dim} G={m.global_dim} H={m.num_heads}, "
                  f"{m.dtype}, B={B} L={L}, 4 steps, train metrics "
                  f"{ {k: round(v, 4) for k, v in hist.items()} }; step ms "
                  f"median of 3 {med:.1f} (steps "
                  f"{', '.join(f'{w:.1f}' for w in walls)}), "
                  f"{B * L / (med / 1e3):.0f} tokens/s; max_memory_allocated "
                  f"{peak / 1e9:.2f} GB; registered head {out['head_id']}")
    return totals, trunk, heads


def profile_finetune_step(card: str, label: str, state, batch, cfg) -> None:
    """Where one fine-tune step's time goes: synchronized phases (host ->
    device, forward + task loss, backward, optimizer), then
    `profile_batch` over a whole synchronized step (its wall and the
    device's busy share, the largest kernels)."""
    from proteinbert_tpu_torch.train import finetune as ft
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.train_state import (
        _to_device, gradient_update,
    )

    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    b = _to_device(batch, torch.device(DEVICE))
    mark()
    trained = ft.trained_params(state.params, cfg)
    leaves = tree_leaves(trained)
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = ft.task_loss(ft._outputs(state.params, b, cfg,
                                           cfg.task.freeze_trunk), b,
                               cfg.task.kind)
        mark()
        # A token head reads no global track: the last block's global
        # weights get no gradient (zeros, as `grads_of` gives them).
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        mark()
    for t in leaves:
        t.requires_grad_(False)
    gradient_update(ft.make_finetune_optimizer(cfg), trained, grads,
                    state.opt_state, loss)
    mark()
    wall = marks[-1] - marks[0]
    print(f"# profile {label} [{card}]: one step {wall * 1e3:.1f} ms, "
          "phases synchronized:")
    for name, a, c in zip(("host -> device", "forward + task loss",
                           "backward", "optimizer"), marks, marks[1:]):
        print(f"#   {(c - a) * 1e3:9.1f} ms {100 * (c - a) / wall:5.1f}%  "
              f"{name}")

    def step():
        ft.finetune_step(state, batch, cfg)
        torch.cuda.synchronize()

    profile_batch(card, label, step)


def predict_task_traffic(srv, reqs):
    """Warm every trunk shape, set every kernel count to 0, submit
    `reqs` ((head id, sequence) pairs) before `start()`, so the batches
    form from the whole queue in order — per bucket, FIFO chunks of
    max_batch (bucketed), or first-fit packed rows (ragged) — then start
    and return the answers in order."""
    from proteinbert_tpu_torch.kernels import KERNELS

    srv.dispatcher.warmup(("predict_task",))
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    futures = [srv.submit("predict_task", seq, head_id=hid)
               for hid, seq in reqs]
    srv.start()
    return [f.result(timeout=300) for f in futures]


def bucketed_batches(srv, reqs):
    """The bucketed batches `predict_task_traffic` forms: per bucket
    length, FIFO chunks of max_batch → [(L, [request index, ...])]."""
    groups = {}
    for i, (_, seq) in enumerate(reqs):
        groups.setdefault(srv.dispatcher.bucket_len(len(seq)), []).append(i)
    n = srv.scheduler.max_batch
    return [(L, idx[j:j + n]) for L, idx in groups.items()
            for j in range(0, len(idx), n)]


def task_batch_equals_eager(label: str, srv, heads) -> tuple:
    """One full predict_task batch mixing `heads` row by row (bucketed:
    8 x 512; ragged: 8 rows of three segments) through the server's trunk
    graph and tails, against the same trunk entry and tails run eagerly
    on the same card: bit for bit. Returns (the dispatcher call, its
    outputs)."""
    from proteinbert_tpu_torch.heads import apply as heads_apply

    disp = srv.dispatcher
    quantized, params = disp._arm()
    fn = disp._trunk_fn(quantized)
    graphs = disp.trunk_executable_count
    if srv.serve_mode == "bucketed":
        rng = np.random.default_rng(3)
        tokens = rng.integers(4, 26, (8, 512)).astype(np.int32)
        tokens[:, 0], tokens[:, -1] = 1, 2
        ann = np.zeros((8, disp.cfg.model.num_annotations), np.float32)
        rows = [heads[i % len(heads)] for i in range(8)]

        def run():
            return disp.run("predict_task", tokens, heads=rows)

        got = run()
        trunk_out = fn(params, torch.from_numpy(tokens).to(DEVICE),
                       torch.from_numpy(ann).to(DEVICE), disp.cfg.model)
        want = heads_apply.apply_heads(trunk_out, rows)
    else:
        tokens, seg, ann, riders = full_ragged_batch(srv)
        rows = [heads[i % len(heads)] for i in range(len(riders))]

        def run():
            return disp.run_packed("predict_task", tokens, seg, ann, riders,
                                   heads=rows)

        got = run()
        trunk_out = fn(params, *(torch.from_numpy(a).to(DEVICE)
                                 for a in (tokens, seg, ann)),
                       disp.cfg.model)
        want = heads_apply.apply_heads_packed(
            trunk_out, [(h,) + tuple(r) for h, r in zip(rows, riders)])
    check(disp.trunk_executable_count == graphs,
          f"{label}: a trunk graph was captured again")
    exact = all(np.array_equal(a, b) for a, b in zip(got, want))
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    print(f"# serve {label}: graph replay of one full predict_task batch "
          f"({len(got)} requests, {len(heads)} heads) vs the eager trunk and "
          f"tails: max |diff| {diff:.3e}, bit for bit {exact}")
    check(exact, f"{label}: replay differs from the eager run ({diff})")
    return run, got


def serve_task_phase(card: str, trunk, registry_dir: str,
                     heads: dict) -> dict:
    """`# serve base predict_task`: four servers over the base trunk of
    `finetune_phase` (bf16, buckets 128/256/512, max_batch 8): bucketed
    and ragged (8 segments a row), fp32 and int8 arms, each carrying the
    two frozen-trunk heads from the registry. Each answers 24
    predict_task requests (20-500 residues, the two heads mixed) from 4
    threads with every kernel count at 0, then drains. Gates: exactly 6
    launches of K1 (bucketed; ragged: #3; int8: #3-int8 ragged) and of K2
    (int8: K2-int8) per batch and none of the others; every answer finite
    and shaped by its head; on the fp32 bucketed arm each answer equals
    `heads/apply.predict_task_rows` run eagerly on the same card with the
    row alone in a batch of the served shape, bit for bit; one full
    predict_task batch replayed equals the eager trunk entry and tails
    bit for bit (`task_batch_equals_eager`); the int8 arm's answers lie
    off the fp32 arm's (> 0, printed); hot-adding a third head leaves
    `trunk_executable_count` flat; a removed head gives the typed
    `unknown_head` rejection; a head trained with an unfrozen trunk
    raises TrunkMismatchError; over HTTP (fp32 arms) `/v1/predict_task`
    equals in process bit for bit and `/v1/heads*` answer. Prints the
    per-batch wall and busy share of one full predict_task batch with two
    heads and the graph pool's bytes. Returns the launches."""
    import urllib.request

    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.configs import TaskConfig, get_preset
    from proteinbert_tpu_torch.data.vocab import ALPHABET
    from proteinbert_tpu_torch.heads import (
        HeadRegistry, TrunkMismatchError, UnknownHeadError,
        trunk_fingerprint,
    )
    from proteinbert_tpu_torch.heads import apply as heads_apply
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, KERNELS, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_Q8,
    )
    from proteinbert_tpu_torch.models import finetune as ft_model
    from proteinbert_tpu_torch.serve.http import make_http_server
    from proteinbert_tpu_torch.serve.server import Server

    base = get_preset("base")
    registry = HeadRegistry(registry_dir)
    served = [heads[("token_classification", True)],
              heads[("sequence_regression", True)]]
    fp = trunk_fingerprint(trunk, base.model.scan_blocks)
    third = TaskConfig(kind="sequence_classification", num_outputs=3,
                       freeze_trunk=True)
    third_id = registry.save(ft_model.head_init(
        torch.Generator().manual_seed(71), base.model, third, device="cpu"),
        third, fp, name="third")
    rnd = random.Random(5)
    reqs = [(served[i % 2], "".join(rnd.choice(ALPHABET)
                                    for _ in range(rnd.randint(20, 500))))
            for i in range(24)]
    totals = {}
    answers = {}
    for mode, quant, per_batch in (
            ("bucketed", "fp32", {LOCAL_TRACK.name: 6, ATTENTION.name: 6}),
            ("bucketed", "int8", {LOCAL_TRACK.name: 6,
                                  ATTENTION_Q8.name: 6}),
            ("ragged", "fp32", {LOCAL_TRACK_SEGMENTS.name: 6,
                                ATTENTION.name: 6}),
            ("ragged", "int8", {LOCAL_TRACK_SEGMENTS_Q8.name: 6,
                                ATTENTION_Q8.name: 6})):
        label = f"{mode} base predict_task{'' if quant == 'fp32' else ' int8'}"
        gc.collect()
        torch.cuda.synchronize()
        srv = Server(trunk, base, device=DEVICE, buckets=BUCKETS,
                     max_batch=8, max_wait_s=0.005, cache_size=0,
                     warm_kinds=(), serve_mode=mode, pack_max_segments=8,
                     quant=quant, quant_parity_every=0, registry=registry,
                     heads=served)
        check(srv.trunk_fp() == fp, f"{label}: trunk fingerprint")
        t0 = time.perf_counter()
        got = predict_task_traffic(srv, reqs)
        check(srv.drain(timeout=300), f"{label}: drain timed out")
        launches = {k.name: k.launches for k in KERNELS}
        pool = srv.dispatcher.graph_pool_bytes()
        n_trunk = srv.dispatcher.trunk_executable_count
        print(f"# serve {label}: warmup and {len(reqs)} requests in "
              f"{time.perf_counter() - t0:.2f} s; {n_trunk} trunk graphs "
              f"shared by {len(served)} heads, their pool holds {pool} bytes "
              f"({pool / 2**20:.2f} MiB); head tails warmed in "
              f"{srv.dispatcher.warmup_report['heads']} s [{card}]")
        batches = srv.stats()["batches"]
        for name, n in launches.items():
            want = per_batch.get(name, 0) * batches
            check(n == want, f"{label}: {name} launched {n} times for "
                             f"{batches} batches, want {want}")
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        for (hid, seq), out in zip(reqs, got):
            L = srv.dispatcher.bucket_len(len(seq))
            shape = (L, 8) if hid == served[0] else (1,)
            check(out.shape == shape and np.isfinite(out).all(),
                  f"{label}: answer {out.shape}, want {shape}")
        print(f"# serve {label}: {len(reqs)} requests over {len(served)} "
              f"heads in {batches} batches, launches {launches}")
        answers[(mode, quant)] = got
        if (mode, quant) == ("bucketed", "fp32"):
            by_id = {h: srv.dispatcher.get_head(h) for h in served}
            exact = True
            chunks = bucketed_batches(srv, reqs)
            for L, idx in chunks:
                toks = np.zeros((srv.dispatcher.batch_class(len(idx)), L),
                                np.int32)
                toks[:len(idx)] = inference._tokenize_masked(
                    [reqs[i][1] for i in idx], 512, "count")[:, :L]
                for row, i in enumerate(idx):
                    want = heads_apply.predict_task_rows(
                        srv.dispatcher.params, base.model,
                        by_id[reqs[i][0]], toks)[row]
                    exact &= np.array_equal(got[i], want)
            print(f"# serve {label}: each answer vs predict_task_rows run "
                  f"eagerly on the card on its batch ({len(chunks)} "
                  f"batches rebuilt): bit for bit {exact}")
            check(len(chunks) == batches and exact,
                  f"{label}: an answer differs from predict_task_rows")
        run, _ = task_batch_equals_eager(
            label, srv, [srv.dispatcher.get_head(h) for h in served])
        profile_batch(card, f"{label}, one full batch, {len(served)} heads",
                      run)
        del srv
        gc.collect()
        # Hot add, remove, a head of another trunk, on a live server.
        srv = Server(trunk, base, device=DEVICE, buckets=BUCKETS,
                     max_batch=8, max_wait_s=0.005, cache_size=0,
                     warm_kinds=(), serve_mode=mode, pack_max_segments=8,
                     quant=quant, quant_parity_every=0, registry=registry,
                     heads=served).start()
        n_trunk = srv.dispatcher.trunk_executable_count
        srv.add_head(third_id)
        out = srv.predict_task(third_id, reqs[0][1], timeout=120)
        check(out.shape == (3,) and srv.dispatcher.trunk_executable_count
              == n_trunk, f"{label}: hot add captured a trunk graph "
                          f"({srv.dispatcher.trunk_executable_count} vs "
                          f"{n_trunk})")
        srv.remove_head(third_id)
        try:
            srv.predict_task(third_id, reqs[0][1], timeout=120)
            check(False, f"{label}: a removed head answered")
        except UnknownHeadError:
            pass
        check(srv.stats()["rejected"]["unknown_head"] == 1,
              f"{label}: unknown_head rejections "
              f"{srv.stats()['rejected']}")
        try:
            srv.add_head(heads[("token_classification", False)])
            check(False, f"{label}: a head of another trunk was added")
        except TrunkMismatchError:
            pass
        print(f"# serve {label}: hot add of a third head kept "
              f"{n_trunk} trunk graphs; the removed head -> typed "
              f"unknown_head; a head fine-tuned with its trunk -> "
              f"TrunkMismatchError")
        if quant == "fp32":
            httpd = make_http_server(srv, host="127.0.0.1", port=0)
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                worst = 0.0
                for hid, seq in reqs[:2]:
                    status, body = http_post(f"{url}/v1/predict_task",
                                             {"head_id": hid, "seq": seq})
                    check(status == 200, f"{label}: HTTP {status} {body}")
                    want = srv.predict_task(hid, seq, timeout=120)
                    worst = max(worst, float(np.abs(np.asarray(
                        body["outputs"], np.float32) - want).max()))
                with urllib.request.urlopen(url + "/v1/heads",
                                            timeout=60) as r:
                    listed = json.loads(r.read())["heads"]
                added, _ = http_post(f"{url}/v1/heads/add",
                                     {"head_id": third_id})
                removed, _ = http_post(f"{url}/v1/heads/remove",
                                       {"head_id": third_id})
                gone, body = http_post(f"{url}/v1/predict_task",
                                       {"head_id": third_id, "seq": "MKT"})
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=60) as r:
                    health = json.loads(r.read())
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(30)
            print(f"# serve {label}: HTTP /v1/predict_task vs in process "
                  f"max |diff| {worst:.3e} (tol 0); /v1/heads lists "
                  f"{len(listed)}; add {added}, remove {removed}, then "
                  f"{gone} {body.get('type')}; /healthz fingerprint "
                  f"{health.get('trunk_fingerprint') == fp}")
            check(worst == 0.0 and listed == srv.list_heads()
                  and (added, removed, gone) == (200, 200, 404)
                  and body.get("type") == "unknown_head"
                  and health.get("trunk_fingerprint") == fp,
                  f"{label}: HTTP routes")
        check(srv.drain(timeout=300), f"{label}: drain timed out")
        del srv
    for mode in ("bucketed", "ragged"):
        diff = max(float(np.abs(a - b).max()) for a, b in zip(
            answers[(mode, "int8")], answers[(mode, "fp32")]))
        print(f"# serve {mode} base predict_task int8: max |int8 - fp32 arm| "
              f"over the {len(reqs)} answers {diff:.6e}")
        check(0 < diff < float("inf"), f"{mode}: the int8 arm answered as "
                                       "the fp32 arm (int8 weights unused?)")
    return totals


def task_phases(card: str) -> dict:
    """`finetune_phase`, then `serve_task_phase` on its trunk and heads
    (the registry in a temporary directory under build/, removed after);
    returns the launches of both."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="heads-", dir=build)
    try:
        launches, trunk, heads = finetune_phase(card, root)
        for name, n in serve_task_phase(card, trunk, root, heads).items():
            launches[name] = launches.get(name, 0) + n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ------------------------------------------- corpus to a served neighbour

def map_corpus(n: int, num_annotations: int):
    """`n` proteins of `corpus_rows` (log-normal lengths, median 350: about
    a third longer than the 510-residue window, truncated and counted)
    with three poisoned records inserted — an empty one, a non-string and
    one with a control character — and their ids."""
    seqs, lengths, _ = corpus_rows(n, num_annotations, seed=14)
    seqs = list(seqs)
    for pos, bad in ((17, ""), (4100, 12345), (8000, "MKT\x01AVLV")):
        seqs.insert(pos, bad)
    ids = [f"UP{i:05d}" for i in range(len(seqs))]
    return ids, seqs, lengths


def map_profile(card: str, params, cfg, ids, seqs, root: str) -> float:
    """The device's busy share of a short map run (the first 512 records,
    one shard, the phase's settings) under torch.profiler: device busy
    seconds over the run's wall. Prints the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from proteinbert_tpu_torch.mapper import run_map

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_map(params, cfg, ids[:512], seqs[:512],
                      os.path.join(root, "profiled"), num_shards=1,
                      block_size=256, rows_per_batch=8, max_segments=8,
                      buckets=BUCKETS, stop_flag=lambda: False,
                      device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + ms)
    busy = sum(t for _, t in by_name.values()) / 1e3
    if not by_name:
        print("# neighbors base map profile: the profiler recorded no "
              "device time (busy share not measured)")
        return float("nan")
    print(f"# neighbors base map profile [{card}]: {out['seqs']} sequences "
          f"in {out['batches']} batches, wall {wall:.3f} s (profiled), "
          f"device busy {busy:.3f} s, {100 * busy / wall:.1f}% of wall")
    for name, (n, t) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:8]:
        print(f"#   {t:9.3f} ms {100 * t / (busy * 1e3):5.1f}%  x{n:<5d} "
              f"{name[:80]}")
    return busy / wall


def map_phase(card: str, params, cfg, root: str) -> tuple:
    """`# neighbors base map`: `run_map` over 8192 proteins plus three
    poisoned records (`map_corpus`), `base` preset, buckets `BUCKETS`,
    rows_per_batch 8, max_segments 8, 2 shards of 256-record blocks.
    Gates: exactly 6 #3 + 6 K2 per packed batch and nothing else;
    `verify_store` ok and complete; a run stopped by `max_blocks` and
    resumed, and a run with `pipeline=False`, write stores equal to the
    uninterrupted one's byte for byte (`store_digests`); the poisoned
    records quarantined with their typed reasons. Returns (the store, the
    launches, the fp32 vectors in index order)."""
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, KERNELS, LOCAL_TRACK_SEGMENTS,
    )
    from proteinbert_tpu_torch.mapper import (
        ShardCursor, run_map, store_digests, verify_store,
    )

    ids, seqs, lengths = map_corpus(8192, cfg.model.num_annotations)
    kw = dict(num_shards=2, block_size=256, rows_per_batch=8,
              max_segments=8, buckets=BUCKETS, stop_flag=lambda: False,
              device=DEVICE)
    store = os.path.join(root, "store")
    # A short run first: it builds and loads #3 and K2 (the card's first
    # calls of them in this process may be a phase earlier) and settles
    # the allocator, so the timed run measures the map.
    run_map(params, cfg, ids[:64], seqs[:64], os.path.join(root, "warm"),
            **dict(kw, num_shards=1))
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    out = run_map(params, cfg, ids, seqs, store, **kw)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    batches = out["batches"]
    check(out["outcome"] == "completed", f"map: outcome {out['outcome']}")
    nb = cfg.model.num_blocks
    for name, n in launches.items():
        want = nb * batches if name in (LOCAL_TRACK_SEGMENTS.name,
                                        ATTENTION.name) else 0
        check(n == want, f"map: {name} launched {n} times for {batches} "
                         f"packed batches, want {want}")
    residues = int(np.minimum(lengths, cfg.data.seq_len - 2).sum())
    truncated = int((lengths > cfg.data.seq_len - 2).sum())
    print(f"# neighbors base map [{card}]: {out['seqs']} sequences "
          f"({residues} residues, {truncated} truncated at the "
          f"{cfg.data.seq_len - 2}-residue window) in {out['blocks']} blocks, "
          f"{batches} packed batches of 8 x {cfg.data.seq_len}, wall "
          f"{out['wall_s']} s: {out['seqs'] / out['wall_s']:.1f} sequences/s, "
          f"{residues / out['wall_s']:.0f} residues/s; commit_s "
          f"{out['commit_s']}, overlap_s {out['overlap_s']} (overlap_ratio "
          f"{out['overlap_ratio']}); launches {launches}")
    check(out["overlap_s"] > 0, "map: the pipelined run overlapped nothing")
    rep = verify_store(store)
    quarantine = {}
    for shard in range(2):
        quarantine.update({r["id"]: r["reason"] for r in
                           ShardCursor(store, shard).read_quarantine()})
    print(f"# neighbors base map: verify_store ok {rep['ok']}, complete "
          f"{rep['complete']}, embedded {rep['embedded']}, quarantined "
          f"{quarantine}")
    check(rep["ok"] and rep["complete"] and rep["embedded"] == 8192
          and rep["quarantined"] == 3, f"map: verify_store {rep}")
    check(quarantine == {"UP00017": "empty", "UP04100": "non_string",
                         "UP08000": "invalid_char"},
          f"map: quarantine {quarantine}")
    want = store_digests(store)
    resumed = os.path.join(root, "resumed")
    first = run_map(params, cfg, ids, seqs, resumed,
                    **dict(kw, max_blocks=5))
    second = run_map(params, cfg, ids, seqs, resumed, **kw)
    serial = os.path.join(root, "serial")
    off = run_map(params, cfg, ids, seqs, serial, **dict(kw, pipeline=False))
    same_resumed = store_digests(resumed) == want
    same_serial = store_digests(serial) == want
    print(f"# neighbors base map: stopped after {first['blocks']} blocks "
          f"({first['outcome']}), resumed ({second['outcome']}): store "
          f"digests equal the uninterrupted run's {same_resumed}; "
          f"pipeline=False ({off['outcome']}, wall {off['wall_s']} s, "
          f"overlap_s {off['overlap_s']}): equal {same_serial}")
    check(first["outcome"] == "preempted" and first["blocks"] == 5
          and second["outcome"] == "completed" and same_resumed,
          "map: the resumed store differs from the uninterrupted one")
    check(off["outcome"] == "completed" and same_serial
          and off["overlap_s"] == 0.0,
          "map: the pipeline-off store differs from the pipelined one")
    map_profile(card, params, cfg, ids, seqs, root)
    return store, launches


def index_phase(card: str, store: str, root: str):
    """`# neighbors base index`: `build_index` with its defaults (64
    centroids, 256-vector blocks, seed 0) timed on the host; gates:
    `verify_index` ok, bytes ratio <= 0.30, recall@10 at nprobe 64 (a
    full probe) >= 0.95 against float32 `exact_topk`; records recall@10
    at nprobe 8, the lookup's ms at Q=1 and lookups/s at Q=64 (nprobe 8
    and 64). Returns the index loaded on the card."""
    from proteinbert_tpu_torch.index import build_index, verify_index
    from proteinbert_tpu_torch.index.scorer import (
        NeighborIndex, exact_topk, recall_at_k, store_vectors_in_index_order,
    )

    index_dir = os.path.join(root, "index")
    t0 = time.perf_counter()
    stats = build_index(store, index_dir)
    build_s = time.perf_counter() - t0
    rep = verify_index(index_dir)
    index = NeighborIndex.load(index_dir, device=DEVICE)
    vectors = store_vectors_in_index_order(store)
    lists = np.bincount(index.assign, minlength=index.centroids.shape[0])
    print(f"# neighbors base index [{card}]: build_index {build_s:.2f} s on "
          f"the host ({stats['vectors']} vectors, {stats['blocks']} blocks, "
          f"{index.centroids.shape[0]} centroids, lists {int(lists.min())}-"
          f"{int(lists.max())}), bytes_ratio {stats['bytes_ratio']:.4f}, "
          f"verify_index ok {rep['ok']}; resident on the card "
          f"{index.resident_bytes()} bytes")
    check(rep["ok"], f"index: verify_index {rep}")
    check(stats["bytes_ratio"] <= 0.30,
          f"index: bytes ratio {stats['bytes_ratio']} > 0.30")
    queries = vectors[::32]
    exact = exact_topk(vectors, queries, k=10)
    # Chunks of 8 queries: a full probe gathers every vector per query.
    recall = {}
    for nprobe in (64, 8):
        rows = np.concatenate([index.lookup_rows(queries[i:i + 8], k=10,
                                                 nprobe=nprobe)[1]
                               for i in range(0, len(queries), 8)])
        recall[nprobe] = recall_at_k(rows, exact)
    print(f"# neighbors base index: recall@10 over {len(queries)} queries "
          f"against float32 exact_topk: nprobe 64 (full probe) "
          f"{recall[64]:.4f}, nprobe 8 {recall[8]:.4f}")
    check(recall[64] >= 0.95, f"index: recall@10 at a full probe "
                              f"{recall[64]} < 0.95")
    q1 = vectors[:1]
    t = []
    for _ in range(50):
        t0 = time.perf_counter()
        index.lookup_rows(q1, k=10, nprobe=8)
        t.append((time.perf_counter() - t0) * 1e3)
    line = (f"# neighbors base lookup [{card}]: Q=1 k=10 nprobe 8 "
            f"{statistics.median(t):.3f} ms (median of 50, host wall "
            f"through the answer on the host)")
    q64 = vectors[:64]
    width = index.members.shape[1]
    for nprobe in (8, 64):
        need = 64 * min(nprobe, len(lists)) * width * index.dim * 5
        if need > 24e9:
            # The JAX lookup's gather of every candidate's residual.
            line += (f"; Q=64 nprobe {nprobe} not measured (its gather "
                     f"needs {need / 1e9:.1f} GB)")
            continue
        index.lookup_rows(q64, k=10, nprobe=nprobe)
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            index.lookup_rows(q64, k=10, nprobe=nprobe)
            t.append(time.perf_counter() - t0)
        line += (f"; Q=64 nprobe {nprobe} {64 / statistics.median(t):.0f} "
                 f"lookups/s ({statistics.median(t) * 1e3:.2f} ms a call)")
    print(line)
    return index


def served_neighbors_phase(card: str, params, cfg, index, other,
                           root: str) -> dict:
    """`# neighbors base served`: `Server(index=, nprobe=8)` bucketed and
    ragged on the fp32 arm, telemetry on. 64 `neighbors` requests for
    corpus sequences and the same 64 as `embed` requests are submitted
    before `start()` with every kernel count at 0, so the neighbours and
    the embeds form the same batches. Gates: each served answer equals
    `lookup_one` over that request's own served embed vector, bit for
    bit; the graphs and their pool equal those of the same server without
    an index; the launches are exactly those of the embed batches (6 K1
    or #3 + 6 K2 a batch); `stats()["neighbors"]` counts each outcome;
    HTTP `/v1/neighbors` gives the in-process answer and an invalid `k`
    400; a server whose trunk differs (`other`) raises TrunkMismatchError;
    one without an index, ValueError. Records the neighbours' wall, p50
    and p99 split by trace stage into the embed leg and `lookup`. Returns
    the launches."""
    from proteinbert_tpu_torch import obs
    from proteinbert_tpu_torch.heads import TrunkMismatchError
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, KERNELS, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
    )
    from proteinbert_tpu_torch.serve.http import make_http_server
    from proteinbert_tpu_torch.serve.server import Server

    seqs, _, _ = corpus_rows(64, cfg.model.num_annotations, seed=15)
    totals = {}
    kw = dict(device=DEVICE, buckets=BUCKETS, max_batch=8, max_wait_s=0.005,
              queue_depth=256, cache_size=0, warm_kinds=("embed",),
              pack_max_segments=8)
    nb = cfg.model.num_blocks
    for mode, per_batch in (("bucketed", {LOCAL_TRACK.name: nb,
                                          ATTENTION.name: nb}),
                            ("ragged", {LOCAL_TRACK_SEGMENTS.name: nb,
                                        ATTENTION.name: nb})):
        label = f"{mode} base neighbors"
        gc.collect()
        plain = Server(params, cfg, serve_mode=mode, **kw).start()
        torch.cuda.synchronize()
        want_graphs = plain.dispatcher.executable_count
        want_pool = plain.dispatcher.graph_pool_bytes()
        plain.drain(timeout=300)
        try:
            plain.submit("neighbors", seqs[0])
            check(False, f"{label}: a server without an index answered")
        except ValueError:
            pass
        del plain
        gc.collect()
        events = os.path.join(root, f"events-{mode}.jsonl")
        tele = obs.Telemetry(events_path=events)
        srv = Server(params, cfg, serve_mode=mode, index=index, nprobe=8,
                     telemetry=tele, trace_sample_rate=1.0, **kw)
        srv.dispatcher.warmup(("embed",))
        torch.cuda.synchronize()
        graphs = srv.dispatcher.executable_count
        pool = srv.dispatcher.graph_pool_bytes()
        for k in KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        nf = [srv.submit("neighbors", s) for s in seqs]
        ef = [srv.submit("embed", s) for s in seqs]
        srv.start()
        got = [f.result(timeout=300) for f in nf]
        embeds = [f.result(timeout=300) for f in ef]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS}
        stats = srv.stats()
        batches = stats["batches"]
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
            want = per_batch.get(name, 0) * batches
            check(n == want, f"{label}: {name} launched {n} times for "
                             f"{batches} batches, want {want}")
        check(srv.dispatcher.executable_count == graphs == want_graphs
              and pool == want_pool
              and srv.dispatcher.graph_pool_bytes() == pool,
              f"{label}: graphs {graphs} / {want_graphs}, pool {pool} / "
              f"{want_pool}")
        exact = all(g["neighbors"] == index.lookup_one(e["global"], k=10,
                                                        nprobe=8)
                    for g, e in zip(got, embeds))
        sizes = {len(g["neighbors"]) for g in got}
        print(f"# serve {label} [{card}]: 64 neighbors + 64 embed requests "
              f"in {batches} batches, {wall:.3f} s; launches {launches}; "
              f"{graphs} CUDA graphs, pool {pool} bytes (without an index: "
              f"{want_graphs}, {want_pool}); each answer vs lookup_one over "
              f"its own served embed vector: bit for bit {exact}; answer "
              f"sizes {sorted(sizes)}")
        check(exact and sizes == {10}, f"{label}: a served answer differs "
                                       "from the offline lookup")
        by = stats["neighbors"]["by_outcome"]
        check(by["ok"] == 64 and sum(by.values()) == 64,
              f"{label}: by_outcome {by}")
        httpd = make_http_server(srv, host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/neighbors"
        try:
            status, body = http_post(url, {"seq": seqs[3], "k": 5})
            want = srv.neighbors(seqs[3], k=5, timeout=120)
            bad, bad_body = http_post(url, {"seq": seqs[3], "k": 0})
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(30)
        same = status == 200 and body["neighbors"] == [
            [i, s] for i, s in want["neighbors"]]
        by = srv.stats()["neighbors"]["by_outcome"]
        print(f"# serve {label}: HTTP /v1/neighbors {status}, equals in "
              f"process {same}; k=0 {bad} {bad_body.get('type')}; "
              f"by_outcome {by}")
        check(same and bad == 400 and by["ok"] == 66
              and sum(by.values()) == 66, f"{label}: HTTP or the funnel")
        check(srv.drain(timeout=300), f"{label}: drain timed out")
        tele.close()
        recs = [r for r in obs.read_events(events, strict=True)
                if r["event"] == "serve_request"
                and r.get("kind") == "neighbors"]
        e2e = sorted(r["e2e_s"] for r in recs)
        lookup = sorted(r["stages"].get("lookup", 0.0) for r in recs)
        embed_leg = sorted(r["e2e_s"] - r["stages"].get("lookup", 0.0)
                           - r["stages"].get("finalize", 0.0) for r in recs)

        def pct(xs, q):
            return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] * 1e3

        print(f"# serve {label} [{card}]: {len(recs)} traced neighbours: "
              f"e2e p50 {pct(e2e, .5):.3f} / p99 {pct(e2e, .99):.3f} ms = "
              f"embed leg p50 {pct(embed_leg, .5):.3f} / p99 "
              f"{pct(embed_leg, .99):.3f} ms + lookup p50 "
              f"{pct(lookup, .5):.3f} / p99 {pct(lookup, .99):.3f} ms (+ "
              f"finalize); wall {wall:.3f} s for 128 requests submitted "
              "before start()")
        check(len(recs) == 66 and all("lookup" in r["stages"]
                                      for r in recs),
              f"{label}: {len(recs)} traced neighbours with a lookup stage")
        del srv
    try:
        Server(other, cfg, serve_mode="ragged", index=index, **kw)
        check(False, "a server of another trunk took the index")
    except TrunkMismatchError:
        pass
    print("# serve base neighbors: a server of another trunk -> "
          "TrunkMismatchError; without an index -> ValueError")
    return totals


def neighbors_phase(card: str) -> dict:
    """`# neighbors base`: the `base` trunk in bf16 (random weights from a
    seeded generator) maps a corpus into a store (`map_phase`), the store
    gets its int8 IVF index (`index_phase`), and servers answer
    neighbours from it (`served_neighbors_phase`). The stores and the
    index go to a temporary directory under build/, removed after.
    Returns the launches."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.models.proteinbert import init

    base = get_preset("base")
    params = init(base.model, torch.Generator().manual_seed(14),
                  device=DEVICE)
    other = init(base.model, torch.Generator().manual_seed(15),
                 device=DEVICE)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="neighbors-", dir=build)
    try:
        store, launches = map_phase(card, params, base, root)
        index = index_phase(card, store, root)
        for name, n in served_neighbors_phase(card, params, base, index,
                                              other, root).items():
            launches[name] = launches.get(name, 0) + n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def large_int8_phase(card: str) -> dict:
    """`# serve large int8`: the `large` preset (12 blocks, C=G=1024,
    H=16, 8943 annotations) in bf16, random weights, served bucketed and
    ragged on the fp32 and the int8 arm: buckets 256 / 512 / 1024, one
    batch class (max_batch 8), 8 segments a packed row; 16 embed requests
    of 100-1000 residues submitted before `start()` with every count at
    0. Gates: exactly 12 #2 (bucketed; ragged #4) and 12 K2 (int8:
    K2-int8) per batch, none of the others — on the int8 arm #2 / #4 run
    on track weights dequantized inside the graph and K2-int8 at H=16,
    G=1024; one full batch replayed equals its eager run bit for bit;
    the int8 answers lie off the fp32 ones by a finite, nonzero amount
    (printed). Records `weight_bytes_ratio`, the graph pool's bytes and a
    full batch's wall and busy share. Returns the launches."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.vocab import ALPHABET
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, KERNELS, LOCAL_TRACK_SEGMENTS_TILED,
        LOCAL_TRACK_TILED,
    )
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.server import Server

    large = get_preset("large")
    params = init(large.model, torch.Generator().manual_seed(16),
                  device=DEVICE)
    rnd = random.Random(16)
    seqs = ["".join(rnd.choice(ALPHABET) for _ in range(rnd.randint(100,
                                                                   1000)))
            for _ in range(16)]
    rng = np.random.default_rng(16)
    tokens = rng.integers(4, 26, (8, 1024)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 1, 2
    totals, answers = {}, {}
    for mode, track in (("bucketed", LOCAL_TRACK_TILED),
                        ("ragged", LOCAL_TRACK_SEGMENTS_TILED)):
        for quant, attn in (("fp32", ATTENTION), ("int8", ATTENTION_Q8)):
            label = f"{mode} large{'' if quant == 'fp32' else ' int8'}"
            gc.collect()
            torch.cuda.synchronize()
            srv = Server(params, large, device=DEVICE,
                         buckets=(256, 512, 1024), max_batch=8,
                         batch_classes=((8,) if mode == "bucketed"
                                        else None),
                         max_wait_s=0.005, cache_size=0,
                         warm_kinds=("embed",), serve_mode=mode,
                         pack_max_segments=8, quant=quant,
                         quant_parity_every=0)
            t0 = time.perf_counter()
            srv.dispatcher.warmup(("embed",))
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            pool = srv.dispatcher.graph_pool_bytes()
            for k in KERNELS:
                k.launches = 0
            futures = [srv.submit("embed", s) for s in seqs]
            srv.start()
            got = [f.result(timeout=300) for f in futures]
            check(srv.drain(timeout=300), f"{label}: drain timed out")
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in KERNELS}
            batches = srv.stats()["batches"]
            for name, n in launches.items():
                totals[name] = totals.get(name, 0) + n
                want = (large.model.num_blocks * batches
                        if name in (track.name, attn.name) else 0)
                check(n == want, f"{label}: {name} launched {n} times for "
                                 f"{batches} batches, want {want}")
            check(all(np.isfinite(g["global"]).all()
                      and np.isfinite(g["local_mean"]).all() for g in got),
                  f"{label}: non-finite embeddings")
            answers[(mode, quant)] = got
            report = srv.stats()["quant"]
            ratio = (f"weight_bytes_ratio {report['weight_bytes_ratio']}"
                     if report else "fp32 arm")
            print(f"# serve {label} [{card}]: {ratio}; "
                  f"{srv.dispatcher.executable_count} CUDA graphs captured "
                  f"in {warm_s:.2f} s, their pool holds {pool} bytes "
                  f"({pool / 2**20:.2f} MiB); {len(seqs)} requests in "
                  f"{batches} batches, launches {launches}")
            if mode == "bucketed":
                batch = tokens
                run = lambda: srv.dispatcher.run("embed", tokens)  # noqa
                what = "one embed batch 8x1024"
            else:
                batch = full_ragged_batch(srv)
                run = lambda: srv.dispatcher.run_packed(  # noqa
                    "embed", *batch)
                what = "one packed embed batch 8x1024 (24 segments)"
            replay_equals_eager(label, srv, batch)
            profile_batch(card, f"{label}, {what}", run)
            del srv
    for mode in ("bucketed", "ragged"):
        diff = max(float(np.abs(a[key] - b[key]).max())
                   for a, b in zip(answers[(mode, "int8")],
                                   answers[(mode, "fp32")])
                   for key in ("global", "local_mean"))
        print(f"# serve {mode} large int8: max |int8 - fp32 arm| over the "
              f"{len(seqs)} embeddings {diff:.6e}")
        check(0 < diff < float("inf"), f"{mode} large: the int8 arm "
                                       "answered as the fp32 arm")
    return totals


def main() -> int:
    args = sys.argv[1:]
    if args not in ([], ["--phase", "large"], ["--phase", "base"],
                    ["--phase", "k2"], ["--phase", "default"],
                    ["--phase", "resume"], ["--phase", "serve"],
                    ["--phase", "serve-times"], ["--phase", "finetune"],
                    ["--phase", "neighbors"]):
        print("usage: chip_smoke.py [--phase large|base|k2|default|resume|"
              "serve|serve-times|finetune|neighbors]", file=sys.stderr)
        return 2
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
        for name, regs, spill in ptxas_functions(k.ptxas_log):
            if "wgmma" in name or spill:
                print(f"#     {name}: {regs} registers, spill stores "
                      f"{spill} bytes")
        for line in k.ptxas_log.splitlines():
            if "serialized" in line or "arning" in line:
                print(f"#     ptxas: {line.strip()}")   # e.g. wgmma waits
    if args in (["--phase", "base"], ["--phase", "k2"]):
        base_phase(card)
        return 0
    if args == ["--phase", "default"]:
        default_phase(card)
        return 0
    if args == ["--phase", "resume"]:
        resume_phase(card)
        return 0
    if args == ["--phase", "finetune"]:
        t0 = time.perf_counter()
        task_phases(card)
        print(f"# finetune and predict_task: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "neighbors"]:
        t0 = time.perf_counter()
        neighbors_phase(card)
        print(f"# neighbors: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        large_int8_phase(card)
        print(f"# serve large int8: {time.perf_counter() - t0:.1f} s")
        return 0
    if args in (["--phase", "serve"], ["--phase", "serve-times"]):
        t0 = time.perf_counter()
        serve_phases(card, gates=args[1] == "serve")
        print(f"# serve: {time.perf_counter() - t0:.1f} s")
        return 0
    sass_line(card, (LOCAL_TRACK, LOCAL_TRACK_VALID, LOCAL_TRACK_SEGMENTS,
                     LOCAL_TRACK_SEGMENTS_Q8, LOCAL_TRACK_TILED,
                     LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED_VALID,
                     ATTENTION, ATTENTION_Q8, ONEPASS, ONEPASS_Q8))
    if args:
        # The Large-width local-track kernels alone: gates, times, passes.
        rows = {}
        large_kernel_phase(card, rows)
        valid_kernel_phase(card, rows)
        print_rows(card, rows)
        gemm_yardstick(card)
        return 0

    t0 = time.perf_counter()
    rows = kernel_phase(card)
    packed_kernel_phase(card, rows)
    large_kernel_phase(card, rows)
    valid_kernel_phase(card, rows)
    q8_extra = q8_kernel_phase(card, rows)
    print_rows(card, rows)
    print_q8_rows(card, rows, q8_extra)
    gemm_yardstick(card)
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
    t0 = time.perf_counter()
    for name, n in long_hdf5_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# train long hdf5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in resume_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# resume: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in task_phases(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# finetune and predict_task: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in neighbors_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# neighbors: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in large_int8_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# serve large int8: {time.perf_counter() - t0:.1f} s")

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


