#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. build    — nvcc builds every kernel of the path from `proteinbert_tpu_torch/csrc/`
              (one process per source, in parallel) for sm_90a.
2. kernels  — each kernel's wrapper against its plain PyTorch version on the
              card, at serving shapes (B=8, L in {128, 512}, C=G=512, H=8, k=64),
              in bfloat16 and float32 (TF32 off for matmul and cuDNN), with
              padded, all-pad and S=8 segment cases for the attention, plus
              the narrower widths C=128/256 at a ragged L=100. Prints
              max |kernel - plain| against its tolerance, kernel and plain ms
              (CUDA events, median of 25), the bound and launches per call.
3. reference — a base-width float32 trunk through the kernels on the card
              against the plain path on the CPU, on a small input.
4. serve    — the base preset (6 blocks, C=G=512, 8943 annotations, seq_len
              512, bf16) with random weights from a seeded torch.Generator,
              behind `Server` with buckets (128, 256, 512) and max_batch 8;
              24 mixed requests from 4 threads, then drain. Checks every
              answer, that each kernel launched 6 times per dispatched batch,
              and that each embed answer matches the same sequence run alone.
   Then a torch.profiler breakdown of one served 8x512 batch.
5. report   — the kernel JSON line, the card's name and power limit, and the
              result line {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
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
TOL = {("local_track", torch.float32): 1e-4,
       ("local_track", torch.bfloat16): 0.0625,
       ("global_attention", torch.float32): 1e-4,
       ("global_attention", torch.bfloat16): 0.03125}
REF_TOL = 1e-3        # float32 trunk, 2 blocks: kernels vs CPU plain path
SERVE_EMBED_TOL = 0.05  # bf16 trunk: served batch row vs the row run alone
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
            want = attention_oh_reference(attn, x, gs,
                                          (seg[..., None] == ids).float())
            torch.cuda.synchronize()
            check(bool((got[:, S - 1] == 0).all()),
                  "empty segment not exactly zero")
            err = (got.float() - want.float()).abs().max().item()
            rows[("global_attention", dtype, L, "S=8")] = (
                err, None, None, None, None, None)

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

    print(f"{'kernel':17s} {'dtype':9s} {'L':>4s} {'case':6s} "
          f"{'max_abs_err':>12s} {'tol':>8s} {'ms':>9s} {'plain_ms':>9s} "
          f"{'bound_ms':>9s}  bound_by   launches/call  [{card}]")
    for (name, dtype, L, case), (err, ms, plain, b_ms, b_by,
                                 per_call) in rows.items():
        tol = TOL[(name, dtype)]
        fmt = (lambda v: f"{v:9.4f}" if v is not None else f"{'-':>9s}")
        print(f"{name:17s} {str(dtype)[6:]:9s} {L:4d} {case:6s} "
              f"{err:12.3e} {tol:8.1e} {fmt(ms)} {fmt(plain)} {fmt(b_ms)}  "
              f"{b_by or '-':10s} {per_call if per_call is not None else '-'}")
        check(err <= tol, f"{name} {dtype} L={L} {case}: max_abs_err {err} "
                          f"> {tol}")
    return rows


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


# ------------------------------------------------------------ phase 4

def serve_phase(card: str):
    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.vocab import ALPHABET
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.dispatch import KINDS
    from proteinbert_tpu_torch.serve.server import Server

    cfg = get_preset("base")
    buckets = (128, 256, 512)
    params = init(cfg.model, torch.Generator().manual_seed(0), device=DEVICE)
    srv = Server(params, cfg, device=DEVICE, buckets=buckets, max_batch=8,
                 max_wait_s=0.005, queue_depth=64, cache_size=256,
                 warm_kinds=KINDS)
    t0 = time.perf_counter()
    srv.start()
    print(f"# serve: base preset, warmup {time.perf_counter() - t0:.2f} s")

    rnd = random.Random(0)
    reqs = []
    for i in range(24):
        n = rnd.randint(20, 500)
        seq = "".join(rnd.choice(ALPHABET) for _ in range(n))
        kind = KINDS[i % 3]
        if kind == "predict_residues":
            pos = rnd.sample(range(n), 3)
            seq = "".join("?" if j in pos else c for j, c in enumerate(seq))
        reqs.append((kind, seq))
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
    threads = [threading.Thread(target=client, args=(range(j, 24, 4),))
               for j in range(4)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    check(not any(t.is_alive() for t in threads), "client threads hung")
    check(srv.drain(timeout=300), "drain timed out")
    wall = time.perf_counter() - t_start
    results = [f.result(timeout=0) for f in futures]
    latency = [b - a for a, b in zip(submitted, finished)]
    launches = {k.name: k.launches for k in KERNELS}
    stats = srv.stats()
    batches = stats["batches"]
    print(f"# serve: {len(reqs)} requests in {batches} batches, launches "
          f"{launches}")
    check(stats["completed"] == len(reqs), f"completed {stats['completed']}")
    for name, n in launches.items():
        check(n >= 6 * batches and n > 0,
              f"{name} launched {n} times for {batches} batches")

    A = cfg.model.num_annotations
    embeds = []
    for (kind, seq), res in zip(reqs, results):
        if kind == "embed":
            check(res["global"].shape == (cfg.model.global_dim,)
                  and res["local_mean"].shape == (cfg.model.local_dim,),
                  "embed shapes")
            check(all(np.isfinite(v).all() for v in res.values()),
                  "embed non-finite")
            embeds.append((seq, res))
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

    worst = 0.0
    for seq, res in embeds:
        alone = inference.embed(params, cfg, [seq], batch_size=1,
                                bucketed=True, buckets=buckets,
                                device=DEVICE)
        for k in ("global", "local_mean"):
            worst = max(worst, float(np.abs(alone[k][0] - res[k]).max()))
    print(f"# serve: embed served vs alone max_abs_err {worst:.3e} "
          f"(tol {SERVE_EMBED_TOL})")
    check(worst <= SERVE_EMBED_TOL, f"served embed vs alone: {worst}")

    lat = sorted(latency)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
    print(f"# serve [{card}]: {len(reqs) / wall:.2f} requests/s, "
          f"p50 {p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms "
          f"(client-side, {len(reqs)} requests, 4 threads)")
    profile_batch(srv, card)
    return launches


def profile_batch(srv, card: str) -> None:
    """Where one full served batch's time goes: torch.profiler over one
    embed batch of 8 x 512 tokens through the server's dispatcher — device
    time by kernel name, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    tokens = rng.integers(4, 26, (8, 512)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 1, 2
    walls = []
    for _ in range(5):  # unprofiled: the profiler slows the host side
        t0 = time.perf_counter()
        srv.dispatcher.run("embed", tokens)  # ends in a device→host copy
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        srv.dispatcher.run("embed", tokens)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + ms)
    busy = sum(t for _, t in by_name.values())
    if not by_name:
        print("# profile: the profiler recorded no device time (device "
              "breakdown not measured)")
        return
    print(f"# profile [{card}]: one embed batch 8x512 (base preset), wall "
          f"{wall_ms:.3f} ms (median of 5, unprofiled), device busy "
          f"{busy:.3f} ms (profiled run; {100 * busy / wall_ms:.1f}% of wall)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"#   {t:9.3f} ms {100 * t / busy:5.1f}%  x{n:<4d} {name[:80]}")
    print("# profile: host ops by self CPU time (profiled, so inflated; "
          "shares only)")
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"#   host {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<4d} {e.key[:70]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from proteinbert_tpu_torch.kernels import ATTENTION, KERNELS, LOCAL_TRACK
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
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   {k.name}: {line.strip()}")

    rows = kernel_phase(card)
    reference_phase()
    launches = serve_phase(card)

    sources = {LOCAL_TRACK.name: ("proteinbert_tpu_torch/csrc/local_track.cu",
                                  "proteinbert_tpu/kernels/fused_block.py:804"),
               ATTENTION.name: ("proteinbert_tpu_torch/csrc/global_attention.cu",
                                "proteinbert_tpu/kernels/attention.py:319")}
    report = []
    for k in KERNELS:
        err, ms, plain, b_ms, b_by, _ = rows[(k.name, torch.bfloat16, 512,
                                              "dense")]
        src, tpu = sources[k.name]
        report.append({"name": k.name, "route": "cuda", "source": src,
                       "replaces": tpu, "launches": launches[k.name],
                       "max_abs_err": err, "ms": ms, "plain_ms": plain,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None, "status": "ported",
                       "shape": "B=8 L=512 C=G=512 H=8 k=64 bf16"})
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
