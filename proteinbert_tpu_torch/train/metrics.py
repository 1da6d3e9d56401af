"""FLOP counts, peak rates, step timing and the per-batch metric sums —
port of `proteinbert_tpu/train/metrics.py`.

`forward_flops` is the JAX package's analytic count (2·MACs of every
conv, dense, projection and attention product); training counts 3× the
forward. MFU is reported only on a card named in `PEAK_FLOPS` (published
dense rates, NVIDIA's data sheet); a CPU run reports step time and
residues/s only. `DeviceMetricAccumulator` keeps per-batch metric
tensors on the device and fetches them in one copy a drain (the eval
brackets and the fine-tune loops).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from proteinbert_tpu_torch.configs import ModelConfig

# Peak dense FLOP/s of one card by (name substring, activation dtype):
# the tensor cores in bf16, the CUDA cores in float32 (no TF32).
PEAK_FLOPS = {
    ("H100", "bfloat16"): 989e12,
    ("H100", "float32"): 67e12,
}


def forward_flops(cfg: ModelConfig, batch: int, seq_len: int,
                  nonpad_tokens: Optional[float] = None) -> float:
    """Analytic forward FLOPs (2·MACs) of one batch; `nonpad_tokens`
    (default B·L) scales every L-proportional term."""
    B, L = batch, seq_len
    C, G, A = cfg.local_dim, cfg.global_dim, cfg.num_annotations
    H, k = cfg.num_heads, cfg.key_dim
    v = cfg.value_dim
    K = cfg.narrow_kernel
    T = float(B * L if nonpad_tokens is None else nonpad_tokens)
    per_block = (
        2 * T * K * C * C                  # narrow conv
        + 2 * T * cfg.wide_kernel * C * C  # wide dilated conv
        + 2 * B * G * C                    # global->local broadcast dense
        + 2 * T * C * C                    # local residual dense
        + 2 * B * G * G                    # global dense 1
        + 2 * B * H * G * k                # attention q
        + 2 * T * H * C * k                # attention K
        + 2 * T * H * C * v                # attention V
        + 2 * H * T * k                    # scores
        + 2 * H * T * v                    # weighted sum
        + 2 * B * G * G                    # global dense 2
    )
    io = (
        2 * B * A * G                      # global input dense
        + 2 * T * C * cfg.vocab_size       # local head
        + 2 * B * G * A                    # global head
    )
    return float(cfg.num_blocks * per_block + io)


def train_flops(cfg: ModelConfig, batch: int, seq_len: int,
                nonpad_tokens: Optional[float] = None) -> float:
    return 3.0 * forward_flops(cfg, batch, seq_len, nonpad_tokens)


def peak_flops(device: torch.device, dtype: str) -> Optional[float]:
    """The card's published dense peak for `dtype`, or None (CPU, or a
    card not in the table)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for (pat, dt), val in PEAK_FLOPS.items():
        if pat in name and dt == dtype:
            return val
    return None


def copy_to_host(tensors: List[torch.Tensor]):
    """Queue a copy of each tensor to the host behind the work already
    queued on the current stream → (host tensors, a CUDA event or None).
    On a card the copies go into pinned memory without a host wait, and
    `event.synchronize()` then waits for them alone, not for work queued
    after them (a plain `.cpu()` would wait for that too). CPU tensors
    come back as they are."""
    host, event = [], None
    for t in tensors:
        t = t.detach()
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            event = event or torch.cuda.Event()
            t = h
        host.append(t)
    if event is not None:
        event.record()
    return host, event


class DeviceMetricAccumulator:
    """Sums of per-batch metric dicts without a device-to-host copy per
    value — the JAX accumulator's contract and numerics.

    `add(m, weight, key_fn)` keeps the batch's tensors where they are;
    every `drain_every` adds (0: only at `sums()`) `_drain` stacks the
    pending scalars into one tensor and copies it to the host once, then
    folds `float(v) * weight` into Python-float (float64) sums in add
    order, so the sums are the JAX accumulator's bit for bit given the
    same float32 values. The drain waits for those batches' work, which
    bounds the queue and the held tensors; `drain_every=0` holds every
    batch's scalars until `sums()` (an eval split's worth). `prefetch()`
    queues that copy now, so that a later drain waits for the batches'
    work alone and not for what the stream runs after them. `count` is
    the number of adds."""

    def __init__(self, drain_every: int = 8):
        self.drain_every = drain_every
        self._pending: list = []
        self._sums: Dict[str, float] = {}
        self._copied = None   # (pending count, host tensors, event)
        self.count = 0

    def add(self, m: Dict[str, torch.Tensor], weight: float = 1.0,
            key_fn: Optional[Callable[[str], str]] = None) -> None:
        self._pending.append((m, weight, key_fn))
        self.count += 1
        if self.drain_every and len(self._pending) >= self.drain_every:
            self._drain()

    def _copy_pending(self):
        # One stack and one copy per device the scalars live on (the
        # card's; a host scalar such as a step's `lr` needs none).
        by_device: Dict[torch.device, list] = {}
        for m, _, _ in self._pending:
            for _, v in sorted(m.items()):
                if torch.is_tensor(v):
                    by_device.setdefault(v.device, []).append(v)
        with torch.no_grad():
            stacks = [torch.stack([v.detach().reshape(()) for v in vs])
                      for vs in by_device.values()]
        host, event = copy_to_host(stacks)
        return len(self._pending), dict(zip(by_device, host)), event

    def prefetch(self) -> None:
        """Queue the pending scalars' copy to the host now."""
        if self._pending:
            self._copied = self._copy_pending()

    def _drain(self) -> None:
        if not self._pending:
            return
        copied, self._copied = self._copied, None
        if copied is None or copied[0] != len(self._pending):
            copied = self._copy_pending()
        _, host, event = copied
        if event is not None:
            event.synchronize()
        fetched = {dev: iter(h.tolist()) for dev, h in host.items()}
        for m, w, key_fn in self._pending:
            # Keys in sorted order, as JAX's device_get returns a dict.
            for k, v in sorted(m.items()):
                v = next(fetched[v.device]) if torch.is_tensor(v) else v
                key = key_fn(k) if key_fn else k
                self._sums[key] = self._sums.get(key, 0.0) + float(v) * w
        self._pending = []

    def sums(self) -> Dict[str, float]:
        self._drain()
        return dict(self._sums)


class StepTimer:
    """Wall clock → steps/s, step ms, residues/s/chip (B·L positions a
    step of this rank, pad included) and, on a card in `PEAK_FLOPS`, MFU — the JAX
    `StepTimer`'s keys and accounting (`proteinbert_tpu/train/metrics.py`).

    `update()` once per step; the first `warmup_steps` are excluded (two,
    as in JAX: the first step pays allocation and cuDNN's algorithm
    choice, and the log records carry the JAX stream's keys from the same
    step on). `sync()` waits for the device and extends the
    measured window to now; `discount()` removes non-training time (an
    eval, a blocking save) from it; `overlap()` records boundary seconds
    that ran hidden behind training (a staged checkpoint's copy and
    write) without moving the anchors, so `summary()` reports them as
    `overlap_s` / `window_overlap_s`. Each `summary()` gives the
    cumulative rates and `window_*` rates over the steps since the
    previous `summary()`, whose anchor it advances: call it once per log
    cadence. A CPU run reports no MFU: no number from the CPU is given
    a device metric's name."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 device: torch.device, warmup_steps: int = 2):
        self.flops_per_step = train_flops(cfg, batch, seq_len)
        self.residues_per_step = batch * seq_len
        self.device = device
        self.peak = peak_flops(device, cfg.dtype)
        self.warmup_steps = warmup_steps
        self._count = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._steps_timed = 0
        # Window anchor: None means "window starts at _t0".
        self._win_t: Optional[float] = None
        self._win_steps = 0
        self._overlap_s = 0.0
        self._win_overlap_s = 0.0

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def update(self) -> None:
        self._count += 1
        if self._count == self.warmup_steps:
            self._wait()
            self._t0 = time.perf_counter()
        elif self._count > self.warmup_steps:
            self._steps_timed = self._count - self.warmup_steps
            self._t_last = time.perf_counter()

    def sync(self) -> None:
        """Wait for the device, then extend the window to now; before any
        timed step, re-anchor its start instead (the wait was warm-up
        work)."""
        if self._t0 is None:
            return
        self._wait()
        if self._steps_timed:
            self._t_last = time.perf_counter()
        else:
            self._t0 = time.perf_counter()

    def discount(self, seconds: float) -> None:
        if self._t0 is not None:
            self._t0 += seconds
            if self._win_t is not None:
                self._win_t += seconds

    def overlap(self, seconds: float) -> None:
        if seconds > 0:
            self._overlap_s += seconds
            self._win_overlap_s += seconds

    def _rates(self, steps: int, dt: float, prefix: str) -> Dict[str, float]:
        steps_per_sec = steps / dt
        out = {
            f"{prefix}steps_per_sec": steps_per_sec,
            f"{prefix}step_ms": 1000.0 / steps_per_sec,
            f"{prefix}residues_per_sec_per_chip": steps_per_sec
            * self.residues_per_step,
        }
        if self.peak:
            out[f"{prefix}mfu"] = (steps_per_sec * self.flops_per_step
                                   / self.peak)
        return out

    def summary(self) -> Dict[str, float]:
        if not self._steps_timed or self._t0 is None:
            return {}
        out = self._rates(self._steps_timed, self._t_last - self._t0, "")
        win_steps = self._steps_timed - self._win_steps
        win_dt = self._t_last - (self._win_t if self._win_t is not None
                                 else self._t0)
        if win_steps > 0 and win_dt > 0:
            out.update(self._rates(win_steps, win_dt, "window_"))
        if self._overlap_s:
            out["overlap_s"] = self._overlap_s
            out["window_overlap_s"] = self._win_overlap_s
        self._win_t = self._t_last
        self._win_steps = self._steps_timed
        self._win_overlap_s = 0.0
        return out
