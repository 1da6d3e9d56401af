"""FLOP counts, peak rates and step timing — port of
`proteinbert_tpu/train/metrics.py`.

`forward_flops` is the JAX package's analytic count (2·MACs of every
conv, dense, projection and attention product); training counts 3× the
forward. MFU is reported only on a card named in `PEAK_FLOPS` (published
dense rates, NVIDIA's data sheet); a CPU run reports step time and
residues/s only. `DeviceMetricAccumulator` is not ported: the port's eval
bracket stays synchronous.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

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
