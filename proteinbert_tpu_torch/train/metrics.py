"""FLOP counts, peak rates and step timing — port of
`proteinbert_tpu/train/metrics.py`.

`forward_flops` is the JAX package's analytic count (2·MACs of every
conv, dense, projection and attention product); training counts 3× the
forward. MFU is reported only on a card named in `PEAK_FLOPS` (published
dense rates, NVIDIA's data sheet); a CPU run reports step time and
tokens/s only.
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
    """Wall clock → step ms, tokens/s (B·L positions a step) and, on a
    card in `PEAK_FLOPS`, MFU. `update()` once per step; the first
    `warmup_steps` are excluded (the port compiles nothing, so one step
    covers allocation and cuDNN's algorithm choice). `sync()` waits for
    the device and extends the measured window to now; `discount()`
    removes non-training time (an eval)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 device: torch.device, warmup_steps: int = 1):
        self.flops_per_step = train_flops(cfg, batch, seq_len)
        self.tokens_per_step = batch * seq_len
        self.device = device
        self.peak = peak_flops(device, cfg.dtype)
        self.warmup_steps = warmup_steps
        self._count = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._timed = 0

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def update(self) -> None:
        self._count += 1
        if self._count == self.warmup_steps:
            self._wait()
            self._t0 = time.perf_counter()
        elif self._count > self.warmup_steps:
            self._timed = self._count - self.warmup_steps

    def sync(self) -> None:
        self._wait()
        if self._timed:
            self._t_last = time.perf_counter()

    def discount(self, seconds: float) -> None:
        if self._t0 is not None:
            self._t0 += seconds

    def summary(self) -> Dict[str, float]:
        if not self._timed or self._t_last is None:
            return {}
        steps_per_sec = self._timed / (self._t_last - self._t0)
        out = {"steps_timed": float(self._timed),
               "step_ms": 1000.0 / steps_per_sec,
               "tokens_per_sec": steps_per_sec * self.tokens_per_step}
        if self.peak:
            out["mfu"] = steps_per_sec * self.flops_per_step / self.peak
        return out
