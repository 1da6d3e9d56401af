"""Device profiling for the port's CLI (`pretrain --profile-dir`).

The counterpart of `device_trace` in `proteinbert_tpu/utils/profiling.py`,
which wraps `jax.profiler`: here `torch.profiler` records the host's
operators and, on a card, the CUDA kernels (CUPTI), and writes one
Chrome-trace JSON into the directory (open with ui.perfetto.dev or
chrome://tracing). The JAX module's other helpers (`TimeMeasure`,
`Profiler`, `monitor_memory`, ...) are not ported yet.
"""

from __future__ import annotations

import contextlib
import os

import torch

from proteinbert_tpu_torch.utils.logging import log


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a `torch.profiler` trace of the block to
    `<log_dir>/trace_<pid>.json`. The CUDA activity is recorded when a
    card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        log(f"device trace written to {path}")
