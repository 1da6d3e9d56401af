"""Training-loop failure detection — the NaN halt of
`proteinbert_tpu/train/resilience.py` (`NonFiniteLossError`,
`check_finite`), copied: the port imports nothing of the JAX package.

`check_finite` is host-side NaN/Inf detection on the logged metrics,
already fetched to floats. `pretrain` calls it at each log point unless
`cfg.train.on_nan == "off"`: it raises `NonFiniteLossError` under "halt"
(the default) and logs a warning and continues under "warn". The JAX
trainer first saves a diagnostic checkpoint; the port has no checkpointer
yet, so nothing is saved.
"""

from __future__ import annotations

import logging
import math
from typing import Dict

logger = logging.getLogger(__name__)


class NonFiniteLossError(RuntimeError):
    """Loss or grad norm went NaN/Inf."""


def check_finite(metrics: Dict[str, float], step: int, mode: str = "halt",
                 keys=("loss", "grad_norm")) -> bool:
    """True if the watched metrics are finite. On failure: raises
    NonFiniteLossError (mode='halt'), warns (mode='warn'), or just
    returns False (mode='quiet' — the caller decides)."""
    bad = [k for k in keys if k in metrics and not math.isfinite(metrics[k])]
    if not bad:
        return True
    if mode == "quiet":
        return False
    msg = (f"non-finite {'/'.join(bad)} at step {step}: "
           f"{ {k: metrics[k] for k in bad} }")
    if mode == "halt":
        raise NonFiniteLossError(msg)
    logger.warning("%s (on_nan=warn: continuing)", msg)
    return False
