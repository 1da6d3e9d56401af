"""Timestamped logging (reference C20: shared_utils/util.py:25-54, redone).

The reference maintains two parallel logging systems — a vendored `log()`
writing to stdout + an optional pid-stamped file, and stdlib `logging`
configured by its entry script. Here there is ONE: `log()` forwards into a
stdlib logger (`proteinbert_tpu_torch`), and `start_log()` attaches the
timestamped stream/file handlers. Everything composes with user logging
config instead of fighting it.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LOGGER = logging.getLogger("proteinbert_tpu_torch")
_FMT = "[%(asctime)s] %(message)s"


def log(message, level: int = logging.INFO, **_ignored) -> None:
    """Timestamped log line (reference shared_utils/util.py:25-40)."""
    if not _LOGGER.handlers and not logging.getLogger().handlers:
        start_log()
    _LOGGER.log(level, message)


def start_log(
    log_dir: Optional[str] = None,
    log_file_prefix: str = "log",
    pid_stamp: bool = True,
    level: int = logging.INFO,
) -> Optional[str]:
    """Attach stream (+ optional pid-stamped file) handlers (reference
    shared_utils/util.py:43-54). Returns the log-file path if any."""
    _LOGGER.setLevel(level)
    _LOGGER.propagate = False
    if not any(isinstance(h, logging.StreamHandler) and not
               isinstance(h, logging.FileHandler) for h in _LOGGER.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FMT))
        _LOGGER.addHandler(sh)
    path = None
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        name = (f"{log_file_prefix}.{os.getpid()}.log" if pid_stamp
                else f"{log_file_prefix}.log")
        path = os.path.abspath(os.path.join(log_dir, name))
        # Idempotent: a repeated start_log() with the same log_dir must
        # not attach a SECOND FileHandler for the same file (every line
        # was written twice per extra call — e.g. cli main()'s start_log
        # followed by a library consumer calling it again).
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == path
                   for h in _LOGGER.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(_FMT))
            _LOGGER.addHandler(fh)
    return path
