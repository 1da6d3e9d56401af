"""Compile-on-first-use infrastructure for the native components — a copy
of `proteinbert_tpu/native/build.py` that builds the port's own sources.

g++ is in the base image; pybind11 is not, so the ABI is plain extern-"C"
functions over ctypes. Shared objects are cached in `_build/` next to the
sources, keyed by a hash of the source text and compile flags — editing a
.cpp transparently rebuilds, and concurrent builders (pytest-xdist, SLURM
task arrays) race benignly via an atomic rename.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import Optional

logger = logging.getLogger(__name__)

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_SRC_DIR, "_build")
_CXX = os.environ.get("CXX", "g++")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_cache: dict = {}
# Calls into each library (its wrapper adds one per call), so that a run
# can show which path it took.
calls = {"tokenizer": 0, "fasta_index": 0}


def _so_path(name: str, src: str) -> str:
    digest = hashlib.sha256(
        (src + " ".join(_FLAGS) + _CXX).encode()
    ).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"{name}-{digest}.so")


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """CDLL for `<name>.cpp` in this directory, building if needed;
    None (once, logged) when the toolchain is unavailable or the build
    fails — callers then use their Python fallback."""
    if name in _cache:
        return _cache[name]
    lib = None
    try:
        src_path = os.path.join(_SRC_DIR, f"{name}.cpp")
        with open(src_path) as f:
            src = f.read()
        so = _so_path(name, src)
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    [_CXX, *_FLAGS, src_path, "-o", tmp],
                    check=True, capture_output=True, text=True, timeout=120,
                )
                os.chmod(tmp, 0o644)  # mkstemp is 0600: unreadable on
                # shared checkouts, silently demoting other users to the
                # numpy fallback
                os.replace(tmp, so)  # atomic: racing builders both win
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            logger.info("built native %s -> %s", name, so)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning(
            "native %s unavailable (%s); using Python fallback", name, e)
    _cache[name] = lib
    return lib


def native_available(name: str = "tokenizer") -> bool:
    return load_library(name) is not None
