"""ctypes wrapper for the C++ .fai builder (fasta_index.cpp) — a copy of
`proteinbert_tpu/native/fasta_index.py`."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from proteinbert_tpu_torch.native.build import calls, load_library

_configured = False

_ABI_VERSION = 2  # must match pbt_fai_abi_version() and the argtypes below

_ERR_IO = -1
_ERR_NON_UNIFORM = -2
_NAME_CAP = 4096


def _lib():
    global _configured
    lib = load_library("fasta_index")
    if lib is not None and not _configured:
        got = lib.pbt_fai_abi_version()
        if got != _ABI_VERSION:
            raise RuntimeError(
                f"native fasta_index ABI {got} != expected {_ABI_VERSION}; "
                "update fasta_index.py's argtypes and _ABI_VERSION together")
        lib.pbt_build_fai.restype = ctypes.c_int64
        lib.pbt_build_fai.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int64,
        ]
        _configured = True
    return lib


def build_fai_native(fasta_path: str, fai_path: str) -> Optional[int]:
    """Write the .fai via the C++ scanner; returns the record count, or
    None when the native library is unavailable (callers fall back to the
    Python loop in etl/fasta.build_index).

    Raises ValueError on ragged (non-uniformly wrapped) records — the
    same condition AND message shape as the Python path (record name, or
    None for ragged data before the first header).
    """
    lib = _lib()
    if lib is None:
        return None
    had_header = ctypes.c_int32(0)
    err_name = ctypes.create_string_buffer(_NAME_CAP)
    rc = lib.pbt_build_fai(
        os.fsencode(fasta_path), os.fsencode(fai_path),
        ctypes.byref(had_header), err_name, _NAME_CAP)
    calls["fasta_index"] += 1
    if rc == _ERR_NON_UNIFORM:
        name = err_name.value.decode(errors="replace") \
            if had_header.value else None
        raise ValueError(
            f"record {name!r} in {fasta_path} has non-uniform "
            "line widths; re-wrap the FASTA before indexing")
    if rc == _ERR_IO:
        raise OSError(f"native .fai build failed for {fasta_path}")
    return int(rc)
