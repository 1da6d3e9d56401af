"""ctypes wrapper for the C++ batch tokenizer (tokenizer.cpp) — a copy of
`proteinbert_tpu/native/tokenizer.py`."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from proteinbert_tpu_torch.data.vocab import get_vocab
from proteinbert_tpu_torch.native.build import calls, load_library

_configured = False


_ABI_VERSION = 2  # must match pbt_abi_version() and the argtypes below


def _lib():
    global _configured
    lib = load_library("tokenizer")
    if lib is not None and not _configured:
        lib.pbt_abi_version.restype = ctypes.c_int32  # explicit, not c_int
        got = lib.pbt_abi_version()
        if got != _ABI_VERSION:
            # Loud and permanent: stale argtypes against a changed C
            # signature would corrupt memory, not degrade gracefully.
            raise RuntimeError(
                f"native tokenizer ABI {got} != expected {_ABI_VERSION}; "
                "update tokenizer.py's argtypes and _ABI_VERSION together")
        lib.pbt_tokenize_batch.restype = None
        lib.pbt_tokenize_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        _configured = True
    return lib


def tokenize_batch_native(
    seqs: Sequence[str],
    seq_len: int,
    crop_seed: Optional[int] = None,
    row_ids: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """(B, seq_len) int32 batch via the C++ kernel, or None when the
    native library is unavailable (callers fall back to the numpy path).

    Matches transforms.tokenize_batch BIT-FOR-BIT: long rows take the
    counter-based window splitmix64(crop_seed + row_id) when `crop_seed`
    is given (transforms.crop_starts computes the same formula in numpy),
    else head-truncated.
    """
    lib = _lib()
    if lib is None:
        return None
    joined = "".join(seqs).encode("ascii", errors="replace")
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    out = np.empty((len(seqs), seq_len), dtype=np.int32)
    buf = np.frombuffer(joined, dtype=np.uint8) if joined else np.zeros(1, np.uint8)
    lut = get_vocab()._lut
    if row_ids is None:
        row_ids = np.arange(len(seqs), dtype=np.int64)
    else:
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int64)
    lib.pbt_tokenize_batch(
        buf.ctypes.data, offsets.ctypes.data,
        len(seqs), seq_len, lut.ctypes.data,
        (crop_seed or 0) & 0xFFFFFFFFFFFFFFFF,
        1 if crop_seed is not None else 0,
        row_ids.ctypes.data,
        out.ctypes.data,
    )
    calls["tokenizer"] += 1
    return out
