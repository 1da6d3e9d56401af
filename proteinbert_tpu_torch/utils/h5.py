"""Out-of-core HDF5 helpers — a copy of `proteinbert_tpu/utils/h5.py`
(jax-free; the port never imports the JAX package).

A chunked matrix transpose with fsync flushes, for reorienting feature
matrices too large to load, plus the small numpy helpers the data path
uses. `h5py` is imported by the caller (a dataset opens the file), so
this module needs only numpy (and scipy for the QR helper).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def flush_h5_file(h5f) -> None:
    """Flush library buffers AND fsync the OS file (reference
    shared_utils/util.py:948-951) so a crash mid-ETL loses one chunk at
    most."""
    h5f.flush()
    fd = h5f.id.get_vfd_handle()
    if isinstance(fd, int):
        os.fsync(fd)


def transpose_dataset(
    h5f,
    src_name: str,
    dst_name: str,
    chunk_rows: int = 4096,
    flush_every: int = 8,
    dtype: Optional[np.dtype] = None,
) -> None:
    """dst[j, i] = src[i, j], streamed `chunk_rows` source rows at a time
    (reference shared_utils/util.py:591-615). Works for datasets far
    larger than RAM; column-slab writes land in dst's chunk cache."""
    src = h5f[src_name]
    n, m = src.shape
    dst = h5f.create_dataset(
        dst_name, shape=(m, n), dtype=dtype or src.dtype,
        chunks=(min(m, chunk_rows), min(n, chunk_rows)),
    )
    for k, lo in enumerate(range(0, n, chunk_rows)):
        hi = min(lo + chunk_rows, n)
        dst[:, lo:hi] = src[lo:hi, :].T
        if flush_every and (k + 1) % flush_every == 0:
            flush_h5_file(h5f)
    flush_h5_file(h5f)


def normalize(x: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    """L2-normalize along `axis` (reference shared_utils/util.py:509-520)."""
    x = np.asarray(x, dtype=np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), eps)


def random_mask(shape, p: float, rng: np.random.Generator) -> np.ndarray:
    """Bool mask, True w.p. p (reference shared_utils/util.py:523-535)."""
    return rng.random(shape) < p


def find_linearly_independent_columns(
    x: np.ndarray, tol: float = 1e-8
) -> list:
    """Indices of a maximal linearly-independent column subset via rank-
    revealing QR (reference's Gram-Schmidt loop at
    shared_utils/util.py:554-588, done with lapack instead)."""
    from scipy.linalg import qr

    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        return []
    _, r, piv = qr(x, mode="economic", pivoting=True)
    diag = np.abs(np.diag(r)) if r.ndim == 2 else np.abs(r[:1])
    rank = int((diag > tol * (diag[0] if diag.size else 1.0)).sum())
    return sorted(piv[:rank].tolist())
