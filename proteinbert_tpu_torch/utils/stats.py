"""Statistics helpers (reference C22 parity, the parts worth keeping) — a
copy of `proteinbert_tpu/utils/stats.py`.

The reference vendors a large stats/plot grab-bag (reference
shared_utils/util.py:697-1105). The numeric pieces are reimplemented here
with scipy/numpy; plotting wrappers are provided behind a lazy matplotlib
import (matplotlib is optional in this image). The reference's
`as_hot_encoding` forgets its return statement (reference
shared_utils/util.py:538-551, SURVEY ledger #12) — `one_hot` here
actually returns.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np


def one_hot(labels: Sequence, num_classes: Optional[int] = None) -> np.ndarray:
    """(N, num_classes) 0/1 matrix (fixes reference ledger #12)."""
    labels = np.asarray(labels, dtype=np.int64)
    if labels.size and labels.min() < 0:
        raise ValueError("labels must be non-negative")
    k = num_classes if num_classes is not None else (int(labels.max()) + 1
                                                    if labels.size else 0)
    if labels.size and labels.max() >= k:
        raise ValueError(
            f"label {int(labels.max())} out of range for {k} classes")
    out = np.zeros((len(labels), k), dtype=np.float32)
    if labels.size:
        out[np.arange(len(labels)), labels] = 1.0
    return out


def drop_redundant_columns(x: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    """Keep a maximal linearly-independent column subset — the dummy-
    variable-trap / quasi-separation guard of the reference's regression
    helpers (reference shared_utils/util.py:697-872), reduced to its
    numeric core."""
    from proteinbert_tpu_torch.utils.h5 import find_linearly_independent_columns

    return np.asarray(x)[:, find_linearly_independent_columns(x, tol)]


def benjamini_hochberg(pvals: Sequence[float]) -> np.ndarray:
    """FDR-adjusted q-values (reference shared_utils/util.py:888-898)."""
    p = np.asarray(pvals, dtype=np.float64)
    n = p.size
    if n == 0:
        return p
    order = np.argsort(p)
    ranked = p[order] * n / np.arange(1, n + 1)
    # enforce monotonicity from the largest rank down
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.minimum(ranked, 1.0)
    return out


def benjamini_hochberg_with_nulls(
    pvals: Sequence[float], alpha: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """NaN-tolerant FDR adjustment (reference
    shared_utils/util.py:888-898, `multipletests_with_nulls`).

    Entries that are NaN (e.g. tests that could not be run) are excluded
    from the BH ranking — so they neither consume rank slots nor dilute
    the correction for the real p-values — and come back as
    (significance=False, qval=NaN). Returns ``(significance, qvals)``
    where ``significance = qvals <= alpha`` on the non-null subset,
    matching statsmodels' ``multipletests(..., method='fdr_bh')``
    convention the reference delegates to."""
    p = np.asarray(pvals, dtype=np.float64)
    significance = np.zeros(p.shape, dtype=bool)
    qvals = np.full(p.shape, np.nan)
    mask = ~np.isnan(p)
    if mask.any():
        q = benjamini_hochberg(p[mask])
        qvals[mask] = q
        significance[mask] = q <= alpha
    return significance, qvals


def fisher_enrichment(
    n_overlap: int, n_set1: int, n_set2: int, n_total: int,
) -> Tuple[float, float]:
    """(odds_ratio, p_value) of the overlap of two sets under a universe
    of n_total, one-sided greater — the reference's enrichment test
    (reference shared_utils/util.py:901-937)."""
    from scipy.stats import fisher_exact

    a = n_overlap
    b = n_set1 - n_overlap
    c = n_set2 - n_overlap
    d = n_total - n_set1 - n_set2 + n_overlap
    if min(a, b, c, d) < 0:
        raise ValueError(
            f"inconsistent counts: overlap={n_overlap} set1={n_set1} "
            f"set2={n_set2} total={n_total}")
    odds, p = fisher_exact([[a, b], [c, d]], alternative="greater")
    return float(odds), float(p)


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover - matplotlib is optional
        raise ImportError(
            "plot helpers need matplotlib, which is optional in this "
            "environment") from e


def qq_plot(pvals: Sequence[float], out_path: str) -> None:
    """Observed vs expected -log10(p) (reference
    shared_utils/util.py:968-1020), written to `out_path`."""
    plt = _plt()
    p = np.sort(np.asarray(pvals, dtype=np.float64))
    p = np.clip(p, 1e-300, 1.0)
    n = p.size
    if n == 0:
        raise ValueError("qq_plot needs at least one p-value")
    exp = -np.log10((np.arange(1, n + 1) - 0.5) / n)
    obs = -np.log10(p)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(exp, obs, ".", ms=3)
    lim = max(exp.max(), obs.max()) * 1.05
    ax.plot([0, lim], [0, lim], "r--", lw=1)
    ax.set_xlabel("expected -log10(p)")
    ax.set_ylabel("observed -log10(p)")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def scatter_plot(x, y, out_path: str, xlabel: str = "", ylabel: str = "") -> None:
    """Basic labeled scatter (reference shared_utils/util.py:1023-1105)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(np.asarray(x), np.asarray(y), ".", ms=3)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def manhattan_plot(
    chrom_labels: Sequence, positions: Sequence[int],
    pvals: Sequence[float], out_path: str,
) -> None:
    """-log10(p) by genomic position, chromosomes concatenated on the x
    axis in alternating shades (reference shared_utils/util.py:968-1105's
    Manhattan variant). `chrom_labels` groups the points; groups are laid
    out in first-appearance order."""
    plt = _plt()
    chrom_labels = list(chrom_labels)
    positions = np.asarray(positions, dtype=np.float64)
    logs = -np.log10(np.clip(np.asarray(pvals, np.float64), 1e-300, 1.0))
    if not (len(chrom_labels) == positions.size == logs.size):
        raise ValueError("chrom_labels, positions, pvals must align")

    # Group by label via dict lookup (one O(n) pass, insertion-ordered).
    # Deliberately NOT numpy `==`: a NaN label from a pandas column would
    # match nothing under eq (nan != nan) and crash on an empty group,
    # while dict hashing groups identical objects fine.
    groups: dict = {}
    for i, c in enumerate(chrom_labels):
        groups.setdefault(c, []).append(i)
    fig, ax = plt.subplots(figsize=(8, 3))
    offset = 0.0
    ticks, tick_labels = [], []
    for g, (c, idx_list) in enumerate(groups.items()):
        idx = np.asarray(idx_list)
        pos = positions[idx]
        span = pos.max() - pos.min() + 1
        ax.plot(pos - pos.min() + offset, logs[idx], ".", ms=2,
                color=("tab:blue", "tab:gray")[g % 2])
        ticks.append(offset + span / 2)
        tick_labels.append(str(c))
        offset += span
    ax.set_xticks(ticks, tick_labels, rotation=90, fontsize=6)
    ax.set_ylabel("-log10(p)")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def write_excel(sheets: dict, out_path: str, fallback_csv: bool = True) -> list:
    """Write {sheet_name: DataFrame} to one .xlsx (reference
    shared_utils/util.py:794-805). An xlsx engine (openpyxl/xlsxwriter) is
    optional in this image; with `fallback_csv` the sheets are written as
    `<out_path>.<sheet>.csv` instead when no engine exists. Returns the
    list of paths written."""
    import pandas as pd

    try:
        with pd.ExcelWriter(out_path) as writer:
            for name, df in sheets.items():
                pd.DataFrame(df).to_excel(writer, sheet_name=str(name))
        return [out_path]
    except ImportError:
        if not fallback_csv:
            raise ImportError(
                "write_excel needs openpyxl or xlsxwriter (optional in "
                "this environment); pass fallback_csv=True for CSVs")
        paths = []
        for name, df in sheets.items():
            p = f"{out_path}.{name}.csv"
            pd.DataFrame(df).to_csv(p)
            paths.append(p)
        return paths


@functools.lru_cache(maxsize=4)
def _build_chain_index(chain_file: str):
    from pyliftover import LiftOver

    return LiftOver(chain_file)


def _chain_index(chain_file: str):
    """Cached pyliftover.LiftOver per chain file — construction parses
    and indexes the whole UCSC chain (seconds), and the natural caller
    loops liftover_positions per chromosome over the same chain."""
    try:
        return _build_chain_index(chain_file)
    except ImportError as e:
        raise ImportError(
            "liftover_positions needs pyliftover, which is optional in "
            "this environment") from e


def liftover_positions(
    chain_file: str, chrom: str, positions: Sequence[int],
    one_based: bool = False,
) -> list:
    """Map genomic coordinates across assemblies via a UCSC chain file
    (reference shared_utils/util.py:1161-1200). Positions are 0-based
    (pyliftover's convention) unless `one_based=True`, in which case both
    inputs and outputs use the 1-based VCF/GWAS convention. Returns
    [(chrom, pos) | None, ...] per input position. pyliftover is optional
    in this image — absent, this raises with a clear message (the
    reference lazily imports it the same way)."""
    lo = _chain_index(chain_file)
    shift = 1 if one_based else 0
    out = []
    for pos in positions:
        hits = lo.convert_coordinate(chrom, int(pos) - shift)
        out.append((hits[0][0], int(hits[0][1]) + shift) if hits else None)
    return out
