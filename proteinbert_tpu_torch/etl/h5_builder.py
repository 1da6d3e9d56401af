"""SQLite + FASTA → HDF5 pretraining dataset (reference C3/C4, redesigned)
— a copy of `proteinbert_tpu/etl/h5_builder.py`.

Reference behavior (uniref_dataset.py:201-320): read the GO-meta CSV, keep
annotations with >=100 records, run the SQLite↔FASTA join TWICE (once just
to count rows, once to write), and slice-assign 10k-row chunks into fixed
h5 datasets. Here the join runs ONCE into resizable chunked datasets —
halving ETL wall-clock on a corpus that takes hours to scan — and the
dataset names/layout match the reference's exactly (`included_annotations`,
`uniprot_ids`, `seqs`, `seq_lengths`, `annotation_masks`) so the reader in
data/dataset.py serves either origin.

The per-host sharded training feed then slices this one file by row range
(data/dataset.py make_pretrain_iterator) — no per-host file splits needed.
"""

from __future__ import annotations

import json
import sqlite3
from typing import Iterator, List, Optional, Tuple

import numpy as np

from proteinbert_tpu_torch.etl.fasta import FastaReader
from proteinbert_tpu_torch.etl.go_ontology import load_meta_csv
from proteinbert_tpu_torch.utils.logging import log


def load_seqs_and_annotations(
    sqlite_path: str,
    fasta_path: str,
    shuffle: bool = True,
    seed: int = 0,
    records_limit: Optional[int] = None,
    verbose: bool = True,
    log_progress_every: int = 100_000,
    stats: Optional[dict] = None,
) -> Iterator[Tuple[str, str, List[int]]]:
    """Yield (uniprot_id, sequence, completed_annotation_indices) by
    joining SQLite records to FASTA via the `UniRef90_<accession>` key
    (reference uniref_dataset.py:274-320). Deterministic shuffle keeps
    the reference's reproducible-ordering property (its seed-0 sample at
    uniref_dataset.py:294) without materializing a DataFrame.

    `stats`: optional dict the generator fills as it runs —
    {'n_yielded', 'n_unjoinable'} — so callers (and hostile-input
    tests) can assert how many annotation records had no FASTA
    sequence instead of trusting a log line. Unjoinable ids are
    counted and skipped, never a crash.
    """
    # Stream in O(fetch_chunk) row memory: materialize only the int64 key
    # column (8 bytes/row — fine even at UniRef90's ~10^8 rows), shuffle
    # the keys, then batch-fetch rows by key chunk. A fetchall of the
    # string columns here would hold tens of GB of Python objects.
    fetch_chunk = 10_000
    if stats is None:
        stats = {}
    stats.update(n_yielded=0, n_unjoinable=0)
    conn = sqlite3.connect(sqlite_path)
    try:
        keys = np.fromiter(
            (r[0] for r in conn.execute(
                "SELECT entry_index FROM protein_annotations ORDER BY entry_index"
                + (f" LIMIT {int(records_limit)}" if records_limit else ""))),
            dtype=np.int64,
        )
        if verbose:
            log(f"joining {len(keys)} annotation records from {sqlite_path}")
        if shuffle:
            np.random.default_rng(seed).shuffle(keys)

        n_failed = 0
        with FastaReader(fasta_path) as fasta:
            for lo in range(0, len(keys), fetch_chunk):
                chunk = keys[lo : lo + fetch_chunk]
                placeholders = ",".join("?" * len(chunk))
                fetched = dict(
                    (k, (name, raw)) for k, name, raw in conn.execute(
                        "SELECT entry_index, uniprot_name, "
                        "complete_go_annotation_indices FROM protein_annotations "
                        f"WHERE entry_index IN ({placeholders})",
                        [int(k) for k in chunk],
                    )
                )
                for pos, k in enumerate(chunk):
                    if verbose and (lo + pos) % log_progress_every == 0 and lo + pos:
                        log(f"join: {lo + pos}/{len(keys)}")
                    uniprot_name, raw_indices = fetched[int(k)]
                    fasta_id = f"UniRef90_{uniprot_name.split('_')[0]}"
                    if fasta_id not in fasta:
                        n_failed += 1
                        stats["n_unjoinable"] = n_failed
                        continue
                    stats["n_yielded"] += 1
                    yield uniprot_name, fasta.fetch(fasta_id), json.loads(raw_indices)
    finally:
        conn.close()
    if verbose:
        log(f"join finished; {n_failed}/{len(keys)} records had no sequence")


def create_h5_dataset(
    sqlite_path: str,
    fasta_path: str,
    go_meta_csv_path: str,
    output_h5_path: str,
    shuffle: bool = True,
    seed: int = 0,
    min_records_to_keep_annotation: int = 100,
    records_limit: Optional[int] = None,
    chunk_size: int = 10_000,
    verbose: bool = True,
) -> int:
    """Build the HDF5 pretraining dataset in ONE pass; returns row count."""
    import h5py

    meta = load_meta_csv(go_meta_csv_path)
    common = sorted(
        (r for r in meta if r["count"] >= min_records_to_keep_annotation),
        key=lambda r: r["id"],
    )
    # original dense ontology index → position in the common subset
    # (reference uniref_dataset.py:216-217).
    orig_to_common = {r["index"]: i for i, r in enumerate(common)}
    n_common = len(common)
    if n_common == 0:
        raise ValueError(
            f"no GO annotation has >= {min_records_to_keep_annotation} records "
            f"in {go_meta_csv_path}; lower min_records_to_keep_annotation "
            "(--min-records) for small corpora")
    if verbose:
        log(f"encoding the {n_common} annotations with >= "
            f"{min_records_to_keep_annotation} records")

    str_dt = h5py.string_dtype()
    with h5py.File(output_h5_path, "w") as h5f:
        h5f.create_dataset(
            "included_annotations",
            data=np.array([r["id"].encode("ascii") for r in common], dtype=object),
            dtype=str_dt,
        )
        uniprot_ids = h5f.create_dataset(
            "uniprot_ids", shape=(0,), maxshape=(None,), dtype=str_dt,
            chunks=(chunk_size,))
        seqs = h5f.create_dataset(
            "seqs", shape=(0,), maxshape=(None,), dtype=str_dt,
            chunks=(chunk_size,))
        seq_lengths = h5f.create_dataset(
            "seq_lengths", shape=(0,), maxshape=(None,), dtype=np.int32,
            chunks=(chunk_size,))
        annotation_masks = h5f.create_dataset(
            "annotation_masks", shape=(0, n_common), maxshape=(None, n_common),
            dtype=bool, chunks=(min(chunk_size, 1024), n_common))

        n = 0
        buf_ids: List[str] = []
        buf_seqs: List[str] = []
        buf_ann: List[List[int]] = []

        def flush():
            nonlocal n
            if not buf_ids:
                return
            lo, hi = n, n + len(buf_ids)
            for ds in (uniprot_ids, seqs, seq_lengths):
                ds.resize((hi,))
            annotation_masks.resize((hi, n_common))
            uniprot_ids[lo:hi] = buf_ids
            seqs[lo:hi] = buf_seqs
            seq_lengths[lo:hi] = np.fromiter(
                (len(s) for s in buf_seqs), dtype=np.int32, count=len(buf_seqs))
            mask = np.zeros((len(buf_ids), n_common), dtype=bool)
            for r, idxs in enumerate(buf_ann):
                cols = [orig_to_common[i] for i in idxs if i in orig_to_common]
                mask[r, cols] = True
            annotation_masks[lo:hi] = mask
            n = hi
            buf_ids.clear(); buf_seqs.clear(); buf_ann.clear()

        for uid, seq, ann_indices in load_seqs_and_annotations(
            sqlite_path, fasta_path, shuffle=shuffle, seed=seed,
            records_limit=records_limit, verbose=verbose,
        ):
            buf_ids.append(uid)
            buf_seqs.append(seq)
            buf_ann.append(ann_indices)
            if len(buf_ids) >= chunk_size:
                flush()
        flush()

    if verbose:
        log(f"wrote {n} rows x {n_common} annotations to {output_h5_path}")
    return n
