"""Host-side tokenization transforms — port of
`proteinbert_tpu/data/transforms.py` (numpy only).

Crop → encode → add <sos>/<eos> → pad to a static length, vectorized in
numpy. Crop windows are COUNTER-BASED: the window of a row is a pure
function of (crop_seed, row_id) through splitmix64, so the port crops the
same windows as the JAX package and a resumed run reproduces an
uninterrupted one. The JAX package also has a C++ tokenizer with the
same output; the port keeps the numpy path only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from proteinbert_tpu_torch.data.vocab import EOS_ID, PAD_ID, SOS_ID, get_vocab

_U64 = np.uint64


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over uint64."""
    with np.errstate(over="ignore"):
        x = (np.asarray(x, _U64) + _U64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def epoch_crop_seed(base_seed: int, epoch: int) -> int:
    """Per-epoch window seed: a fresh window each epoch, the same window
    whenever (epoch, row) repeats."""
    with np.errstate(over="ignore"):
        mixed = splitmix64(
            _U64(base_seed & 0xFFFFFFFFFFFFFFFF)
            + _U64(0xD1B54A32D192ED03) * _U64(epoch)
        )
    return int(mixed)


def crop_starts(
    lengths: np.ndarray, cap: int, crop_seed: int, row_ids: np.ndarray
) -> np.ndarray:
    """(B,) window starts: splitmix64(seed + row_id) % (len - cap + 1)
    for rows longer than `cap`, 0 otherwise (the last window included)."""
    lengths = np.asarray(lengths, np.int64)
    with np.errstate(over="ignore"):
        r = splitmix64(_U64(crop_seed & 0xFFFFFFFFFFFFFFFF)
                       + np.asarray(row_ids, _U64))
    span = np.maximum(lengths - cap + 1, 1).astype(np.uint64)
    return np.where(lengths > cap, (r % span).astype(np.int64), 0)


def crop_start(length: int, cap: int, crop_seed: int, row_id: int = 0) -> int:
    """Scalar form of `crop_starts`."""
    return int(crop_starts(np.array([length]), cap, crop_seed,
                           np.array([row_id]))[0])


def random_crop(
    seq: str, max_residues: int, crop_seed: int, row_id: int = 0
) -> str:
    """The counter-based window of `max_residues` for (crop_seed,
    row_id)."""
    if len(seq) <= max_residues:
        return seq
    start = crop_start(len(seq), max_residues, crop_seed, row_id)
    return seq[start:start + max_residues]


def _encode_row(out_row: np.ndarray, seq: str, cap: int, start: int,
                vocab) -> None:
    """Crop → encode → <sos>/<eos> into one preallocated pad row."""
    if len(seq) > cap:
        seq = seq[start:start + cap]
    ids = vocab.encode(seq)
    out_row[0] = SOS_ID
    out_row[1:1 + len(ids)] = ids
    out_row[1 + len(ids)] = EOS_ID


def tokenize(
    seq: str,
    seq_len: int,
    crop_seed: Optional[int] = None,
    row_id: int = 0,
) -> np.ndarray:
    """(seq_len,) int32 ids. With `crop_seed`, a long sequence takes the
    counter-based window for (crop_seed, row_id); else its head."""
    cap = seq_len - 2
    start = (crop_start(len(seq), cap, crop_seed, row_id)
             if crop_seed is not None and len(seq) > cap else 0)
    out = np.full(seq_len, PAD_ID, dtype=np.int32)
    _encode_row(out, seq, cap, start, get_vocab())
    return out


def tokenize_batch(
    seqs: Sequence[str],
    seq_len: int,
    crop_seed: Optional[int] = None,
    row_ids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """A dense (B, seq_len) int32 batch. `row_ids` (default 0..B-1) key
    the crop windows; datasets pass global row indices so a row's window
    does not depend on the batch it lands in."""
    if row_ids is None:
        row_ids = np.arange(len(seqs), dtype=np.int64)
    else:
        row_ids = np.asarray(row_ids, dtype=np.int64)
        if len(row_ids) != len(seqs):
            raise ValueError(f"{len(row_ids)} row_ids for {len(seqs)} seqs")
    cap = seq_len - 2
    out = np.full((len(seqs), seq_len), PAD_ID, dtype=np.int32)
    if crop_seed is not None:
        lengths = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
        starts = crop_starts(lengths, cap, crop_seed, row_ids)
    else:
        starts = np.zeros(len(seqs), np.int64)
    vocab = get_vocab()
    for i, s in enumerate(seqs):
        _encode_row(out[i], s, cap, int(starts[i]), vocab)
    return out
