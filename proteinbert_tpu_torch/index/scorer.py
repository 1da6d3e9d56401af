"""Batched IVF-flat neighbor lookup — port of
`proteinbert_tpu/index/scorer.py`, the `/v1/neighbors` hot path.

`NeighborIndex.load` reads a built index (index/store.py, the JAX
format) in its QUANTIZED form — int8 residual codes + per-block fp32
channel scales + int32 centroid assignments, ~0.25× the fp32 bytes —
groups rows per centroid into one padded member table (host numpy, the
JAX table), and puts `centroids`, `members`, `codes`, `scales` and
`scale_row` on `device` (None → "cuda"). A lookup is the JAX jitted
function's operations in torch, on those tensors:

    q̂ · centroidsᵀ → top-nprobe shortlist
    → gather the shortlist's member rows (codes, scale rows)
    → score = (codes · scale) · q̂ + q̂ · centroid   (cosine, since both
      sides are L2-normalized and vectors are stored as residuals)
    → masked top-k over the candidate set

It is jitted JAX and no Pallas kernel, so plain torch ops are its port.
Two details keep the answers the JAX ones:

- **Top-k order.** `jax.lax.top_k` returns the k largest best-first and
  breaks ties by the lower index; `torch.topk` promises no order on CUDA.
  `_top_k` takes the first k of a STABLE descending sort, which is the
  JAX order (duplicate corpus sequences give equal scores).
- **float32.** The products run in float32 with TF32 off (PyTorch's
  default, and the port's everywhere); TF32 would move scores by ~1e-3
  and swap neighbours.

Invalid slots follow JAX: the row is `where(valid, cand, 0)` and the
score `-inf`; `lookup_one` drops them. `executables()` counts the
distinct (batch, nprobe, k) shapes served, the JAX warm-executable count.

Exact brute-force helpers (`exact_topk`, `recall_at_k`,
`evaluate_recall`, `store_vectors_in_index_order`) are host numpy
copies of the JAX ones: the recall gate scores against them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch.index.store import (
    INDEX_KIND, EmbeddingStore, ShardCursor, StoreConfigError,
    index_identity, load_centroids, next_offset,
)
from proteinbert_tpu_torch.obs import as_telemetry


def _normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    return (x / np.where(norm > 0, norm, 1.0)).astype(np.float32)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, best
    first, ties to the lower index — `jax.lax.top_k`'s order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _lookup(qhat: torch.Tensor, centroids: torch.Tensor,
            members: torch.Tensor, codes: torch.Tensor,
            scales: torch.Tensor, scale_row: torch.Tensor, nprobe: int,
            k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (Q, k), rows (Q, k)) — rows are GLOBAL index rows, -inf
    scores mark slots beyond the candidate set. The JAX `_lookup_jit`
    operation for operation; `members` and `scale_row` int64."""
    cd = qhat @ centroids.T                                 # (Q, K)
    cent_score, probe = _top_k(cd, nprobe)                  # (Q, P)
    cand = members[probe]                                   # (Q, P, L)
    valid = cand >= 0
    rows = torch.where(valid, cand, torch.zeros_like(cand))
    resid = codes[rows].to(torch.float32) * scales[scale_row[rows]]
    score = torch.einsum("qpld,qd->qpl", resid, qhat) \
        + cent_score[..., None]                             # (Q, P, L)
    score = torch.where(valid, score,
                        torch.full_like(score, -float("inf")))
    flat = score.reshape(score.shape[0], -1)
    rows_flat = rows.reshape(rows.shape[0], -1)
    if k > flat.shape[-1]:
        # jax.lax.top_k refuses this too.
        raise ValueError(f"k={k} exceeds the {flat.shape[-1]} candidate "
                         f"slots of nprobe={nprobe}")
    best, pos = _top_k(flat, k)
    return best, torch.gather(rows_flat, 1, pos)


class NeighborIndex:
    """A loaded index: quantized vectors resident on `device`, lookups in
    torch."""

    def __init__(self, ids: np.ndarray, codes: np.ndarray,
                 scale_row: np.ndarray, scales: np.ndarray,
                 assign: np.ndarray, centroids: np.ndarray,
                 manifest: Dict[str, Any], digest: str,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.ids = ids                      # (N,) 'S' bytes, host
        self.codes = codes                  # (N, d) int8
        self.scale_row = scale_row          # (N,) int32 → row of scales
        self.scales = scales                # (B, d) fp32, one per block
        self.assign = assign                # (N,) int32
        self.centroids = centroids          # (K, d) fp32
        self.manifest = manifest
        self.digest = digest                # index_identity(index_dir)
        self._warm: Dict[Tuple[int, int, int], int] = {}
        k_cent = centroids.shape[0]
        counts = np.bincount(assign, minlength=k_cent)
        width = max(1, int(counts.max()) if counts.size else 1)
        members = np.full((k_cent, width), -1, np.int32)
        fill = np.zeros(k_cent, np.int64)
        for row, c in enumerate(assign):    # corpus order within a list
            members[c, fill[c]] = row
            fill[c] += 1
        self.members = members
        dev = self.device
        # The resident form the lookup reads; the index arrays gather
        # with int64 on the device.
        self._t = {
            name: torch.from_numpy(np.array(a, dtype)).to(dev)
            for name, a, dtype in (
                ("centroids", centroids, np.float32),
                ("members", members, np.int64),
                ("codes", codes, np.int8),
                ("scales", scales, np.float32),
                ("scale_row", scale_row, np.int64))}
        if dev.type == "cuda":
            # Lookups may run on another stream (the server's): the
            # copies above must have landed first.
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------- load

    @classmethod
    def load(cls, index_dir: str, device: DeviceLike = None
             ) -> "NeighborIndex":
        """Digest-verified load of a COMPLETE index (every shard done)
        onto `device` (None → "cuda"); an incomplete or foreign
        directory is a typed refusal."""
        device = resolve_device(device)
        store = EmbeddingStore(index_dir)
        manifest = store.load_manifest()
        if manifest is None:
            raise StoreConfigError(f"{index_dir} has no manifest.json — "
                                   "not a neighbor index")
        if manifest.get("kind") != INDEX_KIND:
            raise StoreConfigError(
                f"{index_dir} manifest kind {manifest.get('kind')!r} "
                f"is not {INDEX_KIND!r}")
        centroids, _cdigest = load_centroids(index_dir)
        ids: List[np.ndarray] = []
        codes: List[np.ndarray] = []
        scales: List[np.ndarray] = []
        scale_row: List[np.ndarray] = []
        assign: List[np.ndarray] = []
        block_row = 0
        for shard in range(int(manifest["num_shards"])):
            state, _ = ShardCursor(index_dir, shard).load()
            if not state["done"]:
                raise StoreConfigError(
                    f"index shard {shard} is not done "
                    f"({next_offset(state)} vectors) — resume "
                    "`build_index` before serving it")
            for entry in state["blocks"]:
                _meta, arrays = store.read_block(entry["digest"])
                n = int(entry["n"])
                ids.append(arrays["ids"])
                codes.append(arrays["codes"])
                assign.append(arrays["assign"])
                scales.append(arrays["scales"][None, :])
                scale_row.append(np.full(n, block_row, np.int32))
                block_row += 1
        return cls(
            ids=np.concatenate(ids, axis=0),
            codes=np.ascontiguousarray(np.concatenate(codes, axis=0)),
            scale_row=np.concatenate(scale_row, axis=0),
            scales=np.ascontiguousarray(
                np.concatenate(scales, axis=0, dtype=np.float32)),
            assign=np.concatenate(assign, axis=0),
            centroids=centroids,
            manifest=manifest,
            digest=index_identity(index_dir),
            device=device,
        )

    # ---------------------------------------------------------- queries

    @property
    def num_vectors(self) -> int:
        return int(self.ids.shape[0])

    @property
    def dim(self) -> int:
        return int(self.codes.shape[1])

    @property
    def model_fingerprint(self) -> str:
        return str(self.manifest.get("model_fingerprint", ""))

    @property
    def corpus_digest(self) -> str:
        return str(self.manifest.get("corpus_digest", ""))

    def resident_bytes(self) -> int:
        """Bytes of the tensors a lookup reads, on the device."""
        return sum(t.numel() * t.element_size() for t in self._t.values())

    def executables(self) -> int:
        """Distinct (batch, nprobe, k) shapes served so far — the JAX
        warm-executable count in Server.stats()."""
        return len(self._warm)

    def _clamp(self, k: int, nprobe: int) -> Tuple[int, int]:
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        return (min(int(k), self.num_vectors),
                min(int(nprobe), int(self.centroids.shape[0])))

    @torch.inference_mode()
    def lookup_rows(self, queries: np.ndarray, k: int = 10,
                    nprobe: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (Q, k), global rows (Q, k)) for a batch of raw query
        vectors; -inf score marks a slot the probed lists could not fill.
        Runs on the current stream and waits for it."""
        qhat = np.atleast_2d(_normalize(queries))
        k, nprobe = self._clamp(k, nprobe)
        key = (int(qhat.shape[0]), nprobe, k)
        self._warm[key] = self._warm.get(key, 0) + 1
        t = self._t
        scores, rows = _lookup(
            torch.from_numpy(qhat).to(self.device), t["centroids"],
            t["members"], t["codes"], t["scales"], t["scale_row"],
            nprobe=nprobe, k=k)
        return (scores.cpu().numpy(),
                rows.to(torch.int32).cpu().numpy())

    def lookup_one(self, query: np.ndarray, k: int = 10,
                   nprobe: int = 8) -> List[Tuple[str, float]]:
        """[(corpus id, cosine score)] best-first for ONE query vector
        — the serve-path entry (Server._finalize)."""
        scores, rows = self.lookup_rows(np.asarray(query)[None, :],
                                        k=k, nprobe=nprobe)
        out: List[Tuple[str, float]] = []
        for s, r in zip(scores[0], rows[0]):
            if not np.isfinite(s):
                continue
            out.append((self.ids[int(r)].decode(), float(s)))
        return out


# ------------------------------------------------------- recall helpers

def exact_topk(vectors: np.ndarray, queries: np.ndarray,
               k: int) -> np.ndarray:
    """Ground-truth cosine top-k row indices (Q, k) by brute force over
    the FP32 vectors — what the ANN answers are measured against."""
    vhat = _normalize(vectors)
    qhat = np.atleast_2d(_normalize(queries))
    sims = qhat @ vhat.T
    k = min(int(k), vhat.shape[0])
    part = np.argpartition(-sims, k - 1, axis=1)[:, :k]
    order = np.take_along_axis(sims, part, axis=1).argsort(axis=1)[:, ::-1]
    return np.take_along_axis(part, order, axis=1)


def recall_at_k(approx_rows: np.ndarray, exact_rows: np.ndarray) -> float:
    """Mean fraction of exact top-k rows the approximate answer
    recovered (order-insensitive — the standard ANN recall@k)."""
    approx_rows = np.atleast_2d(approx_rows)
    exact_rows = np.atleast_2d(exact_rows)
    hits = 0
    total = 0
    for a, e in zip(approx_rows, exact_rows):
        es = set(int(x) for x in e)
        hits += len(es & set(int(x) for x in a))
        total += len(es)
    return hits / total if total else 0.0


def evaluate_recall(index: NeighborIndex, vectors: np.ndarray,
                    queries: np.ndarray, k: int = 10, nprobe: int = 8,
                    telemetry=None) -> float:
    """recall@k of the quantized index vs exact fp32 brute force over
    `vectors` (the store's fp32 embeddings, index row order). Sets the
    `neighbors_recall_at_k` gauge."""
    _scores, rows = index.lookup_rows(queries, k=k, nprobe=nprobe)
    exact = exact_topk(vectors, queries, k=k)
    recall = recall_at_k(rows, exact)
    as_telemetry(telemetry).metrics.gauge(
        "neighbors_recall_at_k", k=str(int(k))).set(recall)
    return recall


def store_vectors_in_index_order(store_dir: str) -> np.ndarray:
    """The store's fp32 `global` vectors concatenated in the index's
    row order (shard-major, corpus order within a shard) — the
    brute-force side of every recall measurement."""
    from proteinbert_tpu_torch.mapper.store import iter_embeddings
    return np.stack([rec["global"]
                     for _id, rec in iter_embeddings(store_dir)]) \
        .astype(np.float32)
