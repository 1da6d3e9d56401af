"""Neighbor index — port of `proteinbert_tpu/index/` (`pbt index` +
`/v1/neighbors`).

- `index.store` — the numpy build/verify half, a copy of the JAX module:
  the resumable, kill-anywhere builder on the mapper's cursor protocol,
  `verify_index`, and the digest helpers; on the same store it writes
  the JAX builder's bytes.
- `index.scorer` — the torch half: `NeighborIndex.load` (the quantized
  index resident on the card) and the batched IVF-flat lookup, plus the
  exact brute-force recall helpers.

Only the store half is re-exported here, as in the JAX package; serving
code imports the scorer explicitly:
`from proteinbert_tpu_torch.index.scorer import NeighborIndex`.
"""

from proteinbert_tpu_torch.index.store import (
    CENTROIDS_POINTER, DEFAULT_BLOCK_SIZE, DEFAULT_CENTROIDS,
    INDEX_BUILD_STATES, INDEX_FAULT_ENV, INDEX_KIND, IndexBuildError,
    build_index, index_digests, index_identity, load_centroids,
    verify_index,
)

__all__ = [
    "CENTROIDS_POINTER", "DEFAULT_BLOCK_SIZE", "DEFAULT_CENTROIDS",
    "INDEX_BUILD_STATES", "INDEX_FAULT_ENV", "INDEX_KIND",
    "IndexBuildError",
    "build_index", "index_digests", "index_identity", "load_centroids",
    "verify_index",
]
