"""Resumable sharded batch inference + integrity-verified embedding
store — port of `proteinbert_tpu/mapper/` (the JAX `pbt map`).

Layout:
- `store.py`  — content-addressed block store, crash-safe shard
  cursors, quarantine sidecars, `verify_store` (stdlib+numpy only; a
  copy of the JAX module, so the on-disk format is one).
- `engine.py` — the map run loop: packed-trunk embedding on the card,
  retries, poison quarantine, NaN halt, telemetry (imports the model and
  the kernels — loaded lazily, so verifying a store loads neither).
- `faults.py` — the PBT_MAP_FAULTS injection hooks (a copy).
"""

from proteinbert_tpu_torch.mapper.faults import (  # noqa: F401
    FAULT_ENV, MapFaults, TransientDispatchError,
)
from proteinbert_tpu_torch.mapper.store import (  # noqa: F401
    BlockFormatError, BlockIntegrityError, CursorError, EmbeddingStore,
    ShardCursor, StoreConfigError, StoreError, block_digest,
    commit_block, corpus_digest, deserialize_block, iter_embeddings,
    next_offset, resume_shard, serialize_block, shard_ranges,
    store_digests, verify_store,
)

__all__ = [
    "FAULT_ENV", "MapFaults", "TransientDispatchError",
    "BlockFormatError", "BlockIntegrityError", "CursorError",
    "EmbeddingStore", "ShardCursor", "StoreConfigError", "StoreError",
    "block_digest", "commit_block", "corpus_digest", "deserialize_block",
    "iter_embeddings", "next_offset", "resume_shard", "serialize_block",
    "shard_ranges", "store_digests", "verify_store",
    # lazy (model-importing) engine surface:
    "run_map", "poison_reason",
]


def __getattr__(name):  # PEP 562: verifying a store loads no model
    if name in ("run_map", "poison_reason"):
        from proteinbert_tpu_torch.mapper import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
