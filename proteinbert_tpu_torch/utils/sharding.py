"""CPU-side job sharding for the ETL (reference C17, scheduler-agnostic) —
a copy of `proteinbert_tpu/utils/sharding.py`.

The reference's only "distributed" machinery is SLURM task-array plumbing
for embarrassing ETL parallelism (reference shared_utils/util.py:243-297,
436-505, 1121-1157). Here the same capability is one small function pair:
`task_identity()` reads whichever scheduler's env vars are present (SLURM
array vars, or the generic TASK_INDEX/TASK_COUNT, with an optional offset
and explicit CLI override), and `shard_range`/`to_chunks` do the index
math. Model-training distribution is NOT here — that is torch.distributed
(parallel/), a different axis entirely.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple


def to_chunks(items: Iterable, chunk_size: int) -> Iterator[list]:
    """Yield lists of up to `chunk_size` items (reference
    shared_utils/util.py:257-269)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    chunk: list = []
    for item in items:
        chunk.append(item)
        if len(chunk) >= chunk_size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def shard_range(n: int, shard_index: int, num_shards: int) -> Tuple[int, int]:
    """[start, end) of shard `shard_index` when n items are split as
    evenly as possible (first n % num_shards shards get one extra)."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard {shard_index} outside [0, {num_shards})")
    base, extra = divmod(n, num_shards)
    start = shard_index * base + min(shard_index, extra)
    return start, start + base + (1 if shard_index < extra else 0)


def shard_items(items: Sequence, shard_index: int, num_shards: int) -> Sequence:
    lo, hi = shard_range(len(items), shard_index, num_shards)
    return items[lo:hi]


def task_identity(
    task_index: Optional[int] = None,
    task_count: Optional[int] = None,
) -> Tuple[int, int]:
    """(task_index, task_count) for this ETL worker.

    Precedence: explicit args → SLURM array env (SLURM_ARRAY_TASK_ID /
    _COUNT, with TASK_ID_OFFSET applied as in reference
    shared_utils/util.py:1126-1145) → generic TASK_INDEX/TASK_COUNT env →
    (0, 1) standalone.
    """
    if task_index is not None or task_count is not None:
        if task_index is None or task_count is None:
            raise ValueError("give both task_index and task_count or neither")
        if not 0 <= task_index < task_count:
            raise ValueError(f"task {task_index} outside [0, {task_count})")
        return task_index, task_count

    if "SLURM_ARRAY_TASK_ID" in os.environ:
        idx = int(os.environ["SLURM_ARRAY_TASK_ID"])
        idx += int(os.environ.get("TASK_ID_OFFSET", 0))
        count = int(os.environ.get("SLURM_ARRAY_TASK_COUNT", 0))
        if count <= 0:
            raise ValueError(
                "SLURM_ARRAY_TASK_ID set but SLURM_ARRAY_TASK_COUNT missing")
        return idx, count

    if "TASK_INDEX" in os.environ:
        return int(os.environ["TASK_INDEX"]), int(os.environ.get("TASK_COUNT", 1))

    return 0, 1


def shard_file_name(path: str, shard_index: int, num_shards: int) -> str:
    """foo.db → foo.shard3of8.db (identity when num_shards == 1)."""
    if num_shards == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.shard{shard_index}of{num_shards}{ext}"


def all_shard_file_names(path: str, num_shards: int) -> List[str]:
    return [shard_file_name(path, i, num_shards) for i in range(num_shards)]
