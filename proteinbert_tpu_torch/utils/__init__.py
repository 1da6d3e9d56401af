"""Host-side utilities of the port: `h5` (HDF5 helpers), `sharding` (ETL
task-array index math) and `stats` (BH, Fisher, one-hot), copies of the
JAX package's; `logging`; and `profiling` (host timers, the heap walker,
the torch profiler trace and the card's memory report). The exports are
the JAX package's `utils/__init__.py`'s, with `BoundaryStallMeter`."""

from proteinbert_tpu_torch.utils.logging import log, start_log
from proteinbert_tpu_torch.utils.profiling import (
    BoundaryStallMeter,
    Profiler,
    TimeMeasure,
    device_memory_report,
    device_trace,
    monitor_memory,
)
from proteinbert_tpu_torch.utils.stats import (
    benjamini_hochberg,
    benjamini_hochberg_with_nulls,
    drop_redundant_columns,
    fisher_enrichment,
    liftover_positions,
    manhattan_plot,
    one_hot,
    write_excel,
)
from proteinbert_tpu_torch.utils.sharding import (
    all_shard_file_names,
    shard_file_name,
    shard_items,
    shard_range,
    task_identity,
    to_chunks,
)

__all__ = [
    "log", "start_log",
    "Profiler", "TimeMeasure", "BoundaryStallMeter", "device_trace",
    "monitor_memory", "device_memory_report",
    "to_chunks", "shard_range", "shard_items", "task_identity",
    "shard_file_name", "all_shard_file_names",
    "benjamini_hochberg", "benjamini_hochberg_with_nulls",
    "drop_redundant_columns", "fisher_enrichment",
    "one_hot", "manhattan_plot",
    "write_excel", "liftover_positions",
]
