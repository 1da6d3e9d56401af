"""Online serving — the port of `proteinbert_tpu/serve/`: the bounded
request queue (`queue.py`), bucketed and ragged dispatch over CUDA-graph
warm shapes, on one card or split over a serving mesh's replicas
(`dispatch.py`), continuous micro-batching with an in-flight window
(`scheduler.py`), the content-addressed result cache (`cache.py`), the
`Server` facade (`server.py`), the stdlib HTTP shim (`http.py`), request
traces (`trace.py`) and the replica fleet with its router (`fleet.py`).

The names are the JAX package's. `TrunkMismatchError` and
`UnknownHeadError` live in the port's `heads/registry.py` (the JAX
package re-exports them through `serve/errors.py`); they are exported
here under the same names.
"""

from proteinbert_tpu_torch.heads.registry import (
    TrunkMismatchError, UnknownHeadError,
)
from proteinbert_tpu_torch.serve.cache import EmbeddingCache, content_key
from proteinbert_tpu_torch.serve.dispatch import (
    TASK_KIND, BucketDispatcher, RaggedDispatcher,
)
from proteinbert_tpu_torch.serve.errors import (
    DeadlineExceededError,
    QueueFullError,
    SequenceTooLongError,
    ServeError,
    ServerClosedError,
)
from proteinbert_tpu_torch.serve.fleet import (
    FaultInjector, FleetRouter, make_fleet_http_server,
)
from proteinbert_tpu_torch.serve.queue import Request, RequestQueue
from proteinbert_tpu_torch.serve.scheduler import (
    MicroBatchScheduler, PackedBatchScheduler,
)
from proteinbert_tpu_torch.serve.server import SERVE_MODES, Server
from proteinbert_tpu_torch.serve.trace import RequestTrace

__all__ = [
    "Server",
    "FleetRouter",
    "FaultInjector",
    "make_fleet_http_server",
    "SERVE_MODES",
    "BucketDispatcher",
    "RaggedDispatcher",
    "MicroBatchScheduler",
    "PackedBatchScheduler",
    "RequestQueue",
    "Request",
    "RequestTrace",
    "EmbeddingCache",
    "content_key",
    "TASK_KIND",
    "ServeError",
    "QueueFullError",
    "DeadlineExceededError",
    "ServerClosedError",
    "SequenceTooLongError",
    "UnknownHeadError",
    "TrunkMismatchError",
]
