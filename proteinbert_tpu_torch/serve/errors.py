"""Typed serving errors — the backpressure/deadline/drain contract (port
of `proteinbert_tpu/serve/errors.py`).

Every way the serving layer can refuse work has its own type, so callers
can tell "try again later" (QueueFullError) from "you were too slow"
(DeadlineExceededError) from "the server is going away"
(ServerClosedError) from "this input can never be served"
(SequenceTooLongError), and a blue-green rollout's capacity refusal
(CandidateUnfitError) from its state refusal (NoCandidateError). A
rejected request always observes its rejection — on its future, or
raised at submit — never a silent drop.
"""

from __future__ import annotations

# Raised by the offline surface too, so it lives in inference.py (which
# must not depend on serve) and is re-exported here.
from proteinbert_tpu_torch.inference import SequenceTooLongError  # noqa: F401


class ServeError(Exception):
    """Base class for all serving-layer rejections."""


class QueueFullError(ServeError):
    """Admission control fired: the bounded queue overflowed and this
    (oldest) request was evicted to admit newer work."""


class DeadlineExceededError(ServeError):
    """The request's deadline passed before a batch could run it."""


class ServerClosedError(ServeError):
    """The server is draining or closed; no new work is accepted (and
    on abort, pending work fails with this)."""


class CandidateUnfitError(ServeError):
    """A candidate trunk (`Server.load_candidate`) does not fit beside
    the resident one within the device memory budget — the typed refusal
    of the blue-green rollout (HTTP 409 `candidate_unfit`)."""


class NoCandidateError(ServeError):
    """A rollout verb (flip / rollback / shadow) was asked of a replica
    that holds no candidate (or no parked) trunk in that slot — a state
    error, not a capacity one (HTTP 409 `no_candidate`)."""
