"""Blue-green trunk rollout — port of `proteinbert_tpu/rollout/`.

A rollout drives a candidate trunk through shadow → gate → flip →
(rollback) beside the resident one:

  - every replica loads the candidate as a second arm
    (`Server.load_candidate`: its own tensors on the card, warmed
    eagerly at every warm shape, priced in device memory with a typed
    refusal when two trunks do not fit);
  - the fleet router mirrors a sampled stride of live traffic to the
    candidate as sealed shadow attempts (`rollout_shadow` events under
    the live request's trace_id — never retried, never user-visible,
    never cache-writing);
  - the controller closes per-window gates (shadow parity, SLO-burn
    delta, heads-eval score delta) and promotes only after N
    consecutive green windows;
  - promotion flips each replica: the candidate's values are copied
    into the resident trunk's own tensors on the serving stream, so
    every captured CUDA graph stays valid, and the old values park on
    the host for a rollback bit for bit; frozen heads are re-pinned via
    `HeadRegistry.migrate_fingerprint`.
"""

from proteinbert_tpu_torch.rollout.controller import RolloutController
from proteinbert_tpu_torch.rollout.gates import HeadsEvalGate

__all__ = ["RolloutController", "HeadsEvalGate"]
