"""The heads-eval promotion gate — port of `proteinbert_tpu/rollout/
gates.py` on the port's `heads/eval.evaluate_heads` and
`heads/registry.HeadRegistry.migrate_fingerprint`.

A trunk flip silently invalidates every registered head unless someone
proves the candidate's output space still carries them. This gate runs
the head eval harness (`heads/eval.evaluate_heads`: the trunk through K1
+ K2 on the card, then each head's tail) through BOTH trunks over the
same labelled batches and reports the worst-head score drop; the
rollout controller refuses promotion when the drop exceeds
`heads_eval_drop_max`.

Re-fingerprinting waits for `commit()`: evaluation loads heads without
a fingerprint pin (the weights are what they are — the question is how
they score), so the registry stays untouched until a promotion lands.
`commit()` re-pins every frozen head to the candidate fingerprint
(unfrozen heads get a recorded refusal — they co-adapted to the old
trunk and must be fine-tuned again); `restore()` un-pins them after a
rollback.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from proteinbert_tpu_torch.heads.eval import evaluate_heads
from proteinbert_tpu_torch.heads.registry import (
    HeadRegistry, HeadRegistryError, UnfrozenHeadError,
)

logger = logging.getLogger("proteinbert_tpu.rollout")


class HeadsEvalGate:
    """Callable gate: `gate()` → worst-head score delta (resident −
    candidate; positive = the candidate regressed), cached after the
    first call (the eval is the expensive part of a window close).
    `commit()` / `restore()` move the registry pins with an audit note.
    """

    def __init__(
        self,
        registry: HeadRegistry,
        model_cfg,
        batches_for,
        resident_params,
        candidate_params,
        resident_fp: str,
        candidate_fp: str,
        telemetry=None,
    ):
        self.registry = registry
        self.model_cfg = model_cfg
        self.batches_for = batches_for
        self.resident_params = resident_params
        self.candidate_params = candidate_params
        self.resident_fp = str(resident_fp)
        self.candidate_fp = str(candidate_fp)
        self.telemetry = telemetry
        self.delta: Optional[float] = None
        self.scores: Dict[str, Dict[str, float]] = {}
        self.migrated: List[str] = []
        self.refused: List[Dict[str, str]] = []

    # ------------------------------------------------------------- eval

    def _eligible_heads(self):
        """Every loadable head pinned to the resident trunk — frozen or
        not: the SCORE question applies to all of them (an unfrozen
        head that craters under the candidate should block promotion
        even though it will never be migrated)."""
        heads = []
        for meta in self.registry.list_heads():
            if meta.get("trunk_fingerprint") != self.resident_fp:
                continue
            try:
                heads.append(self.registry.load(meta["head_id"]))
            except HeadRegistryError as e:
                logger.warning("heads-eval gate skipping %s: %s",
                               meta["head_id"], e)
        return heads

    def __call__(self) -> float:
        if self.delta is not None:
            return self.delta
        heads = self._eligible_heads()
        if not heads:
            self.delta = 0.0
            return self.delta
        resident = evaluate_heads(self.resident_params, self.model_cfg,
                                  heads, self.batches_for,
                                  telemetry=self.telemetry)
        candidate = evaluate_heads(self.candidate_params, self.model_cfg,
                                   heads, self.batches_for,
                                   telemetry=self.telemetry)
        res_min = min(m["score"] for m in resident.values())
        cand_min = min(m["score"] for m in candidate.values())
        self.scores = {
            h.head_id: {"resident": float(resident[h.head_id]["score"]),
                        "candidate": float(candidate[h.head_id]["score"])}
            for h in heads
        }
        self.delta = float(res_min - cand_min)
        return self.delta

    # ----------------------------------------------------- pin movement

    def commit(self, note: str = "") -> List[Dict[str, str]]:
        """Permanently re-pin frozen heads to the candidate trunk.
        Returns the refusal records for heads that could not migrate
        (unfrozen — trained with the trunk unfrozen, so their weights
        are functions of the OLD trunk's interior, not its outputs)."""
        self.migrated = []
        self.refused = []
        for meta in self.registry.list_heads():
            if meta.get("trunk_fingerprint") != self.resident_fp:
                continue
            head_id = meta["head_id"]
            try:
                self.registry.migrate_fingerprint(
                    head_id, self.candidate_fp,
                    note=note or "rollout promotion "
                                 f"{self.resident_fp[:12]}… → "
                                 f"{self.candidate_fp[:12]}…")
                self.migrated.append(head_id)
            except UnfrozenHeadError as e:
                self.refused.append({"head_id": head_id,
                                     "reason": str(e)})
        return self.refused

    def restore(self, note: str = "") -> List[str]:
        """Rollback partner of commit(): re-pin every head commit()
        moved back to the (re-promoted) resident trunk."""
        restored = []
        for head_id in self.migrated:
            try:
                self.registry.migrate_fingerprint(
                    head_id, self.resident_fp,
                    note=note or "rollout rollback — restoring "
                                 f"{self.resident_fp[:12]}…")
                restored.append(head_id)
            except HeadRegistryError as e:  # pragma: no cover — a head
                # deleted mid-rollback is a registry race, not ours.
                logger.warning("rollback could not restore %s: %s",
                               head_id, e)
        self.migrated = [h for h in self.migrated if h not in restored]
        return restored
