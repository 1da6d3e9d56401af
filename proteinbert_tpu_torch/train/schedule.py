"""LR schedules and the optimizer chain — port of
`proteinbert_tpu/train/schedule.py`, held to optax's semantics.

The chain is clip_by_global_norm → Adam(W) with the schedule →
[reduce_on_plateau], as `make_optimizer` builds it from optax there:

- the schedule is read at the update count BEFORE it increments, so the
  first warmup update has LR 0 (`optax.scale_by_schedule`);
- the global-norm clip has no epsilon: g → (g / ‖g‖) · max_norm when
  ‖g‖ ≥ max_norm, else g untouched (`torch.nn.utils.clip_grad_norm_`
  adds 1e-6 and is not used);
- Adam: mu = (1-b1)·g + b1·mu, nu = (1-b2)·g² + b2·nu, bias-corrected
  by 1 - b**count, update mu_hat / (sqrt(nu_hat) + 1e-8); AdamW adds
  weight_decay · param before the LR;
- the plateau transform averages `plateau_window` observed values into
  one observation, cuts its scale by `plateau_factor` after
  `plateau_patience` observations without a relative improvement of
  rtol 1e-4 (atol 0), then ignores `plateau_cooldown` observations.

Plain tensor code over the flattened parameter leaves (`torch._foreach_*`,
each in optax's operation order) rather than `torch.optim`, whose Adam
orders and fuses the same arithmetic differently. The schedule value and
the bias corrections are float32 host scalars, computed as optax computes
them; the plateau state stays on the device (0-d tensors), so a step
never waits on the host. Unlike optax, `update` works in place on the
grads and on its own state, and `gradient_update` adds the updates to the
params in place: the port keeps one copy of each.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch.configs import OptimizerConfig

F32 = np.float32
PLATEAU_RTOL = 1e-4
PLATEAU_ATOL = 0.0
ADAM_EPS = 1e-8


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a params tree (dicts and lists), in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _linear(init: float, end: float, steps: int) -> Callable[[int], F32]:
    """optax.linear_schedule (polynomial, power 1), in float32."""
    if steps <= 0:
        return lambda count: F32(init)

    def schedule(count):
        c = F32(min(max(count, 0), steps))
        frac = F32(1) - c / F32(steps)
        return F32(init - end) * frac + F32(end)

    return schedule


def _cosine(init: float, decay_steps: int) -> Callable[[int], F32]:
    """optax.cosine_decay_schedule with alpha 0, exponent 1, in float32."""
    def schedule(count):
        c = F32(min(count, decay_steps))
        cosine = F32(0.5) * (F32(1) + np.cos(F32(math.pi) * c
                                             / F32(decay_steps)))
        return F32(init) * cosine

    return schedule


def _join(first: Callable, second: Callable, boundary: int) -> Callable:
    """optax.join_schedules of two schedules at `boundary`."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], F32]:
    """count → learning rate (float32)."""
    warmup = _linear(0.0, cfg.learning_rate, cfg.warmup_steps)
    if cfg.schedule == "warmup_cosine":
        decay = max(cfg.total_steps, cfg.warmup_steps + 1)
        return _join(warmup, _cosine(cfg.learning_rate,
                                     decay - cfg.warmup_steps),
                     cfg.warmup_steps)
    if cfg.schedule in ("warmup_plateau", "constant"):
        return _join(warmup, lambda count: F32(cfg.learning_rate),
                     cfg.warmup_steps)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def needs_loss_value(cfg: OptimizerConfig) -> bool:
    """True if the optimizer's update requires `value=loss` (plateau)."""
    return cfg.schedule == "warmup_plateau"


def plateau_uses_eval(cfg: OptimizerConfig) -> bool:
    """True when the plateau observes the cadenced EVAL loss instead of
    the per-step train loss."""
    if cfg.plateau_metric not in ("train_loss", "eval_loss"):
        raise ValueError(
            f"unknown plateau_metric {cfg.plateau_metric!r}; "
            "expected 'train_loss' or 'eval_loss'")
    return (cfg.schedule == "warmup_plateau"
            and cfg.plateau_metric == "eval_loss")


@dataclasses.dataclass
class OptState:
    """The chain's state: Adam's update count (also the schedule's),
    first and second moments aligned with the params' leaves, and the
    plateau transform's 0-d device tensors (None without a plateau)."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    plateau: Optional[Dict[str, torch.Tensor]] = None


class Optimizer:
    """clip → Adam(W)(schedule) [→ plateau], as `make_optimizer` chains
    them in the JAX package. `update(grads, state, params, value=)`
    returns (updates, state) like an optax transformation."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.plateau = cfg.schedule == "warmup_plateau"

    def init(self, params) -> OptState:
        leaves = tree_leaves(params)
        plateau = None
        if self.plateau:
            dev = leaves[0].device
            plateau = {
                "best_value": torch.tensor(float("inf"), device=dev),
                "plateau_count": torch.tensor(0, dtype=torch.int32,
                                              device=dev),
                "scale": torch.tensor(1.0, device=dev),
                "cooldown_count": torch.tensor(0, dtype=torch.int32,
                                               device=dev),
                "count": torch.tensor(0, dtype=torch.int32, device=dev),
                "avg_value": torch.tensor(0.0, device=dev),
            }
        return OptState(0, [torch.zeros_like(t) for t in leaves],
                        [torch.zeros_like(t) for t in leaves], plateau)

    def update(self, grads: List[torch.Tensor], state: OptState,
               params=None, value: Any = None, grad_norm: Any = None
               ) -> Tuple[List[torch.Tensor], OptState]:
        """`grad_norm`: the gradients' TRUE global norm, given when `grads`
        are one rank's shards of them (ZeRO-1, the JAX
        `make_optimizer(clip_norm_value=)`); the clip then uses it
        instead of measuring `grads`."""
        cfg = self.cfg
        g = clip_by_global_norm(list(grads), cfg.grad_clip_norm, grad_norm)
        b1, b2 = cfg.b1, cfg.b2
        # mu = (1-b1)·g + b1·mu; nu = (1-b2)·g² + b2·nu
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(g, 1 - b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, g2)
        count = state.count + 1
        bc1 = F32(1) - F32(b1) ** F32(count)
        bc2 = F32(1) - F32(b2) ** F32(count)
        denom = torch._foreach_div(state.nu, float(bc2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(state.mu, float(bc1))
        torch._foreach_div_(updates, denom)
        if cfg.weight_decay > 0:
            torch._foreach_add_(updates, torch._foreach_mul(
                tree_leaves(params), cfg.weight_decay))
        torch._foreach_mul_(updates, float(-self.schedule(state.count)))
        plateau = state.plateau
        if plateau is not None:
            if value is None:
                raise ValueError("the plateau schedule needs value=loss")
            plateau = self._plateau(plateau, value)
            torch._foreach_mul_(updates, plateau["scale"])
        return updates, OptState(count, state.mu, state.nu, plateau)

    def _plateau(self, st: Dict[str, torch.Tensor],
                 value) -> Dict[str, torch.Tensor]:
        """optax.contrib.reduce_on_plateau's update, branch-free on the
        device."""
        cfg = self.cfg
        value = torch.as_tensor(value, dtype=torch.float32,
                                device=st["avg_value"].device)
        count = st["count"] + 1
        avg = (st["count"].float() * st["avg_value"] + value) / count.float()
        improved = avg < (1 - PLATEAU_RTOL) * st["best_value"] - PLATEAU_ATOL
        best = torch.where(improved, avg, st["best_value"])
        curr = torch.where(improved, torch.zeros_like(count),
                           st["plateau_count"] + 1)
        cooling = st["cooldown_count"] > 0
        cut = curr == cfg.plateau_patience
        zero = torch.zeros_like(count)
        new_pc = torch.where(cooling, zero, torch.where(cut, zero, curr))
        new_scale = torch.where(cooling, st["scale"], torch.where(
            cut, st["scale"] * cfg.plateau_factor, st["scale"]).clamp_min(
                0.0))
        new_cd = torch.where(cooling, st["cooldown_count"] - 1, torch.where(
            cut, torch.full_like(count, cfg.plateau_cooldown), zero))
        fire = count == cfg.plateau_window
        keep = {"best_value": st["best_value"],
                "plateau_count": st["plateau_count"], "scale": st["scale"],
                "cooldown_count": st["cooldown_count"]}
        fired = {"best_value": best, "plateau_count": new_pc,
                 "scale": new_scale, "cooldown_count": new_cd}
        out = {k: torch.where(fire, fired[k], keep[k]) for k in keep}
        out["count"] = torch.where(fire, zero, count)
        out["avg_value"] = torch.where(fire, torch.zeros_like(avg), avg)
        return out


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ Σ x²) over the leaves, float32 (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([t.float() for t in tensors])))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Any = None) -> List[torch.Tensor]:
    """optax.clip_by_global_norm, in place: (g / ‖g‖) · max_norm when
    ‖g‖ >= max_norm, else g exactly. No epsilon. `norm` replaces the
    measured ‖g‖ when given."""
    if norm is None:
        norm = global_norm(grads)
    trigger = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(trigger, one, norm))
    torch._foreach_mul_(grads, torch.where(trigger, one,
                                           torch.full_like(norm, max_norm)))
    return grads


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    """Clip → Adam(W)(schedule) [→ plateau scaling]."""
    return Optimizer(cfg)


def effective_lr(cfg: OptimizerConfig, opt_state: OptState,
                 step: int) -> torch.Tensor:
    """The LR in effect at update count `step`: the schedule times the
    plateau's current scale."""
    lr = float(make_schedule(cfg)(step))
    if opt_state.plateau is not None:
        return opt_state.plateau["scale"] * lr
    return torch.tensor(lr)
