"""Forming the process group of a multi-process run — port of
`proteinbert_tpu/parallel/multihost.py`.

`maybe_initialize_distributed()` is the single entry point, with the JAX
function's precedence: explicit arguments beat the environment
(COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, the JAX package's
names), which beats torch's own launcher environment (`env://`: RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as `torchrun` sets them — the
counterpart of jax's cluster auto-detection). With neither it is a
single-process no-op that returns False. Idempotent: a default group
that is already formed (by this function or anyone else) counts as
success.

One process drives one card. With NCCL (a CUDA device, the default) the
process binds `cuda:{LOCAL_RANK}` before the group forms — LOCAL_RANK as
`torchrun` sets it, else the rank modulo the host's card count (ranks
numbered host by host) — so two ranks of one host never share a card.
`device="cpu"` forms a gloo group instead.
"""

from __future__ import annotations

import inspect
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from proteinbert_tpu_torch import DeviceLike

logger = logging.getLogger(__name__)


def _device_type(device: DeviceLike) -> str:
    if device is None:
        return "cuda"
    return torch.device(device).type


def _bind_card(rank: int) -> torch.device:
    """The card this rank drives, made current."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("NCCL needs a CUDA device and none is visible")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank % n
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    required: bool = False,
    device: DeviceLike = None,
) -> bool:
    """Form the default process group if this looks like (or is declared
    to be) a multi-process run; returns True when distributed is live.

    `required=True` (the CLI's --multihost) turns a failed join into an
    error — an operator who ASKED for multi-host must not silently get N
    independent single-process runs fighting over one checkpoint
    directory."""
    if dist.is_initialized():
        return True

    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and env.get("NUM_PROCESSES"):
        num_processes = int(env["NUM_PROCESSES"])
    if process_id is None and env.get("PROCESS_ID"):
        process_id = int(env["PROCESS_ID"])

    try:
        if coordinator_address:
            if num_processes is None or process_id is None:
                raise ValueError(
                    "COORDINATOR_ADDRESS needs NUM_PROCESSES and "
                    "PROCESS_ID beside it")
            init_method = f"tcp://{coordinator_address}"
            world, rank = num_processes, process_id
        elif all(env.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                      "MASTER_PORT")):
            init_method = "env://"
            world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        else:
            raise RuntimeError(
                "no distributed environment (neither COORDINATOR_ADDRESS "
                "nor torchrun's RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT)")
        kw = {}
        if _device_type(device) == "cuda":
            backend = "nccl"
            card = _bind_card(rank)
            if "device_id" in inspect.signature(
                    dist.init_process_group).parameters:
                kw["device_id"] = card
        else:
            backend = "gloo"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank, **kw)
    except Exception as e:
        if required:
            raise RuntimeError(
                "multi-host initialization was requested but failed "
                f"({e}); set COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID "
                "or launch with torchrun") from e
        logger.info("single-host run (no distributed env detected: %s)", e)
        return False

    logger.info("torch distributed (%s): process %d/%d", backend,
                dist.get_rank(), dist.get_world_size())
    return True


def process_index() -> int:
    """This process's rank in the default group (0 without one) — the
    counterpart of `jax.process_index()`."""
    return dist.get_rank() if dist.is_initialized() else 0

