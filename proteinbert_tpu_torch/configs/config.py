"""Config system of the PyTorch/CUDA port.

A copy of `proteinbert_tpu/configs/config.py` (the port never imports
the JAX package): the same frozen dataclass tree, presets and JSON
round trip, so a run's config.json loads unchanged in either package.
Fields that only steer the JAX build (the scan knobs) are kept for that
reason; the port runs its blocks in a loop either way, and `scan_blocks`
only sets how route decisions are counted (`models/proteinbert.encode`:
one a family per forward under it, as JAX traces its scanned body once;
else one a block). `remat` is inert: the port's kernel VJPs
already save only their inputs (`kernels/autograd.recompute_vjp`), and a
block kernel's input is what full remat would keep, as the JAX model says
of its own kernel path (both policies degenerate to recompute-everything
there); `remat_policy` is still checked, and a policy other than "full"
or "convs" raises JAX's ValueError where JAX raises it
(`models/proteinbert.check_remat_policy`). `ModelConfig.use_pallas` is
ignored: each block takes the route JAX's gates take with
`use_pallas=True` (`kernels/one_pass.onepass_route`) — a hand-written
kernel on CUDA (its plain PyTorch version on the CPU), or the port of the
XLA reference where JAX's gate refuses the shape and no port kernel
covers it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the dual-track ProteinBERT model.

    Defaults mirror the reference smoke config (reference dummy_tests.py:
    110-118: seq_len 256, local 128, global 512, key 64, 4 heads, 6 blocks)
    but the model here is shape-parametric in seq_len (the reference's
    LayerNorm hard-codes L at construction, modules.py:148-151 — fixed).
    """

    vocab_size: int = 26                # 22 AA chars + 4 specials (data/vocab.py)
    num_annotations: int = 8943         # GO terms with >=100 records (SURVEY C3)
    local_dim: int = 128                # local (per-residue) channel dim C
    global_dim: int = 512               # global (per-protein) dim G
    key_dim: int = 64                   # attention key dim per head
    num_heads: int = 4                  # global-attention heads
    num_blocks: int = 6                 # dual-track blocks
    narrow_kernel: int = 9              # narrow Conv1d kernel (modules.py:126)
    wide_kernel: int = 9                # wide Conv1d kernel (modules.py:137)
    wide_dilation: int = 5              # wide Conv1d dilation (modules.py:141)
    dtype: str = "bfloat16"             # activation dtype (MXU-native)
    param_dtype: str = "float32"        # parameter dtype
    remat: bool = False                 # jax.checkpoint each block
    remat_policy: str = "full"          # "full" (recompute everything) |
                                        # "convs" (save the two conv outputs
                                        # per block — ~85% of block FLOPs —
                                        # and recompute only the cheap tail)
    scan_blocks: bool = True            # lax.scan over stacked block params
    scan_unroll: int = 1                # lax.scan unroll factor: XLA sees k
                                        # block bodies per iteration and can
                                        # keep activation layouts across
                                        # them (the scan-boundary transposes
                                        # are a measured cost,
                                        # docs/performance.md); full unroll
                                        # (scan_blocks=False) is compile-
                                        # prohibitive at real sizes
    scan_split_transpose: bool = False  # lax.scan(_split_transpose=True):
                                        # transpose the block scan as two
                                        # passes (recompute-forward, then
                                        # grad sweep) so XLA can schedule
                                        # the saves' layout traffic
                                        # separately from the grad math —
                                        # an experimental alternative lever
                                        # on the same measured scan-
                                        # boundary cost scan_unroll targets
    use_pallas: bool = False            # Pallas fused local-track kernel

    @property
    def value_dim(self) -> int:
        # reference modules.py:119: value_dim = global_dim // num_heads
        assert self.global_dim % self.num_heads == 0
        return self.global_dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Online pipeline: tokenization + denoising corruption.

    Probabilities follow the reference corruption pipeline (reference
    data_processing.py:86-142), with the hide-all-annotations branch kept as
    an explicit knob (SURVEY ledger #5).
    """

    seq_len: int = 256                      # fixed padded length fed to the model
    buckets: Optional[Tuple[int, ...]] = None  # length buckets (last == seq_len);
                                            # None = single padded length
    packing: bool = False                   # segment-aware sequence packing
                                            # (data/packing.py): several
                                            # proteins per fixed-shape row
                                            # with segment ids — ONE compiled
                                            # shape, ~zero pad FLOPs; mutually
                                            # exclusive with buckets
    pack_max_segments: int = 8              # max proteins per packed row (the
                                            # S axis of the per-segment
                                            # annotation tensor)
    pack_open_bins: int = 0                 # packer look-back: open rows the
                                            # first-fit planner keeps before
                                            # closing the oldest (0 = auto,
                                            # 2 x global batch)
    token_randomize_prob: float = 0.05      # data_processing.py:90
    annotation_corrupt_prob: float = 0.5    # P(keep-and-noise); else hide all
                                            # (data_processing.py:127-128)
    annotation_drop_prob: float = 0.25      # drop positives (data_processing.py:116)
    annotation_add_prob: float = 1e-4       # add false positives (:117)
    batch_size: int = 32
    prefetch_depth: int = 2                 # host batches produced ahead on a
                                            # background thread (0 = off)
    num_epochs: Optional[int] = None        # bound the data stream; None =
                                            # loop forever (iteration-based,
                                            # like the reference)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam + warmup schedule (reference dummy_tests.py:127-130, utils.py:257-264).

    The reference chains LambdaLR warmup into ReduceLROnPlateau via
    SequentialLR, which crashes after warmup (SURVEY ledger #7). Here both a
    correct warmup+plateau and warmup+cosine are provided.
    """

    learning_rate: float = 2e-4             # dummy_tests.py:128
    warmup_steps: int = 10_000              # utils.py:233 warmup_duration
    schedule: str = "warmup_plateau"        # "warmup_plateau" | "warmup_cosine" | "constant"
    total_steps: int = 100_000              # cosine horizon
    plateau_window: int = 100               # steps averaged into ONE plateau
                                            # observation (set ≈ eval_every so
                                            # the signal tracks eval cadence,
                                            # not per-step batch noise)
    plateau_patience: int = 10              # windowed observations without
                                            # improvement before LR is cut
    plateau_factor: float = 0.1             # plateau: LR multiplier on trigger
    plateau_cooldown: int = 10              # observations to ignore after a cut
                                            # (lets the loss re-baseline before
                                            # another reduction can chain)
    plateau_metric: str = "train_loss"      # "train_loss" | "eval_loss" — what
                                            # reduce_on_plateau observes. The
                                            # reference intended a METRIC-driven
                                            # ReduceLROnPlateau (utils.py:257-264
                                            # — it crashed); "eval_loss" feeds
                                            # the latest cadenced held-out loss
                                            # to the transform every step, so an
                                            # eval-only regime shift (train loss
                                            # falling while eval rises — the
                                            # r3 sustained run) CAN cut the LR.
                                            # Set plateau_window ≈ eval_every so
                                            # one windowed observation covers one
                                            # eval interval; requires eval_every
                                            # > 0 and an eval split. The trainer
                                            # seeds the stream with an up-front
                                            # eval bracket so the plateau window
                                            # never mixes train-scale values
                                            # (ADVICE r4).
    grad_clip_norm: float = 1.0             # reference clips grads (utils.py:136)
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes — entirely new vs the reference (SURVEY C18: absent).

    Axes: data (DP), fsdp (param/optimizer sharding over data axis), model
    (TP over global/annotation dims), seq (sequence parallelism for the
    local conv track with halo exchange).
    """

    data: int = 1
    fsdp: int = 1
    model: int = 1
    seq: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "fsdp", "model", "seq")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.fsdp, self.model, self.seq)

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Cross-replica execution strategy knobs (beyond the mesh SHAPE,
    which stays in MeshConfig).

    zero_update: ZeRO-1 sharded weight update (Xu et al.,
      arXiv:2004.13336). The pure `data` axis normally replicates fp32
      params and Adam mu/nu on every replica and pays a full gradient
      all-reduce per step; with zero_update the train step
      reduce-scatters gradients over ('data','fsdp'), applies the
      optimizer to a 1/(data*fsdp) shard, and all-gathers the updated
      params — Adam state HBM drops by ~(1 - 1/data_extent) on top of
      fsdp, for near-equal total collective bytes (reduce-scatter +
      all-gather ≈ all-reduce). Sharded-optimizer storage lives in
      parallel/sharding.py (zero-aware state_sharding); the update
      itself in parallel/zero.py. No-op without a mesh or when
      data*fsdp == 1.
    grad_reduce_dtype: payload dtype of the ZeRO-1 gradient reduction
      — "fp32" (exact, the implicit-SPMD reduce-scatter), or "bf16" /
      "int8": the QUANTIZED reduce-scatter (parallel/quant.py,
      EQuARX-style, arXiv:2506.17615). The quantized step computes
      per-replica partial gradients inside an explicit data-parallel
      shard_map and reduces them over quantized payloads — bf16
      (stochastic rounding, 2x fewer wire bytes) or int8 (per-chunk
      symmetric scale + stochastic rounding seeded from the step key:
      deterministic and multi-host lockstep, ~4x fewer wire bytes) —
      with the optimizer math fp32 on the dequantized shards and the
      clip norm measured on the dequantized sum. Wire bytes are
      verified from compiled HLO (bench.py --comm,
      zero.collective_wire_bytes_from_hlo); parity bounds are measured
      in tests/test_quant.py and documented in docs/distributed.md.
      Quantized payloads need a data/fsdp-only mesh (model>1 or seq>1
      raises the typed QuantConfigError — the explicit replica
      shard_map cannot shard those axes), a global batch divisible by
      data*fsdp, and are rejected by the explicit seq-parallel Pallas
      step (int8; its bf16 stays the PR-2 cast-only numerics-only
      reduction). Only consulted by the zero_update path.
    """

    zero_update: bool = False
    grad_reduce_dtype: str = "fp32"         # "fp32" | "bf16" | "int8"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Online-serving knobs that belong to the MODEL's run config (the
    CLI owns transport knobs like ports and queue depths; these ride
    config.json so `pbt serve --pretrained RUN_DIR` picks them up).

    quant: which executable arm the dispatcher builds (parallel/
      quant.py) — "fp32" (ordinary), "int8" (symmetric per-channel
      int8 WEIGHTS quantized at load time, dequantized inside the
      executable: ~4x smaller resident trunk — the HBM headroom two
      resident trunks need), or "int8_act" (int8 weights + opt-in
      dynamic int8 fake-quant of the trunk's output activations).
      Overridable per serve process via `pbt serve --quant`.
    quant_parity_every: with a quantized arm, every Nth dispatched
      batch ALSO runs the fp32 executables on the same inputs and
      records the per-request max-abs output deviation
      (`serve_quant_parity_max` gauge, stats()["quant"], serve_batch
      events) — live parity evidence at 1/N the cost. 0 disables.
    pipeline_depth: bounded in-flight window for pipelined dispatch:
      the scheduler submits up to this many batches before
      blocking, and a completer thread resolves device results while
      the next batch forms — device compute overlaps host fetch +
      fan-out. 1 disables the completer and restores the serial
      submit-then-finalize path bit-for-bit. Overridable per serve
      process via `pbt serve --pipeline-depth`.
    """

    quant: str = "fp32"                     # "fp32" | "int8" | "int8_act"
    quant_parity_every: int = 0
    pipeline_depth: int = 2


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint cadence (reference utils.py:227 nb_iterations_checkpoint=1000)."""

    directory: str = "checkpoints"
    every_steps: int = 1000
    max_to_keep: int = 3
    async_save: bool = True
    overlap: bool = True                    # overlapped boundary: snapshot
                                            # the state on device and run
                                            # the device→host fetch + save
                                            # on a stager thread while the
                                            # train stream keeps
                                            # dispatching — the boundary
                                            # costs ~zero wall time instead
                                            # of drain→fetch→save
                                            # (single-process runs only;
                                            # multi-host falls back to the
                                            # synchronous collective save)
    warm_start: bool = False                # save once at the start step,
                                            # BEFORE the perf timer anchors:
                                            # pays orbax setup + the first
                                            # full device->host fetch up
                                            # front, so the first cadenced
                                            # save's one-time cost cannot
                                            # land in the timed stream (the
                                            # r3 collapse's 650-800 stretch,
                                            # BASELINE.md round-5
                                            # attribution)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Iteration-based pretraining loop config (reference utils.py:220-231)."""

    max_steps: int = 250                    # dummy_tests.py:141 smoke default
    log_every: int = 10
    eval_every: int = 0                     # 0 = no eval
    on_nan: str = "halt"                    # "halt" | "warn" | "off" — NaN/Inf
                                            # watch on logged loss/grad_norm
                                            # (train/resilience.py)
    early_stop_patience: int = 0            # consecutive cadenced evals without
                                            # eval_loss improvement before the
                                            # run checkpoints and stops; 0 = off.
                                            # The best/stalled counters (and the
                                            # latest eval loss the eval-keyed
                                            # plateau observes) are CHECKPOINTED
                                            # with the data position, so a
                                            # preempt/requeue loop cannot reset
                                            # the patience baseline.
    early_stop_min_delta: float = 0.0       # improvement smaller than this
                                            # still counts as a stall
    overlap_eval: bool = True               # dispatch the periodic eval
                                            # bracket asynchronously and
                                            # resolve its metrics after the
                                            # next train step has been
                                            # dispatched, instead of a
                                            # synchronous fetch-per-batch
                                            # bracket. Applied only where
                                            # legal: an eval-keyed plateau
                                            # or early stopping needs the
                                            # eval value BEFORE the next
                                            # step and keeps the
                                            # synchronous bracket.
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """A supervised fine-tuning task on the pretrained trunk (SURVEY C14 —
    the reference's fine-tune harness exists only as commented-out code,
    reference utils.py:348-493; completed here).

    Kinds (the ProteinBERT paper's benchmark shapes):
      token_classification  — per-residue labels (secondary structure);
      sequence_classification — per-protein label (remote homology);
      sequence_regression   — per-protein scalar (stability, fluorescence).
    """

    kind: str = "token_classification"
    num_outputs: int = 8                # classes, or 1 for regression
    freeze_trunk: bool = False          # train head only
    head_hidden_dim: int = 0            # 0 = linear head, else one MLP layer
    epochs: int = 10
    eval_every_epochs: int = 1


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    model: "ModelConfig" = dataclasses.field(default_factory=lambda: ModelConfig())
    task: TaskConfig = dataclasses.field(default_factory=TaskConfig)
    data: "DataConfig" = dataclasses.field(default_factory=lambda: DataConfig())
    optimizer: "OptimizerConfig" = dataclasses.field(
        default_factory=lambda: OptimizerConfig(
            learning_rate=1e-4, warmup_steps=100, schedule="warmup_cosine",
            total_steps=10_000,
        )
    )
    checkpoint: "CheckpointConfig" = dataclasses.field(
        default_factory=lambda: CheckpointConfig(directory="finetune_checkpoints")
    )
    train: "TrainConfig" = dataclasses.field(default_factory=lambda: TrainConfig())

    def replace(self, **kw) -> "FinetuneConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)

    def replace(self, **kw) -> "PretrainConfig":
        return dataclasses.replace(self, **kw)


def _tiny() -> PretrainConfig:
    # BASELINE.json configs[0]: 2 blocks, d=128, seq_len=128 — CPU smoke.
    return PretrainConfig(
        model=ModelConfig(local_dim=32, global_dim=128, key_dim=32, num_heads=4,
                          num_blocks=2, num_annotations=512, dtype="float32"),
        data=DataConfig(seq_len=128, batch_size=8),
        optimizer=OptimizerConfig(warmup_steps=50, total_steps=250),
        train=TrainConfig(max_steps=250),
    )


def _base() -> PretrainConfig:
    # BASELINE.json configs[1]: 6 blocks, d=512, seq_len=512 — v5e-16 DP.
    # remat on: the scan otherwise saves fp32 LN intermediates for all 6
    # blocks (~12G at batch 128 on a 16G chip) and is HBM-bound; measured
    # on v5e-1 remat is BOTH smaller and faster (MFU 0.52 vs 0.39), and
    # the "convs" policy (save conv outputs, recompute the cheap tail)
    # another +8% over full remat (MFU 0.56, BASELINE.md).
    return PretrainConfig(
        model=ModelConfig(local_dim=512, global_dim=512, key_dim=64, num_heads=8,
                          num_blocks=6, remat=True, remat_policy="convs"),
        data=DataConfig(seq_len=512, batch_size=128),
        optimizer=OptimizerConfig(warmup_steps=10_000, total_steps=1_000_000),
        train=TrainConfig(max_steps=1_000_000),
        mesh=MeshConfig(data=16),
    )


def _long() -> PretrainConfig:
    # BASELINE.json configs[2]: seq_len=2048 long-context, sequence-parallel,
    # length-bucketed (most UniRef sequences are far shorter than 2048).
    return PretrainConfig(
        model=ModelConfig(local_dim=512, global_dim=512, key_dim=64, num_heads=8,
                          num_blocks=6, remat=True, remat_policy="convs"),
        data=DataConfig(seq_len=2048, batch_size=64,
                        buckets=(512, 1024, 2048)),
        optimizer=OptimizerConfig(warmup_steps=10_000, total_steps=1_000_000),
        train=TrainConfig(max_steps=1_000_000),
        mesh=MeshConfig(data=4, seq=4),
    )


def _large() -> PretrainConfig:
    # BASELINE.json configs[4]: 12 blocks, d=1024, full 8943-dim GO head.
    return PretrainConfig(
        model=ModelConfig(local_dim=1024, global_dim=1024, key_dim=64,
                          num_heads=16, num_blocks=12, remat=True,
                          remat_policy="convs"),
        data=DataConfig(seq_len=1024, batch_size=256),
        optimizer=OptimizerConfig(warmup_steps=10_000, total_steps=2_000_000),
        train=TrainConfig(max_steps=2_000_000),
        mesh=MeshConfig(data=64, model=4),
    )


PRESETS = {
    "tiny": _tiny,
    "base": _base,
    "long": _long,
    "large": _large,
}


def get_preset(name: str) -> PretrainConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}") from None


def config_to_dict(cfg) -> dict:
    """Frozen config tree → plain JSON-serializable dict (tuples become
    lists; from_dict restores them)."""
    return dataclasses.asdict(cfg)


def _build(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if isinstance(v, dict):
            # Nested config: resolve the node class from the field's
            # default (f.type is a string under PEP 563 annotations).
            default = (f.default_factory() if f.default_factory
                       is not dataclasses.MISSING else f.default)
            kwargs[f.name] = _build(type(default), v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)  # configs must stay hashable
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def config_from_dict(data: dict, cls=None):
    """Inverse of config_to_dict. `cls` defaults to PretrainConfig."""
    return _build(cls or PretrainConfig, data)


def save_config(cfg, path: str) -> None:
    """Write the config as JSON (pretrain drops one into the run dir so
    downstream commands need no repeated --pretrained-set flags).

    Atomic (temp file + rename): a crash mid-write must not leave a
    truncated config.json that poisons every later --pretrained consumer
    of an otherwise-valid run dir."""
    import json
    import os
    import tempfile

    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp",
                               dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(config_to_dict(cfg), f, indent=2, sort_keys=True)
        os.chmod(tmp, 0o644)  # mkstemp is 0600
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_config(path: str, cls=None):
    import json

    with open(path) as f:
        return config_from_dict(json.load(f), cls)
