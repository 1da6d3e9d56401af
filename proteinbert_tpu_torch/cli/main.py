"""The port's command line: `python -m proteinbert_tpu_torch <command>`.

The counterpart of `proteinbert_tpu/cli/main.py`, with that CLI's verbs,
flags, defaults, messages and exit codes over the port's modules:

  pretrain           denoising pretrain from an HDF5 file or synthetic data
  smoke              the end-to-end sanity run (tiny preset)
  finetune           supervised task head on a (pretrained) trunk
                     (--register-head saves it into a head registry)
  eval-heads         score registered heads on labeled/synthetic data
  convert-torch      reference torch checkpoint → port run dir
  export-weights     port run dir → flat NPZ of named arrays
  import-weights     flat NPZ → port run dir (the JAX package's
                     export-weights NPZ included)
  evaluate           score a checkpoint on a dataset (loss/acc/AUROC/p@k)
  diagnose           summarize a run's telemetry events (+ flight dump)
  embed              trunk representations for sequences → HDF5/NPZ
  predict-go         GO-annotation probabilities from sequence alone
  predict-residues   fill '?'-masked residues, report per-position probs
  serve              online JSON/HTTP inference server
  map                resumable sharded batch inference into an embedding
                     store (--verify audits it)
  index              int8 IVF neighbor index over a completed store
  fleet              N serve replicas behind a self-healing router
  rollout            blue-green trunk rollout against a running fleet
  check              the port's static analyzer (graph purity and launch
                     or raise, locks, durability, event schema, doc
                     drift, dead exports)
  reshard            carry a checkpoint to another mesh layout
  create-uniref-db   UniRef XML → SQLite (shardable over a task array)
  merge-uniref-dbs   merge task-array shard DBs (+ the GO meta CSV)
  create-h5          SQLite + FASTA → HDF5 dataset (needs h5py)
  data-bench         host input-pipeline throughput probe

Where it departs from the JAX CLI:

- `--device {cuda,cpu}` (before the verb, default cuda) replaces
  `--platform`. A verb that makes tensors runs on the card, and without
  one exits with the device message; `--device cpu` runs the kernels'
  plain PyTorch versions. `fleet` passes it on to its replicas.
- One process a card: `pretrain --multihost` joins the process group
  (`parallel.multihost`, from COORDINATOR_ADDRESS / NUM_PROCESSES /
  PROCESS_ID or torchrun's environment) and trains the data x fsdp x
  model x seq mesh of `cfg.mesh` over it (any combination of the axes);
  a mesh whose device count is not the world size is refused with the
  JAX message. `cfg.data.batch_size` is the GLOBAL batch (each replica
  feeds batch_size / (data·fsdp) rows), where the JAX CLI's is per host.
  Only process 0 writes config.json, --events-jsonl and --metrics-jsonl.
  `--compile-cache-dir` is refused (the port's warm shapes are CUDA
  graphs, which a process cannot reload), before parsing
  (`REFUSED_FLAGS`).
- `serve --mesh` is one process, as in JAX: `cfg.mesh` laid over the
  visible cards (`--device cpu`: the CPU, one device), a served batch
  split over the data·fsdp replicas, one dispatcher lane a replica
  (`parallel/mesh.serve_mesh`); a mesh whose device count is not the
  cards' exits with the JAX message.
- `--pretrained` names a port run directory (`train/checkpoint.
  Checkpointer` step directories plus `config.json`); an orbax directory
  of the JAX package is refused with the way across: `export-weights` in
  the JAX package, then `import-weights` here.
- The corpus verbs (`create-uniref-db`, `merge-uniref-dbs`, `create-h5`)
  and `data-bench` touch no tensor: they run with or without a card and
  ignore `--device`.
- `check` analyzes the port (`proteinbert_tpu_torch/analysis/`): its
  `graph-purity` rule takes the place of the JAX `jit-purity`, and its
  baseline is `proteinbert_tpu_torch/analysis/check_baseline.json`. It
  touches no tensor and ignores `--device`.
- `reshard` copies a full-shape step file (a port checkpoint is
  full-shape whatever mesh wrote it) and needs none of the target's
  cards: it does not refuse a target mesh larger than the machine, as
  the JAX verb does. It touches no device and ignores `--device`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import List, Optional

from proteinbert_tpu_torch.utils.logging import log, start_log

NO_CARD = ("no CUDA device is available: the port runs its kernels on the "
           "card; pass --device cpu (before the command) to run their "
           "plain PyTorch versions on the CPU")

# Flags of the JAX CLI the port refuses, with the reason (checked before
# parsing, so each gets its own message instead of argparse's).
REFUSED_FLAGS = {
    "--platform": "--platform is the JAX CLI's backend switch; the port "
                  "takes --device {cuda,cpu} (before the command)",
    "--compile-cache-dir": "--compile-cache-dir arms XLA's persistent "
                           "compilation cache; the port's warm shapes are "
                           "CUDA graphs, which a process cannot reload, so "
                           "there is no cache to arm",
}


# ------------------------------------------------------------------ types

def existing_file(path: str) -> str:
    """Validated argparse type."""
    if not os.path.isfile(path):
        raise argparse.ArgumentTypeError(f"not a file: {path}")
    return path


def creatable_path(path: str) -> str:
    parent = os.path.dirname(os.path.abspath(path))
    if not os.path.isdir(parent):
        raise argparse.ArgumentTypeError(f"parent dir missing: {path}")
    return path


# -------------------------------------------------------------- config CLI

def apply_overrides(cfg, overrides: List[str]):
    """`--set model.local_dim=256` dotted-path overrides on the frozen
    dataclass config tree."""
    for ov in overrides:
        if "=" not in ov:
            raise SystemExit(f"--set expects path=value, got {ov!r}")
        path, raw = ov.split("=", 1)
        keys = path.split(".")
        node_path = []
        node = cfg
        for k in keys[:-1]:
            if not hasattr(node, k):
                raise SystemExit(f"unknown config path {path!r}")
            node_path.append((node, k))
            node = getattr(node, k)
        leaf = keys[-1]
        if not hasattr(node, leaf):
            raise SystemExit(f"unknown config path {path!r}")
        current = getattr(node, leaf)
        value = _parse_value(raw, current)
        node = dataclasses.replace(node, **{leaf: value})
        for parent, k in reversed(node_path):
            node = dataclasses.replace(parent, **{k: node})
        cfg = node
    return cfg


def _parse_value(raw: str, current):
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if current is None or isinstance(current, tuple):
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            if current is None:
                return raw  # string-valued optional fields
            raise SystemExit(
                f"expected a JSON list (e.g. [512,1024]) or null, got {raw!r}")
        # Configs stay hashable (the dispatchers key caches on them).
        return tuple(value) if isinstance(value, list) else value
    return type(current)(raw)


# ---------------------------------------------------------------- helpers

def _device(args):
    """The torch device of `--device`; exits with NO_CARD when the card
    is asked for (the default) and absent."""
    from proteinbert_tpu_torch import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError:
        raise SystemExit(NO_CARD)


def _make_mesh(cfg):
    """The run's mesh over the process group (None for a one-device mesh
    without a group); exits with the JAX message when the mesh is not the
    world."""
    import torch.distributed as dist

    from proteinbert_tpu_torch.parallel.mesh import make_mesh

    if cfg.mesh.num_devices == 1 and not dist.is_initialized():
        return None
    try:
        mesh = make_mesh(cfg.mesh)
    except ValueError as e:
        axes = {a: s for a, s in zip(cfg.mesh.axis_names, cfg.mesh.shape)
                if s > 1}
        hint = " ".join(f"--set mesh.{a}=1" for a in axes)
        raise SystemExit(
            f"{e}: launch {cfg.mesh.num_devices} processes, one a device, "
            f"with --multihost, or run with {hint}")
    log(f"mesh: {mesh.shape} over {mesh.size} processes")
    return mesh


def _check_run_dir(path: str) -> None:
    """Refuse an orbax run directory (the JAX package's checkpoints):
    step directories without the port's `state.pt`."""
    if not os.path.isdir(path):
        return
    steps = [n for n in os.listdir(path)
             if n.isdigit() and os.path.isdir(os.path.join(path, n))]
    if steps and not any(os.path.isfile(os.path.join(path, n, "state.pt"))
                         for n in steps):
        raise SystemExit(
            f"{path} is not a port run directory (its step directories "
            "hold no state.pt; an orbax run directory of the JAX "
            "package?). Carry JAX weights across as a flat NPZ: `python "
            "-m proteinbert_tpu export-weights --pretrained <run> --output "
            "w.npz`, then `python -m proteinbert_tpu_torch import-weights "
            "--weights w.npz --output <port run>`")


def _build_config(args):
    from proteinbert_tpu_torch.configs import get_preset

    cfg = get_preset(args.preset)
    if args.max_steps is not None:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, max_steps=args.max_steps))
    if args.checkpoint_dir is not None:
        cfg = cfg.replace(checkpoint=dataclasses.replace(
            cfg.checkpoint, directory=args.checkpoint_dir))
    return apply_overrides(cfg, args.set or [])


def _read_named_seqs(args) -> tuple:
    """(ids, seqs) from --fasta, --seqs-file (id<TAB>seq or bare seq per
    line), or positional sequences — shared by the inference commands."""
    if getattr(args, "fasta", None):
        from proteinbert_tpu_torch.etl.fasta import iter_fasta

        pairs = list(iter_fasta(args.fasta))  # name = first header word
        return [name for name, _ in pairs], [s for _, s in pairs]
    if getattr(args, "seqs_file", None):
        ids, seqs = [], []
        with open(args.seqs_file) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                if "\t" in line:
                    name, seq = line.split("\t", 1)
                else:
                    name, seq = f"seq{i}", line
                ids.append(name)
                seqs.append(seq)
        return ids, seqs
    if getattr(args, "seqs", None):
        return [f"seq{i}" for i in range(len(args.seqs))], list(args.seqs)
    raise SystemExit("provide --fasta, --seqs-file, or positional sequences")


def _export_metrics(tele) -> None:
    """Persist the run's metrics registry beside the events stream: one
    appended JSONL snapshot (`<events>.metrics.jsonl`) plus the
    Prometheus textfile (`<events>.prom`). Best-effort — the run's
    outcome never depends on a metrics sink."""
    if tele.events is None:
        return
    base = tele.events.path
    try:
        tele.metrics.write_snapshot(base + ".metrics.jsonl")
        tele.metrics.write_prometheus(base + ".prom")
    except OSError as e:
        log(f"could not export telemetry metrics: {e}")


def _telemetry(path: Optional[str], **kw):
    """A Telemetry writing `path` with the flight recorder's excepthook
    armed, or None without a path."""
    if not path:
        return None
    from proteinbert_tpu_torch.obs import Telemetry

    tele = Telemetry(events_path=path, **kw)
    tele.flight.install_excepthook()  # unhandled exception → dump
    return tele


def _save_run_config(cfg, directory: str) -> None:
    """Record the resolved config beside a run's checkpoints (the file
    _pretrain_run_config and the --pretrained consumers read back; the
    JAX package's schema)."""
    from proteinbert_tpu_torch.configs import save_config

    os.makedirs(directory, exist_ok=True)
    save_config(cfg, os.path.join(os.path.abspath(directory), "config.json"))


def _synthetic_dataset(cfg, n_min: int):
    """Synthetic random-protein fallback dataset shared by pretrain and
    evaluate when no --data is given (the JAX CLI's draws)."""
    import numpy as np

    from proteinbert_tpu_torch.data.dataset import InMemoryPretrainingDataset
    from proteinbert_tpu_torch.data.synthetic import make_random_proteins

    rng = np.random.default_rng(cfg.train.seed)
    seqs, ann = make_random_proteins(
        max(4 * cfg.data.batch_size, n_min), rng,
        num_annotations=cfg.model.num_annotations)
    return InMemoryPretrainingDataset(seqs, ann, cfg.data.seq_len)


def _pretrain_run_config(pretrained: str, preset: str, overrides):
    """The config describing a pretrain run dir: its saved config.json
    when present, else the named preset; --pretrained-set overrides apply
    on top either way."""
    from proteinbert_tpu_torch.configs import get_preset, load_config

    path = os.path.join(pretrained, "config.json")
    if os.path.isfile(path):
        try:
            cfg = load_config(path)
        except (ValueError, TypeError, OSError) as e:
            raise SystemExit(
                f"corrupt config.json in {pretrained} ({e}); delete it and "
                "pass --preset/--pretrained-set describing the run instead")
    else:
        cfg = get_preset(preset)
    return apply_overrides(cfg, overrides or [])


def _load_state(args, cfg):
    """(TrainState, step) of the newest checkpoint of --pretrained."""
    from proteinbert_tpu_torch import inference

    device = _device(args)
    _check_run_dir(args.pretrained)
    try:
        return inference.load_state(args.pretrained, cfg, device)
    except FileNotFoundError:
        raise SystemExit(f"no checkpoint found in {args.pretrained}")


def _load_inference_trunk(args):
    """(params, cfg) for the inference commands: recover the pretrain-run
    config (config.json, or --preset + --pretrained-set) and load the
    latest checkpoint onto --device."""
    cfg = _pretrain_run_config(args.pretrained, args.preset,
                               args.pretrained_set)
    state, step = _load_state(args, cfg)
    log(f"loaded trunk from {args.pretrained} (step {step})")
    return state.params, cfg


def _write_run_dir(cfg, params, step: int, output: str, device) -> None:
    """Seed a port run directory from imported params (shared by
    convert-torch and import-weights): a fresh train state carrying the
    given params and iteration counter, saved synchronously."""
    import torch

    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.train_state import create_train_state

    state = create_train_state(torch.Generator().manual_seed(cfg.train.seed),
                               cfg, device)
    state = dataclasses.replace(state, params=params, step=step)
    ck = Checkpointer(output, async_save=False)
    ck.save(step, state, {"batches_consumed": step})
    ck.close()
    _save_run_config(cfg, output)


# ------------------------------------------------------------- subcommands

# ------------------------------------------------------- corpus commands

def cmd_create_uniref_db(args) -> int:
    from proteinbert_tpu_torch.etl import (
        UnirefToSqliteParser, parse_obo, save_meta_csv,
    )
    from proteinbert_tpu_torch.utils.sharding import (
        shard_file_name, task_identity,
    )

    task_index, task_count = task_identity(args.task_index, args.task_count)
    db_path = shard_file_name(args.output_db, task_index, task_count)
    log(f"parsing {args.uniref_xml} (shard {task_index}/{task_count}) → {db_path}")
    onto = parse_obo(args.go_meta)
    parser = UnirefToSqliteParser(
        args.uniref_xml, onto, db_path,
        shard_index=task_index, num_shards=task_count,
        max_entries=args.records_limit,
    )
    parser.parse()
    if args.go_meta_csv and task_count == 1:
        save_meta_csv(onto, args.go_meta_csv, counts=parser.go_record_counts,
                      total_records=parser.n_records_with_any_go)
        log(f"wrote GO meta CSV → {args.go_meta_csv}")
    elif args.go_meta_csv:
        log("sharded run: write the meta CSV from merge-uniref-dbs instead")
    return 0


def cmd_merge_uniref_dbs(args) -> int:
    from proteinbert_tpu_torch.etl import (
        merge_shard_dbs, parse_obo, read_aggregates, save_meta_csv,
    )
    from proteinbert_tpu_torch.utils.sharding import all_shard_file_names

    if not args.shards and args.num_shards is None:
        raise SystemExit("merge-uniref-dbs needs --shards or --num-shards")
    shards = args.shards or all_shard_file_names(args.output_db, args.num_shards)
    missing = [s for s in shards if not os.path.isfile(s)]
    if missing:
        raise SystemExit(f"missing shard files: {missing}")
    n = merge_shard_dbs(shards, args.output_db)
    log(f"merged {len(shards)} shards ({n} rows) → {args.output_db}")
    if args.go_meta_csv:
        if not args.go_meta:
            raise SystemExit("--go-meta is required with --go-meta-csv")
        counts, n_any = read_aggregates(args.output_db)
        save_meta_csv(parse_obo(args.go_meta), args.go_meta_csv,
                      counts=counts, total_records=n_any)
        log(f"wrote merged GO meta CSV → {args.go_meta_csv}")
    return 0


def cmd_create_h5(args) -> int:
    from proteinbert_tpu_torch.etl import create_h5_dataset

    n = create_h5_dataset(
        args.db, args.fasta, args.go_meta_csv, args.output,
        shuffle=not args.no_shuffle,
        min_records_to_keep_annotation=args.min_records,
        records_limit=args.records_limit,
    )
    log(f"created {args.output} with {n} rows")
    return 0


def cmd_data_bench(args) -> int:
    """Measure the HOST side of the input pipeline in isolation — is the
    card going to starve? Times the port's real iterator (tokenization,
    HDF5 block reads, shuffling) with and without the prefetch thread and
    prints one JSON line per variant, the JAX verb's keys."""
    from proteinbert_tpu_torch.configs import get_preset

    cfg = apply_overrides(get_preset(args.preset), args.set or [])

    def make_ds():
        # Fresh dataset per timed variant: sharing one would let the
        # second variant ride the block cache the first just warmed, and
        # the comparison would measure cache reuse instead of prefetch.
        if args.data:
            from proteinbert_tpu_torch.data.dataset import (
                HDF5PretrainingDataset,
            )

            # Same construction as cmd_pretrain (incl. re-crop seed): the
            # probe must time the pipeline training actually runs.
            return HDF5PretrainingDataset(
                args.data, cfg.data.seq_len, crop_seed=cfg.train.seed + 1)
        return _synthetic_dataset(cfg, n_min=8 * cfg.data.batch_size)

    if not args.data:
        log("no --data given: probing on synthetic random proteins")

    n = args.batches
    variants = [("direct", 0)]
    if cfg.data.prefetch_depth > 0:
        variants.append(("prefetch", cfg.data.prefetch_depth))
    else:
        log("data.prefetch_depth=0: prefetch variant skipped")

    def run(prefetch_depth):
        ds = make_ds()
        if len(ds) == 0:
            raise SystemExit("dataset is empty")
        bs = min(cfg.data.batch_size, len(ds))
        if cfg.data.buckets:  # the iterator the `long` preset trains with
            from proteinbert_tpu_torch.data.dataset import (
                make_bucketed_iterator,
            )

            it = make_bucketed_iterator(ds, bs, cfg.data.buckets,
                                        seed=cfg.train.seed)
        else:
            from proteinbert_tpu_torch.data.dataset import (
                make_pretrain_iterator,
            )

            it = make_pretrain_iterator(ds, bs, seed=cfg.train.seed)
        if prefetch_depth:
            from proteinbert_tpu_torch.data.prefetch import prefetch

            it = prefetch(it, prefetch_depth)
        next(it)  # warm caches / start the thread
        t0 = time.perf_counter()
        got = 0
        positions = 0
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                break
            got += 1
            # tokens.size, not rows·seq_len: bucketed batches are sliced
            # to their bucket width and must not be counted at full L.
            positions += batch["tokens"].size
        return got, positions, time.perf_counter() - t0

    for name, depth in variants:
        got, positions, dt = run(depth)
        if not got:
            raise SystemExit("dataset too small for one timed batch")
        print(json.dumps({
            "variant": name,
            "batches_per_sec": round(got / dt, 2),
            "residues_per_sec": round(positions / dt, 1),
            "batch_ms": round(1000 * dt / got, 3),
            "batches": got,
        }))
    return 0


# ---------------------------------------------------------- model commands

def cmd_pretrain(args) -> int:
    """Pretrain; with --multihost, first join the process group (and leave
    it at the end when this call formed it)."""
    import torch.distributed as dist

    from proteinbert_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed, process_index,
    )

    cfg = _build_config(args)
    device = _device(args)
    formed = False
    if getattr(args, "multihost", False):
        formed = not dist.is_initialized()
        try:
            maybe_initialize_distributed(required=True, device=device)
        except RuntimeError as e:
            raise SystemExit(str(e))
    try:
        return _pretrain(args, cfg, device, process_index())
    finally:
        if formed:
            dist.destroy_process_group()


def _pretrain(args, cfg, device, rank: int) -> int:
    from proteinbert_tpu_torch.data.dataset import (
        HDF5PretrainingDataset, make_pretrain_iterator,
    )
    from proteinbert_tpu_torch.parallel.sharding import local_batch_size
    from proteinbert_tpu_torch.train import Checkpointer, pretrain

    mesh = _make_mesh(cfg)
    shard = dict(process_index=0 if mesh is None else mesh.data_index,
                 process_count=1 if mesh is None else mesh.data_extent)
    try:
        rows = local_batch_size(cfg.data.batch_size, shard["process_count"])
    except ValueError as e:
        raise SystemExit(str(e))

    if args.data is not None:
        ds = HDF5PretrainingDataset(
            args.data, cfg.data.seq_len, crop_seed=cfg.train.seed + 1)
        n_ann = ds.num_annotations
        if n_ann != cfg.model.num_annotations:
            log(f"setting model.num_annotations={n_ann} from {args.data}")
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, num_annotations=n_ann))
    else:
        ds = _synthetic_dataset(cfg, n_min=256)
        log("no --data given: pretraining on synthetic random proteins")

    eval_batches = None
    if args.eval_frac:
        from proteinbert_tpu_torch.data.dataset import train_eval_split

        ds, eval_ds = train_eval_split(ds, args.eval_frac,
                                       seed=cfg.train.seed)
        if cfg.train.eval_every == 0:
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, eval_every=max(cfg.checkpoint.every_steps, 100)))
        # A small holdout evals at its own (smaller) batch size; zero rows
        # per data rank is a config error surfaced now, not at step
        # eval_every.
        eval_bs = min(rows, len(eval_ds) // shard["process_count"])
        if eval_bs == 0:
            raise SystemExit(
                f"--eval-frac {args.eval_frac} holds out {len(eval_ds)} "
                f"rows across {shard['process_count']} hosts — not enough "
                "for one eval batch; raise --eval-frac or the dataset size")
        eval_batches = lambda: make_pretrain_iterator(  # noqa: E731
            eval_ds, eval_bs, shuffle=False, num_epochs=1, **shard)
        log(f"held-out eval: {len(eval_ds)} rows (batch {eval_bs}), every "
            f"{cfg.train.eval_every} steps")

    # `tele` is assigned below; the factories read it at CALL time
    # (inside pretrain), so the pad_fraction/dropped-row metrics land in
    # the run's own registry when --events-jsonl telemetry is on.
    reg = lambda: tele.metrics if tele is not None else None  # noqa: E731
    if cfg.data.packing and cfg.data.buckets:
        raise SystemExit("data.packing and data.buckets are mutually "
                         "exclusive — pick one padding strategy")
    if cfg.data.packing:
        from proteinbert_tpu_torch.data.packing import make_packed_iterator

        log(f"segment-aware packing: up to {cfg.data.pack_max_segments} "
            f"proteins per {cfg.data.seq_len}-token row")

        factory = lambda skip: make_packed_iterator(  # noqa: E731
            ds, rows, seed=cfg.train.seed,
            num_epochs=cfg.data.num_epochs, skip_batches=skip,
            max_segments=cfg.data.pack_max_segments,
            max_open=cfg.data.pack_open_bins, metrics=reg(), **shard)
    elif cfg.data.buckets:
        from proteinbert_tpu_torch.data.dataset import make_bucketed_iterator

        log(f"length bucketing: {cfg.data.buckets}")

        factory = lambda skip: make_bucketed_iterator(  # noqa: E731
            ds, rows, cfg.data.buckets, seed=cfg.train.seed,
            num_epochs=cfg.data.num_epochs, skip_batches=skip,
            metrics=reg(), **shard)
    else:
        factory = lambda skip: make_pretrain_iterator(  # noqa: E731
            ds, rows, seed=cfg.train.seed,
            num_epochs=cfg.data.num_epochs, skip_batches=skip, **shard)
    ck = Checkpointer(cfg.checkpoint.directory,
                      max_to_keep=cfg.checkpoint.max_to_keep,
                      async_save=cfg.checkpoint.async_save, mesh=mesh)
    # Only process 0 writes the run's files (every process would write
    # duplicate, possibly torn, lines to a shared file). Downstream
    # --pretrained commands reconstruct the exact run config from
    # config.json, no repeated --pretrained-set flags.
    if rank == 0:
        _save_run_config(cfg, cfg.checkpoint.directory)
    tele = _telemetry(getattr(args, "events_jsonl", None) if rank == 0
                      else None)
    log_fn = None
    mf = None
    if args.metrics_jsonl and rank == 0:
        mf = open(args.metrics_jsonl, "a", buffering=1)

        def log_fn(step, metrics):
            clean = {k: (v if isinstance(v, str) or math.isfinite(v)
                         else None)
                     for k, v in metrics.items()}
            # Wall-clock stamp: a slow window in the stream can be matched
            # offline with checkpoint/eval cadence and outside events.
            mf.write(json.dumps({"step": step, "t": round(time.time(), 2),
                                 **clean}) + "\n")

    run = lambda: pretrain(  # noqa: E731
        cfg, factory, checkpointer=ck, eval_batches=eval_batches,
        log_fn=log_fn, telemetry=tele, device=device, mesh=mesh)
    try:
        if args.profile_dir:
            from proteinbert_tpu_torch.utils.profiling import device_trace

            with device_trace(args.profile_dir):
                out = run()
            log(f"torch profiler trace → {args.profile_dir} "
                "(view in Perfetto or chrome://tracing)")
        else:
            out = run()
    finally:
        # Always await in-flight checkpoint writes — a halt (e.g.
        # NonFiniteLossError) must not abandon a half-written checkpoint.
        ck.close()
        if mf is not None:
            mf.close()
        if tele is not None:
            _export_metrics(tele)
            tele.close()
    perf = out["perf"]
    if perf:
        log(f"done: {perf.get('residues_per_sec_per_chip', 0):.0f} "
            f"residues/s/chip, MFU {perf.get('mfu', 0):.3f}")
    if args.history_json and rank == 0:
        with open(args.history_json, "w") as f:
            json.dump(out["history"], f, indent=2)
    if out.get("preempted"):
        # EX_TEMPFAIL: tells orchestrators "not done — requeue me".
        log("run was preempted; exiting 75 so a supervisor requeues it")
        return 75
    if out.get("early_stopped"):
        # A deliberate, checkpointed stop (eval stalled past
        # train.early_stop_patience) — done, NOT a requeue case.
        log("run early-stopped on a stalled eval; final state is "
            "checkpointed")
    return 0


def cmd_finetune(args) -> int:
    """Fine-tune a task head on a pretrained trunk. --data/--eval-data
    read the TSV format of data/finetune_data.py; without --data,
    synthetic labeled batches (data/synthetic.make_task_batches) serve as
    the smoke path."""
    import numpy as np

    from proteinbert_tpu_torch.configs import (
        FinetuneConfig, TaskConfig, get_preset,
    )
    from proteinbert_tpu_torch.data.finetune_data import (
        batch_task_data, load_task_tsv,
    )
    from proteinbert_tpu_torch.data.synthetic import make_task_batches
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.finetune import finetune

    device = _device(args)
    base = get_preset(args.preset)
    cfg = FinetuneConfig(
        model=base.model,
        data=base.data,
        task=TaskConfig(kind=args.task, num_outputs=args.num_outputs,
                        epochs=args.epochs, freeze_trunk=args.freeze_trunk),
    )
    if args.checkpoint_dir:
        cfg = cfg.replace(checkpoint=dataclasses.replace(
            cfg.checkpoint, directory=args.checkpoint_dir))
    cfg = apply_overrides(cfg, args.set or [])

    trunk = None
    if args.pretrained and (os.path.abspath(args.pretrained)
                            == os.path.abspath(cfg.checkpoint.directory)):
        # Sharing the dir would interleave fine-tune epochs with pretrain
        # steps in one checkpointer and clobber the pretrain run's
        # config.json with a FinetuneConfig.
        raise SystemExit(
            "--checkpoint-dir must differ from --pretrained "
            f"({args.pretrained}): fine-tune epochs get their own run dir")
    if args.pretrained:
        # The pretrain-time state template — from the run dir's
        # config.json when present, else the preset. Only model.* of the
        # fine-tune --set overrides leak in; anything the pretrain run
        # itself customized beyond config.json goes through
        # --pretrained-set.
        pre_cfg = _pretrain_run_config(
            args.pretrained, args.preset,
            [ov for ov in (args.set or []) if ov.startswith("model.")]
            + (args.pretrained_set or []))
        state, step = _load_state(args, pre_cfg)
        trunk = state.params
        log(f"loaded pretrained trunk from {args.pretrained} "
            f"(step {step})")
        # The fine-tune model geometry must BE the trunk's geometry.
        cfg = cfg.replace(model=pre_cfg.model)

    rng = np.random.default_rng(cfg.train.seed)
    if args.data:
        tokens, labels = load_task_tsv(args.data, cfg.task.kind,
                                       cfg.data.seq_len)
        train_batches = lambda epoch: iter(batch_task_data(  # noqa: E731
            tokens, labels, cfg.data.batch_size,
            np.random.default_rng(cfg.train.seed + epoch)))
        n_train = len(tokens) // cfg.data.batch_size
        if args.eval_data:
            ev_tokens, ev_labels = load_task_tsv(
                args.eval_data, cfg.task.kind, cfg.data.seq_len)
            eval_batches = lambda: iter(batch_task_data(  # noqa: E731
                ev_tokens, ev_labels, cfg.data.batch_size))
        else:
            eval_batches = None
    else:
        log("no --data given: fine-tuning on synthetic labeled batches")
        n = max(8 * cfg.data.batch_size, 64)
        train_b = make_task_batches(n, rng, cfg.task.kind,
                                    cfg.task.num_outputs,
                                    cfg.data.seq_len, cfg.data.batch_size)
        eval_b = make_task_batches(n // 4, rng, cfg.task.kind,
                                   cfg.task.num_outputs, cfg.data.seq_len,
                                   cfg.data.batch_size)
        train_batches = lambda epoch: iter(train_b)  # noqa: E731
        eval_batches = lambda: iter(eval_b)  # noqa: E731
        n_train = len(train_b)

    log(f"finetune {cfg.task.kind}: {n_train} train batches/epoch, "
        f"{cfg.task.epochs} epochs → checkpoints in "
        f"{cfg.checkpoint.directory}")
    ck = Checkpointer(cfg.checkpoint.directory,
                      max_to_keep=cfg.checkpoint.max_to_keep,
                      async_save=cfg.checkpoint.async_save)
    # Provenance: the resolved FinetuneConfig beside the epochs.
    _save_run_config(cfg, cfg.checkpoint.directory)
    tele = _telemetry(getattr(args, "events_jsonl", None))
    registry = None
    if args.register_head:
        from proteinbert_tpu_torch.heads import HeadRegistry

        registry = HeadRegistry(args.register_head)
        log(f"will register the trained head into {registry.directory}")
    try:
        out = finetune(cfg, train_batches, eval_batches=eval_batches,
                       pretrained_trunk=trunk, checkpointer=ck,
                       telemetry=tele, registry=registry,
                       register_name=args.head_name, device=device)
    finally:
        ck.close()
        if tele is not None:
            _export_metrics(tele)
            tele.close()
    best = out["best"]
    log(f"best epoch {best['epoch']}: score {best['score']:.4f}")
    if out.get("head_id"):
        log(f"registered head {out['head_id']} "
            f"({cfg.task.kind}) — serve it with: pbt serve --registry "
            f"{args.register_head} --heads {out['head_id']}")
    if args.history_json:
        with open(args.history_json, "w") as f:
            json.dump(out["history"], f, indent=2)
    return 0


def cmd_smoke(args) -> int:
    """Synthetic proteins → tiny config by default → loss must decrease.
    --preset/--data are honored if given (the smoke subparser defaults
    preset to tiny; pretrain defaults it to base)."""
    if args.max_steps is None:
        args.max_steps = 250
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        if args.checkpoint_dir is None:
            args.checkpoint_dir = os.path.join(d, "ck")
        rc = cmd_pretrain(args)
    return rc


def cmd_convert_torch(args) -> int:
    """Reference torch checkpoint → a port run directory the
    --pretrained / resume flags consume (interop.py). The optimizer state
    starts fresh."""
    import torch

    from proteinbert_tpu_torch import interop
    from proteinbert_tpu_torch.configs import get_preset

    device = _device(args)
    cfg = apply_overrides(get_preset(args.preset), args.set or [])
    params, ckpt_step = interop.load_reference_checkpoint(
        args.torch_ckpt, cfg.model,
        generator=torch.Generator().manual_seed(cfg.train.seed),
        device=device)
    step = args.step if args.step is not None else ckpt_step
    _write_run_dir(cfg, params, step, args.output, device)
    log(f"converted {args.torch_ckpt} → {args.output} (step {step})")
    return 0


def cmd_evaluate(args) -> int:
    """Standalone held-out evaluation on any checkpoint + dataset,
    covering EVERY row (smaller tail batch, row-weighted mean). Prints
    one JSON object (loss, local/global terms, accuracy, the GO ranking
    metrics pooled over the split and their per-batch means).
    --like-step corrupts batch i as the training run's eval at that
    history step did (`train.trainer.eval_generator`), on either eval
    bracket: both key the eval by its 1-based boundary step."""
    import numpy as np
    import torch

    from proteinbert_tpu_torch.train.trainer import (
        eval_generator, evaluate_batches,
    )

    cfg = _pretrain_run_config(args.pretrained, args.preset,
                               args.pretrained_set)

    if args.data:
        from proteinbert_tpu_torch.data.dataset import HDF5PretrainingDataset

        ds = HDF5PretrainingDataset(args.data, cfg.data.seq_len)
        n_ann = ds.num_annotations
        if n_ann != cfg.model.num_annotations:
            # A value from --pretrained-set OR the run dir's config.json
            # states what the checkpoint was trained with — "adapting"
            # to the dataset would only move the failure into the
            # restore.
            authoritative = any(
                "num_annotations" in ov for ov in (args.pretrained_set or [])
            ) or os.path.isfile(
                os.path.join(args.pretrained, "config.json"))
            if authoritative:
                raise SystemExit(
                    f"{args.data} has {n_ann} annotation columns but the "
                    f"checkpoint was trained with "
                    f"{cfg.model.num_annotations} — these must match")
            log(f"setting model.num_annotations={n_ann} from {args.data}")
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, num_annotations=n_ann))
    else:
        ds = _synthetic_dataset(cfg, n_min=128)
        log("no --data given: evaluating on synthetic random proteins")

    if len(ds) == 0:
        raise SystemExit("dataset is empty")

    state, step = _load_state(args, cfg)
    log(f"loaded checkpoint from {args.pretrained} (step {step})")
    device = _device(args)

    bs = min(cfg.data.batch_size, len(ds))

    def batches():  # ordered, exact coverage; the tail batch is smaller
        for start in range(0, len(ds), bs):
            yield ds.get_batch(np.arange(start, min(start + bs, len(ds))))

    if args.like_step is not None:
        generator_for = lambda i: eval_generator(  # noqa: E731
            cfg, args.like_step, i, device)
    else:
        generator_for = lambda i: torch.Generator(  # noqa: E731
            device=device).manual_seed(args.seed * 1_000_003 + i)
    metrics, n, rows = evaluate_batches(state, batches(), cfg,
                                        generator_for, args.max_batches)
    # Valid JSON even for degenerate inputs: non-finite → null.
    result = {"step": step, "batches": n, "rows": rows,
              **{k: (round(v, 6) if math.isfinite(v) else None)
                 for k, v in metrics.items()}}
    print(json.dumps(result))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
    return 0


def cmd_eval_heads(args) -> int:
    """Score registered task heads against the resident trunk —
    per-residue accuracy / accuracy + AUC proxy / Spearman by task kind
    (heads/eval.py) — emitting one `head_eval` event per head. One JSON
    line per head on stdout."""
    import numpy as np

    from proteinbert_tpu_torch.heads import (
        HeadRegistry, HeadRegistryError, trunk_fingerprint,
    )
    from proteinbert_tpu_torch.heads.eval import evaluate_heads

    params, cfg = _load_inference_trunk(args)
    registry = HeadRegistry(args.registry)
    fp = None if args.no_trunk_check else trunk_fingerprint(params)
    if args.heads and args.heads != "all":
        # Explicit ids are strict (clean exit on mismatch/corruption);
        # implicit "all" skips unservable artifacts with a warning.
        try:
            heads = [registry.load(h, trunk_fp=fp)
                     for h in args.heads.split(",") if h]
        except HeadRegistryError as e:
            raise SystemExit(f"--heads: {e}")
    else:
        heads = []
        for m in registry.list_heads():
            try:
                heads.append(registry.load(m["head_id"], trunk_fp=fp))
            except HeadRegistryError as e:
                log(f"skipping head {m['head_id']} ({m.get('name')}): {e}")
    if not heads:
        raise SystemExit(
            f"no evaluable heads in {registry.directory}")

    if args.data:
        from proteinbert_tpu_torch.data.finetune_data import (
            batch_task_data, load_task_tsv,
        )

        kinds = sorted({h.task.kind for h in heads})
        if len(kinds) > 1:
            raise SystemExit(
                f"--data is a single-task TSV but the selected heads "
                f"span {kinds}; select heads of one kind")
        tokens, labels = load_task_tsv(args.data, kinds[0],
                                       cfg.data.seq_len)
        bs = min(args.batch_size, len(tokens))
        batches_for = lambda head: batch_task_data(  # noqa: E731
            tokens, labels, bs)
    else:
        log("no --data given: evaluating on synthetic labeled batches")
        from proteinbert_tpu_torch.data.synthetic import make_task_batches

        batches_for = lambda head: make_task_batches(  # noqa: E731
            max(4 * args.batch_size, 32),
            np.random.default_rng(args.seed), head.task.kind,
            head.task.num_outputs, cfg.data.seq_len, args.batch_size)

    tele = _telemetry(args.events_jsonl)
    try:
        results = evaluate_heads(params, cfg.model, heads, batches_for,
                                 telemetry=tele)
    finally:
        if tele is not None:
            tele.close()
    for hid, m in results.items():
        print(json.dumps({"head_id": hid, **m}))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return 0


def cmd_diagnose(args) -> int:
    """Summarize a telemetry events JSONL (+ optional flight-recorder
    dump): step-rate trend, stall top-list, boundary overlap ratio, the
    last events before death, and the serve/map/fleet sections. Reads
    either package's streams (one schema); makes no tensors."""
    from proteinbert_tpu_torch.obs import read_events, validate_flight_dump
    from proteinbert_tpu_torch.obs.diagnose import (
        render, render_fleet, render_map, render_serve, summarize,
        summarize_fleet, summarize_map, summarize_serve,
    )

    records = read_events(args.events)
    if not records:
        raise SystemExit(f"no valid event records in {args.events}")
    flight = None
    if args.flight:
        with open(args.flight) as f:
            flight = json.load(f)
        try:
            validate_flight_dump(flight)
        except ValueError as e:
            raise SystemExit(f"{args.flight} is not a valid flight dump: {e}")
    # The serve/map/fleet sections render when asked for or when the
    # stream carries their records (a mixed stream shows all).
    has_serve = any(r["event"].startswith("serve_") for r in records)
    if args.serve and not has_serve:
        raise SystemExit(f"--serve: no serve_* records in {args.events}")
    has_map = any(r["event"].startswith("map_") for r in records)
    if args.map and not has_map:
        raise SystemExit(f"--map: no map_* records in {args.events}")
    has_fleet = any(r["event"].startswith("fleet_") for r in records)
    if args.fleet and not has_fleet:
        raise SystemExit(f"--fleet: no fleet_* records in {args.events}")
    if args.trace_id and not args.fleet:
        raise SystemExit("--trace-id requires --fleet (it selects one "
                         "causal chain from the merged fleet stream)")
    serve_summary = (summarize_serve(records, slow_top=args.slow_top)
                     if has_serve else None)
    map_summary = summarize_map(records) if has_map else None
    fleet_summary = (summarize_fleet(records, trace_id=args.trace_id,
                                     slow_top=args.slow_top)
                     if has_fleet else None)
    if args.trace_perfetto:
        # Cross-process lanes (router + one per replica attempt) from the
        # merged stream.
        from proteinbert_tpu_torch.obs.diagnose import export_fleet_spans
        from proteinbert_tpu_torch.obs.tracing import SpanCollector

        if not has_fleet:
            raise SystemExit(f"--trace-perfetto: no fleet_* records in "
                             f"{args.events}")
        collector = SpanCollector()
        n = export_fleet_spans(records, collector,
                               trace_id=args.trace_id)
        collector.dump(args.trace_perfetto)
        print(f"wrote {n} fleet trace lane group(s) to "
              f"{args.trace_perfetto}")
    summary = summarize(records, flight=flight,
                        slow_top=args.slow_top, last=args.last)
    if serve_summary is not None:
        summary["serve"] = serve_summary
    if map_summary is not None:
        summary["map"] = map_summary
    if fleet_summary is not None:
        summary["fleet"] = fleet_summary
    if args.json:
        print(json.dumps(summary))
    elif args.fleet:
        print(render_fleet(fleet_summary))
    elif args.serve:
        print(render_serve(serve_summary))
    elif args.map:
        print(render_map(map_summary))
    else:
        print(render(summary))
        if serve_summary is not None:
            print(render_serve(serve_summary))
        if fleet_summary is not None:
            print(render_fleet(fleet_summary))
        if map_summary is not None:
            print(render_map(map_summary))
    return 0


def cmd_export_weights(args) -> int:
    """Trained params → flat NPZ (`weights.params_to_flat`): slash-joined
    paths, per-block entries, fp32 — the format the JAX package's
    import-weights reads."""
    import numpy as np

    from proteinbert_tpu_torch.weights import params_to_flat

    params, cfg = _load_inference_trunk(args)
    flat = params_to_flat(params)
    np.savez(args.output, **flat)
    log(f"wrote {len(flat)} arrays → {args.output}")
    return 0


def cmd_import_weights(args) -> int:
    """Flat NPZ (export-weights of either package, or any numpy-speaking
    tool) → a port run directory the --pretrained / resume flags consume.
    Optimizer state starts fresh, like convert-torch."""
    import numpy as np

    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.weights import (
        check_block_layout, expected_shapes, params_from_flat,
    )

    device = _device(args)
    cfg = apply_overrides(get_preset(args.preset), args.set or [])
    with np.load(args.weights) as z:
        flat = {k: z[k] for k in z.files}
    try:
        check_block_layout(flat)
    except ValueError as e:
        raise SystemExit(
            f"{args.weights} is not a well-formed export-weights NPZ: {e}")
    want = expected_shapes(cfg.model)
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if want != got or any(v.dtype != np.float32 for v in flat.values()):
        raise SystemExit(
            f"{args.weights} does not match the configured model geometry "
            "(run with the same --preset/--set the weights were trained "
            "with)")
    params = params_from_flat(flat, cfg.model, device)
    _write_run_dir(cfg, params, args.step, args.output, device)
    log(f"imported {args.weights} → {args.output} (step {args.step})")
    return 0


def cmd_embed(args) -> int:
    """Write trunk representations for downstream models."""
    import numpy as np

    from proteinbert_tpu_torch import inference

    params, cfg = _load_inference_trunk(args)
    device = _device(args)
    ids, seqs = _read_named_seqs(args)
    if args.output.endswith(".npz"):
        # NPZ cannot be appended to — in-memory path (fine for small N).
        out = inference.embed(params, cfg, seqs, batch_size=args.batch_size,
                              per_residue=args.per_residue, device=device)
        np.savez(args.output, ids=np.array(ids), **out)
    else:
        # HDF5 streams batch-by-batch: host memory stays O(batch) no
        # matter how many sequences the FASTA holds.
        import h5py

        with h5py.File(args.output, "w") as h5f:
            h5f.create_dataset("ids", data=[i.encode() for i in ids],
                               dtype=h5py.string_dtype())
            dsets = {}
            n = 0
            for out in inference.embed_batches(
                params, cfg, seqs, batch_size=args.batch_size,
                per_residue=args.per_residue, device=device,
            ):
                rows = len(next(iter(out.values())))
                for k, v in out.items():
                    if k not in dsets:
                        dsets[k] = h5f.create_dataset(
                            k, shape=(0,) + v.shape[1:],
                            maxshape=(None,) + v.shape[1:], dtype=v.dtype,
                            chunks=(max(args.batch_size, 1),) + v.shape[1:])
                    dsets[k].resize(n + rows, axis=0)
                    dsets[k][n : n + rows] = v
                n += rows
    log(f"embedded {len(seqs)} sequences → {args.output}")
    return 0


def cmd_predict_go(args) -> int:
    """Predict GO annotations from sequence alone (TSV to --output or
    stdout: id, annotation column index, GO id if known, name if known,
    probability)."""
    from proteinbert_tpu_torch import inference

    params, cfg = _load_inference_trunk(args)
    device = _device(args)
    ids, seqs = _read_named_seqs(args)

    go_ids = None
    if args.data:  # annotation column → GO id, from the training dataset
        import h5py

        with h5py.File(args.data, "r") as h5f:
            go_ids = [g.decode() if isinstance(g, bytes) else g
                      for g in h5f["included_annotations"][:]]
    names = {}
    if args.go_meta_csv:
        from proteinbert_tpu_torch.etl.go_ontology import load_meta_csv

        names = {r["id"]: r["name"] for r in load_meta_csv(args.go_meta_csv)}

    top = inference.predict_go(params, cfg, seqs, batch_size=args.batch_size,
                               top_k=args.top_k, device=device)
    sink = open(args.output, "w") if args.output else sys.stdout
    try:
        for name, row in zip(ids, top):
            for col, prob in row:
                gid = go_ids[col] if go_ids and col < len(go_ids) else ""
                sink.write(f"{name}\t{col}\t{gid}\t{names.get(gid, '')}\t"
                           f"{prob:.4f}\n")
    finally:
        if sink is not sys.stdout:
            sink.close()
    return 0


def cmd_predict_residues(args) -> int:
    """Fill '?'-masked residues (the denoising task run as inference)."""
    from proteinbert_tpu_torch import inference

    params, cfg = _load_inference_trunk(args)
    device = _device(args)
    ids, seqs = _read_named_seqs(args)
    filled, _ = inference.predict_residues(params, cfg, seqs,
                                           batch_size=args.batch_size,
                                           device=device)
    sink = open(args.output, "w") if args.output else sys.stdout
    try:
        for name, seq in zip(ids, filled):
            sink.write(f"{name}\t{seq}\n")
    finally:
        if sink is not sys.stdout:
            sink.close()
    return 0


def cmd_serve(args) -> int:
    """Online inference server: `serve/server.Server` behind the stdlib
    HTTP JSON endpoint (`serve/http.py`). Continuous micro-batching over
    the run's length buckets (cfg.data.buckets, else one full-length
    bucket), each served shape a CUDA graph on the card; bounded queue
    with typed rejections, LRU result cache, graceful drain on SIGTERM/
    SIGINT (in-flight batches finish; new work gets 503)."""
    import threading
    import time as _time

    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.heads import TrunkMismatchError
    from proteinbert_tpu_torch.serve.http import make_http_server
    from proteinbert_tpu_torch.serve.server import Server
    from proteinbert_tpu_torch.train.resilience import GracefulShutdown

    cfg = _pretrain_run_config(args.pretrained, args.preset,
                               args.pretrained_set)
    device = _device(args)
    mesh = None
    if args.mesh:
        from proteinbert_tpu_torch.parallel.mesh import serve_mesh

        try:
            # The visible cards, or on the CPU the CPU as one device.
            mesh = serve_mesh(cfg.mesh, devices=(
                [device] if device.type == "cpu" else None))
        except ValueError as e:
            raise SystemExit(str(e))
        log(f"serving with batch-dim sharding over {dict(mesh.shape)} "
            f"({mesh.size} devices)")
    state, step = _load_state(args, cfg)
    log(f"loaded trunk from {args.pretrained} (step {step})")
    params = state.params

    def _candidate_loader(source: str):
        """Rollout candidate arm: a second trunk from another run
        directory under the SAME model config — the flip swaps weights,
        never served shapes."""
        _check_run_dir(source)
        cand, step = inference.load_trunk(source, cfg, device)
        log(f"rollout candidate trunk loaded from {source} (step {step})")
        return cand

    # The effective quant arm (flag > run config) up front, so an
    # impossible combination is a clean operator-facing exit.
    effective_quant = args.quant or getattr(
        getattr(cfg, "serve", None), "quant", "fp32")
    if args.serve_mode == "ragged" and effective_quant == "int8_act":
        raise SystemExit(
            "--quant int8_act is a bucketed-mode option: the packed "
            "executables have no activation fake-quant variant — use "
            "--quant int8 for weight-only quantized ragged serving")

    tele = None
    if args.events_jsonl or args.trace_perfetto or args.slo:
        from proteinbert_tpu_torch.obs import Telemetry

        # spans=True arms the host SpanCollector the request traces
        # replay into; --events-jsonl may be absent.
        tele = Telemetry(events_path=args.events_jsonl,
                         spans=bool(args.trace_perfetto))
        tele.flight.install_excepthook()

    slos = []
    if args.slo:
        from proteinbert_tpu_torch.obs.slo import parse_slos

        slos = parse_slos(args.slo)
        log("slo objectives: " + ", ".join(
            f"{o.name} ({o.kind}, target {o.target:g}, "
            f"window {o.window_s:g}s)" for o in slos))

    registry = None
    head_ids = []
    if args.registry:
        from proteinbert_tpu_torch.heads import (
            HeadRegistry, HeadRegistryError, trunk_fingerprint,
        )

        registry = HeadRegistry(args.registry)
        fp = trunk_fingerprint(params)
        if args.heads and args.heads != "all":
            # Explicitly named heads are STRICT: a mismatch/corruption is
            # a config error the operator must see.
            try:
                head_ids = [h for h in args.heads.split(",") if h]
                for h in head_ids:
                    registry.load(h, trunk_fp=fp)
            except HeadRegistryError as e:
                raise SystemExit(f"--heads: {e}")
        else:
            # Implicit "all" serves every trunk-compatible head and skips
            # the rest with a warning.
            for m in registry.list_heads():
                try:
                    registry.load(m["head_id"], trunk_fp=fp)
                except (TrunkMismatchError, HeadRegistryError) as e:
                    log(f"skipping head {m['head_id']} "
                        f"({m.get('name')}): {e}")
                    continue
                head_ids.append(m["head_id"])
        if not head_ids:
            log(f"registry {registry.directory} holds no servable heads "
                "yet; add them live via POST /v1/heads/add")
    elif args.heads:
        raise SystemExit("--heads requires --registry")

    index = None
    if args.index:
        from proteinbert_tpu_torch.index.scorer import NeighborIndex
        from proteinbert_tpu_torch.mapper import StoreError

        try:
            index = NeighborIndex.load(args.index, device=device)
        except StoreError as e:
            raise SystemExit(f"--index: {e}")
        log(f"neighbor index: {index.num_vectors} vector(s), "
            f"{index.centroids.shape[0]} centroid(s), dim {index.dim}, "
            f"identity {index.digest[:16]}… (nprobe {args.nprobe}) — "
            "serving /v1/neighbors")
    elif args.nprobe != 8:
        raise SystemExit("--nprobe requires --index")

    try:
        server = Server(
            params, cfg,
            device=device,
            max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms / 1000.0,
            queue_depth=args.queue_depth,
            cache_size=args.cache_size,
            default_deadline_s=(args.deadline_ms / 1000.0
                                if args.deadline_ms is not None else None),
            on_long=args.on_long,
            telemetry=tele,
            trace_sample_rate=args.trace_sample_rate,
            slos=slos,
            slo_profile_dir=args.slo_profile_dir,
            registry=registry,
            heads=head_ids,
            serve_mode=args.serve_mode,
            pack_max_segments=args.pack_max_segments,
            quant=args.quant,
            quant_parity_every=args.quant_parity_every,
            pipeline_depth=args.pipeline_depth,
            index=index,
            nprobe=args.nprobe,
            replica_id=args.replica_id,
            candidate_loader=_candidate_loader,
            mesh=mesh,
        )
    except TrunkMismatchError as e:
        # The index pins the trunk its embeddings came from.
        raise SystemExit(f"--index: {e}")
    if server.quant != "fp32":
        qr = server.dispatcher.quant_report
        log(f"quantized arm: {server.quant} — trunk weights "
            f"{qr['weight_bytes_quant']} bytes vs "
            f"{qr['weight_bytes_fp32']} fp32 "
            f"({qr['weight_bytes_ratio']:.2f}x)"
            + (f", fp32 parity shadow every "
               f"{server.dispatcher.quant_parity_every} batch(es)"
               if server.dispatcher.quant_parity_every else ""))
    if head_ids:
        log(f"serving {len(head_ids)} registered head(s) over the "
            f"shared trunk: {', '.join(head_ids)}")
    if args.serve_mode == "ragged":
        log(f"ragged packed serving: one ({args.max_batch}, "
            f"{cfg.data.seq_len}) shape per request kind; spans "
            f"quantized to buckets={list(server.dispatcher.buckets)}, "
            f"up to {args.pack_max_segments} requests per row")
    else:
        log(f"warming {len(server.dispatcher.buckets)} bucket(s) x "
            f"{len(server.dispatcher.batch_classes)} batch class(es): "
            f"buckets={list(server.dispatcher.buckets)}")
    server.start()
    log(f"warmup: {server.dispatcher.warmup_seconds_total:.2f}s over "
        f"{server.dispatcher.executable_count} warm shape(s)")
    httpd = make_http_server(server, args.host, args.port)
    port = httpd.server_address[1]
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(port))
    log(f"serving on http://{args.host}:{port} "
        f"(max_batch={args.max_batch}, max_wait={args.max_wait_ms}ms, "
        f"queue_depth={args.queue_depth})")
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    try:
        with GracefulShutdown() as stop:
            http_thread.start()
            while not stop.requested:
                _time.sleep(0.05)
                if args.max_requests and (
                        server.completed_total + server.cache_hit_returns
                        + sum(server.rejected_total.values())
                        >= args.max_requests):
                    log(f"--max-requests {args.max_requests} reached")
                    break
    finally:
        # Graceful drain: stop accepting HTTP, finish queued/in-flight
        # batches, then emit serve_end + export metrics.
        httpd.shutdown()
        httpd.server_close()
        server.drain(timeout=60)
        if tele is not None:
            if args.trace_perfetto and tele.spans is not None:
                try:
                    tele.spans.dump(args.trace_perfetto)
                    log(f"wrote {len(tele.spans)} request-trace spans "
                        f"to {args.trace_perfetto} (load in "
                        "ui.perfetto.dev)")
                except OSError as e:
                    log(f"could not write trace dump: {e}")
            _export_metrics(tele)
            tele.close()
    stats = server.stats()
    log(f"served {stats['completed']} requests "
        f"({stats['cache_hit_returns']} cache hits, "
        f"{sum(stats['rejected'].values())} rejected); "
        f"p50 {stats['latency']['p50_s']}s p99 {stats['latency']['p99_s']}s")
    for name, st in (stats.get("slo") or {}).items():
        log(f"slo {name}: burn {st['burn_rate']:g} "
            f"({st['bad']}/{st['total']} bad in window"
            + (f", {st['breaches_total']} breach(es)"
               if st["breaches_total"] else "") + ")")
    return 0


def cmd_map(args) -> int:
    """Resumable sharded batch inference: stream a corpus through the
    ragged packed trunk into a content-addressed, integrity-verified
    embedding store (mapper/). Every shard has a crash-safe cursor
    advanced only after its block is durably on disk, so a SIGKILL
    resumes with at most one block of re-work per shard. `--verify`
    recomputes every block digest and reports corruption/holes — it
    needs only the store, no model."""
    from proteinbert_tpu_torch.mapper import (
        StoreConfigError, StoreError, verify_store,
    )

    if args.verify:
        try:
            report = verify_store(args.store)
        except StoreConfigError as e:
            raise SystemExit(f"--verify: {e}")
        print(json.dumps(report))
        if not report["ok"]:
            problems = []
            for rec in report["corrupt"]:
                problems.append(
                    f"corrupt block shard {rec['shard']} block "
                    f"{rec['block']} ({rec['reason']}, "
                    f"{rec['digest'][:16]}…)")
            for rec in report["holes"]:
                problems.append(
                    f"hole: shard {rec['shard']} block {rec['block']} "
                    f"object {rec['digest'][:16]}… is missing")
            problems.extend(report["coverage_errors"])
            log("store FAILED verification: " + "; ".join(problems))
            return 1
        log(f"store OK: {report['blocks_checked']} block(s) verified, "
            f"{report['embedded']} embedded, "
            f"{report['quarantined']} quarantined"
            + ("" if report["complete"] else " (mapping incomplete)"))
        return 0

    if not args.pretrained:
        raise SystemExit("pbt map needs --pretrained (or --verify to "
                         "audit an existing store)")
    from proteinbert_tpu_torch.mapper.engine import run_map

    params, cfg = _load_inference_trunk(args)
    device = _device(args)
    ids, seqs = _read_named_seqs(args)
    buckets = None
    if args.buckets:
        try:
            buckets = tuple(json.loads(args.buckets))
        except (ValueError, TypeError):
            raise SystemExit(f"--buckets expects a JSON list, got "
                             f"{args.buckets!r}")
    tele = _telemetry(args.events_jsonl)
    log(f"mapping {len(seqs)} sequence(s) over {args.num_shards} "
        f"shard(s) (block {args.block_size}, {args.rows_per_batch} "
        f"packed rows x {cfg.data.seq_len}, up to {args.max_segments} "
        f"seqs/row) → {args.store}")
    try:
        out = run_map(
            params, cfg, ids, seqs, args.store,
            num_shards=args.num_shards, block_size=args.block_size,
            rows_per_batch=args.rows_per_batch,
            max_segments=args.max_segments, buckets=buckets,
            telemetry=tele, max_blocks=args.max_blocks,
            pipeline=not args.no_pipeline, device=device)
    except (StoreError, ValueError) as e:
        raise SystemExit(f"map failed: {e}")
    finally:
        if tele is not None:
            _export_metrics(tele)
            tele.close()
    log(f"map {out['outcome']}: {out['blocks']} block(s), "
        f"{out['seqs']} sequence(s) at {out['seqs_per_s']:.1f} seqs/s, "
        f"{out['quarantined']} quarantined, {out['retries']} "
        f"retry(ies), {out['rework']} re-worked block(s)")
    if out["outcome"] == "preempted":
        # EX_TEMPFAIL, same contract as pretrain: not done — requeue.
        log("mapping preempted; exiting 75 so a supervisor requeues it")
        return 75
    if out["outcome"] in ("halted", "error"):
        log(f"mapping {out['outcome']}: halted_shards="
            f"{out['halted_shards']} failed_shards="
            f"{out['failed_shards']}")
        return 1
    return 0


def cmd_index(args) -> int:
    """Neighbor-index construction: coarse k-means centroids + per-block
    int8-quantized vectors over a COMPLETED embedding store, built
    shard-by-shard through the mapper's crash-safe cursor protocol.
    `--verify` audits an existing index (digests, geometry, coverage) and
    needs only the index directory."""
    from proteinbert_tpu_torch.index import build_index, verify_index
    from proteinbert_tpu_torch.mapper import StoreConfigError, StoreError

    if args.verify:
        try:
            report = verify_index(args.index)
        except StoreConfigError as e:
            raise SystemExit(f"--verify: {e}")
        print(json.dumps(report))
        if not report["ok"]:
            problems = []
            for rec in report["corrupt"]:
                where = (f"shard {rec['shard']} block {rec['block']}"
                         if "shard" in rec else rec.get("kind", "?"))
                problems.append(f"corrupt {where} ({rec['reason']}, "
                                f"{str(rec['digest'])[:16]}…)")
            for rec in report["holes"]:
                where = (f"shard {rec['shard']} block {rec['block']}"
                         if "shard" in rec else rec.get("kind", "?"))
                problems.append(f"hole: {where} object "
                                f"{str(rec['digest'])[:16]}… is missing")
            problems.extend(report["coverage_errors"])
            log("index FAILED verification: " + "; ".join(problems))
            return 1
        log(f"index OK: {report['blocks_checked']} block(s) verified, "
            f"{report['vectors']} vector(s)"
            + ("" if report["complete"] else " (build incomplete)"))
        return 0

    if not args.store:
        raise SystemExit("pbt index needs --store (or --verify to "
                         "audit an existing index)")
    from proteinbert_tpu_torch.train.resilience import GracefulShutdown

    tele = _telemetry(args.events_jsonl)
    try:
        with GracefulShutdown() as stop:
            stats = build_index(
                args.store, args.index,
                num_centroids=args.centroids,
                block_size=args.block_size,
                seed=args.seed, kmeans_iters=args.kmeans_iters,
                sample_cap=args.sample_cap, max_blocks=args.max_blocks,
                stop_flag=lambda: stop.requested, telemetry=tele)
    except (StoreError, ValueError) as e:
        raise SystemExit(f"index build failed: {e}")
    finally:
        if tele is not None:
            _export_metrics(tele)
            tele.close()
    if args.json:
        print(json.dumps(stats))
    log(f"index {stats['outcome']}: {stats['vectors']} vector(s) in "
        f"{stats['blocks']} block(s) over {stats['shards']} shard(s), "
        f"{stats['reworked_blocks']} re-worked; int8 index is "
        f"{stats['bytes_ratio']:.3f}x the fp32 vector bytes")
    if stats["outcome"] == "preempted":
        # EX_TEMPFAIL, same contract as map/pretrain.
        log("index build preempted; exiting 75 so a supervisor "
            "requeues it")
        return 75
    return 0


def cmd_reshard(args) -> int:
    """Carry a run directory's checkpoint to a NEW mesh layout: a fresh run
    directory whose config.json records the new topology (and ZeRO
    choice), the step byte-checked after its write, the move's wire bytes
    priced from the rules (parallel/reshard.py) on the `reshard`
    event."""
    from proteinbert_tpu_torch.parallel.reshard import (
        parse_mesh_spec, reshard_checkpoint,
    )

    cfg = _pretrain_run_config(args.src, args.preset, args.pretrained_set)
    target = None
    if args.target_mesh:
        try:
            target = parse_mesh_spec(args.target_mesh)
        except ValueError as e:
            raise SystemExit(f"--target-mesh: {e}")
    _check_run_dir(args.src)
    tele = None
    if args.events_jsonl:
        from proteinbert_tpu_torch.obs import Telemetry

        tele = Telemetry(events_path=args.events_jsonl)
    try:
        summary = reshard_checkpoint(
            args.src, args.output, cfg=cfg, target_mesh_cfg=target,
            zero_update=args.zero_update, step=args.step,
            telemetry=tele, verify=not args.no_verify)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        raise SystemExit(f"reshard failed: {e}")
    finally:
        if tele is not None:
            _export_metrics(tele)
            tele.close()
    print(json.dumps(summary))
    log(f"resharded {args.src} step {summary['step']} → {args.output} "
        f"(mesh {summary['target_mesh']}, {summary['schedule']} "
        f"schedule, {summary['wire_bytes'].get('total', 0)} wire bytes"
        + (", parity verified" if summary["parity"] else "") + ")")
    return 0


def cmd_check(args) -> int:
    """Project-invariant static analyzer over the port: six stdlib-ast
    rules derived from its own contracts — graph purity and launch or
    raise, lock discipline, durability protocol, event-schema call sites,
    obs-doc drift, dead exports — with a checked-in suppression baseline.
    Exit 0 = clean, 1 = findings, 2 = config error (the JAX verb's)."""
    from proteinbert_tpu_torch.analysis.runner import main as check_main

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    argv = []
    if args.json:
        argv.append("--json")
    if args.json_artifact:
        argv.extend(["--json-artifact", args.json_artifact])
    for rule in args.rule or ():
        argv.extend(["--rule", rule])
    if args.events_jsonl:
        argv.extend(["--events-jsonl", args.events_jsonl])
    if args.baseline:
        argv.extend(["--baseline", args.baseline])
    if args.root:
        argv.extend(["--root", args.root])
    if args.write_baseline:
        argv.append("--write-baseline")
    return check_main(argv, repo_root=repo_root)


def cmd_fleet(args) -> int:
    """Fault-tolerant serve fleet: N `serve` replica subprocesses (each
    `python -m proteinbert_tpu_torch --device <d> serve ...`) behind the
    FleetRouter (serve/fleet.py) — health-checked via /healthz + SLO
    burn, idempotent retry with capped backoff and a retry budget, typed
    load shedding, drain/re-admit via POST /fleet/{drain,admit}, and a
    shared content-addressed result cache."""
    import signal
    import subprocess
    import tempfile
    import threading
    import time as _time

    from proteinbert_tpu_torch.serve.fleet import (
        FleetCollector, FleetRouter, make_fleet_http_server,
    )
    from proteinbert_tpu_torch.train.resilience import GracefulShutdown

    _device(args)  # the replicas need the card too: fail here, not in N logs
    workdir = tempfile.mkdtemp(prefix="pbt_fleet_")
    base = [sys.executable, "-m", "proteinbert_tpu_torch",
            "--device", args.device,
            "serve", "--pretrained", args.pretrained,
            "--preset", args.preset, "--host", "127.0.0.1", "--port", "0",
            "--serve-mode", args.serve_mode,
            "--max-batch", str(args.max_batch),
            "--max-wait-ms", str(args.max_wait_ms),
            "--queue-depth", str(args.queue_depth),
            "--cache-size", str(args.cache_size),
            "--on-long", args.on_long]
    for ov in args.pretrained_set or []:
        base += ["--pretrained-set", ov]
    for spec in args.slo or []:
        base += ["--slo", spec]
    if args.deadline_ms is not None:
        base += ["--deadline-ms", str(args.deadline_ms)]

    tele = _telemetry(args.events_jsonl)

    procs = []
    logs = []
    port_files = []

    def _shutdown_replicas():
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)  # replica-side drain
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
        for lf in logs:
            lf.close()

    # procs/logs grow incrementally, so _shutdown_replicas cleans up a
    # PARTIAL spawn too.
    try:
        for i in range(args.replicas):
            pf = os.path.join(workdir, f"replica{i}.port")
            lf = open(os.path.join(workdir, f"replica{i}.log"), "ab")
            logs.append(lf)
            # Explicit fleet identity: every replica stamps its serve_*
            # events with this name, so the merged stream joins on it.
            cmd = list(base) + ["--port-file", pf,
                                "--replica-id", f"r{i}"]
            if args.events_jsonl:
                cmd += ["--events-jsonl",
                        os.path.join(workdir, f"replica{i}.events.jsonl")]
            procs.append(subprocess.Popen(cmd, stdout=lf, stderr=lf))
            port_files.append(pf)
    except BaseException:
        _shutdown_replicas()
        raise
    log(f"spawned {args.replicas} replica(s); logs in {workdir}")

    urls = []
    deadline = _time.monotonic() + args.boot_timeout_s
    try:
        for i, pf in enumerate(port_files):
            while not os.path.exists(pf) or not open(pf).read().strip():
                if procs[i].poll() is not None:
                    raise SystemExit(
                        f"replica {i} died during boot; see "
                        f"{workdir}/replica{i}.log")
                if _time.monotonic() > deadline:
                    raise SystemExit(
                        f"replica {i} did not boot within "
                        f"{args.boot_timeout_s}s; see {workdir}")
                _time.sleep(0.2)
            urls.append((f"r{i}",
                         f"http://127.0.0.1:{open(pf).read().strip()}"))
    except BaseException:
        _shutdown_replicas()
        raise

    # A SIGKILLed replica's flight-recorder ring dumps into its telemetry
    # dir (= the tmp workdir): tell the router where each will land, and
    # collect the dumps before the tmpdir vanishes.
    flight_paths = {}
    if args.events_jsonl:
        from proteinbert_tpu_torch.obs import flight_path

        flight_paths = {f"r{i}": flight_path(workdir, procs[i].pid)
                        for i in range(len(procs))}

    def _collect_flight_dumps():
        """Copy any replica flight dumps beside --events-jsonl."""
        import shutil

        saved = []
        dest_dir = os.path.dirname(os.path.abspath(args.events_jsonl))
        for name, src in sorted(flight_paths.items()):
            if os.path.exists(src):
                dst = os.path.join(dest_dir,
                                   f"fleet_{name}_flight.json")
                try:
                    shutil.copyfile(src, dst)
                    saved.append(dst)
                except OSError as e:
                    log(f"could not save {name} flight dump: {e}")
        return saved

    try:
        router = FleetRouter(
            urls, telemetry=tele,
            health_interval_s=args.health_interval_ms / 1000.0,
            max_retries=args.max_retries,
            retry_budget_ratio=args.retry_budget_ratio,
            cache_size=args.fleet_cache_size,
            flight_paths=flight_paths,
        ).start()
        if args.events_jsonl:
            # Router + replica streams merge post-hoc into one
            # seq-ordered file `diagnose --fleet` reads.
            collector = FleetCollector({"router": args.events_jsonl})
            for i in range(len(procs)):
                collector.add_source(
                    f"r{i}",
                    os.path.join(workdir, f"replica{i}.events.jsonl"))
            router.attach_collector(collector)
        # Bind can fail (EADDRINUSE on the fixed default port) — the
        # replicas must not be orphaned by a router that never served.
        httpd = make_fleet_http_server(router, args.host, args.port)
    except BaseException:
        _shutdown_replicas()
        raise
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    try:
        port = httpd.server_address[1]
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(port))
        log(f"fleet router on http://{args.host}:{port} over "
            f"{len(urls)} replica(s): "
            + ", ".join(f"{n}={u}" for n, u in urls))
        with GracefulShutdown() as stop:
            http_thread.start()
            while not stop.requested:
                _time.sleep(0.05)
                if any(p.poll() is not None for p in procs) \
                        and args.exit_on_replica_death:
                    log("a replica process exited; shutting the fleet "
                        "down (--exit-on-replica-death)")
                    break
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.drain()
        _shutdown_replicas()
        if tele is not None:
            _export_metrics(tele)
            tele.close()
            for p in _collect_flight_dumps():
                log(f"saved replica flight dump: {p}")
            if router.collector is not None:
                # Merge AFTER every writer is closed.
                merged = args.events_jsonl + ".merged.jsonl"
                try:
                    n = router.collector.write(merged)
                    log(f"merged fleet stream: {n} event(s) → {merged}")
                except OSError as e:
                    log(f"could not write merged fleet stream: {e}")
    stats = router.stats()
    log(f"fleet drained: {stats['accepted']} accepted, "
        f"{stats['sealed']} sealed, outcomes {stats['outcomes']}, "
        f"{stats['retries_spent']} retries")
    return 0 if stats["accepted"] == stats["sealed"] else 1


def cmd_rollout(args) -> int:
    """Blue-green rollout control plane: drive a running fleet router's
    /rollout/* verbs — start shadowing a candidate trunk, watch the gate
    windows, promote the flip, or abort."""
    import urllib.error
    import urllib.request

    url = args.url.rstrip("/")

    def _call(method, path, body=None):
        data = None
        headers = {}
        if body is not None:
            data = json.dumps(body).encode("utf-8")
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url + path, data=data,
                                     headers=headers, method=method)
        try:
            with urllib.request.urlopen(req,
                                        timeout=args.timeout_s) as resp:
                return resp.getcode(), json.loads(
                    resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                payload = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                payload = {"error": "unparseable_reply",
                           "detail": raw[:200].decode("utf-8", "replace")}
            return e.code, payload
        except (urllib.error.URLError, OSError) as e:
            raise SystemExit(f"router unreachable at {url}: {e}")

    if args.verb == "start":
        if not args.source:
            raise SystemExit("rollout start requires --source "
                             "(candidate trunk run directory)")
        spec = {
            "source": args.source,
            "sample_every": args.sample_every,
            "window_requests": args.window_requests,
            "windows_required": args.windows,
            "shadow_parity_max": args.parity_max,
            "slo_burn_delta_max": args.burn_delta_max,
            "auto_promote": not args.no_auto_promote,
        }
        if args.hbm_budget_bytes is not None:
            spec["hbm_budget_bytes"] = args.hbm_budget_bytes
        status, out = _call("POST", "/rollout/start", spec)
    elif args.verb == "status":
        status, out = _call("GET", "/rollout/status")
    elif args.verb == "promote":
        status, out = _call("POST", "/rollout/promote")
    else:
        status, out = _call("POST", "/rollout/abort")

    if args.json:
        print(json.dumps(out, indent=2, sort_keys=True))
    elif status != 200:
        log(f"rollout {args.verb} failed (HTTP {status}): "
            f"{out.get('error', '?')} — {out.get('detail', '')}")
    elif args.verb == "status":
        ro = out.get("rollout")
        if ro is None:
            log("no rollout attached; fleet is "
                f"{out.get('fleet_state', '?')}")
        else:
            log(f"rollout [{ro['state']}] source={ro.get('source')} "
                f"candidate={str(ro.get('candidate_fingerprint'))[:12]} "
                f"windows {ro['windows_green']}/{ro['windows_required']} "
                f"green, shadows {ro['shadow_ok']} ok / "
                f"{ro['shadow_failed']} failed "
                f"({ro['dropped']} dropped)")
        log(f"fleet {out.get('fleet_state', '?')}: " + ", ".join(
            f"{n}={str(fp)[:12]}"
            for n, fp in sorted((out.get("fingerprints") or {}).items()))
            or "no routable fingerprints yet")
    else:
        log(f"rollout {args.verb}: ok — "
            + ", ".join(f"{k}={v}" for k, v in sorted(out.items())
                        if k != "ok"))
    return 0 if status == 200 else 1


# ------------------------------------------------------------------ parser

PRESETS = ["tiny", "base", "long", "large"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="proteinbert_tpu_torch",
        description="ProteinBERT on an NVIDIA H100: pretraining, "
                    "fine-tuning, inference and serving CLI (the PyTorch/"
                    "CUDA port of proteinbert_tpu)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the model runs (goes BEFORE the subcommand): cuda "
             "(default; the hand-written kernels on the card — without a "
             "card, commands that make tensors exit with a message) or "
             "cpu (the kernels' plain PyTorch versions). Nothing falls "
             "back to the CPU unasked",
    )
    sub = p.add_subparsers(dest="command", required=True)

    db = sub.add_parser("create-uniref-db", help="UniRef XML → SQLite")
    db.add_argument("--uniref-xml", type=existing_file, required=True)
    db.add_argument("--go-meta", type=existing_file, required=True,
                    help="GO OBO-style file (CAFA go.txt)")
    db.add_argument("--output-db", type=creatable_path, required=True)
    db.add_argument("--go-meta-csv", type=creatable_path)
    db.add_argument("--records-limit", type=int)
    db.add_argument("--task-index", type=int)
    db.add_argument("--task-count", type=int)
    db.set_defaults(fn=cmd_create_uniref_db)

    mg = sub.add_parser("merge-uniref-dbs", help="merge task-array shard DBs")
    mg.add_argument("--output-db", type=creatable_path, required=True)
    mg.add_argument("--num-shards", type=int)
    mg.add_argument("--shards", nargs="*")
    mg.add_argument("--go-meta", type=existing_file)
    mg.add_argument("--go-meta-csv", type=creatable_path)
    mg.set_defaults(fn=cmd_merge_uniref_dbs)

    h5 = sub.add_parser("create-h5", help="SQLite + FASTA → HDF5 dataset")
    h5.add_argument("--db", type=existing_file, required=True)
    h5.add_argument("--fasta", type=existing_file, required=True)
    h5.add_argument("--go-meta-csv", type=existing_file, required=True)
    h5.add_argument("--output", type=creatable_path, required=True)
    h5.add_argument("--min-records", type=int, default=100)
    h5.add_argument("--records-limit", type=int)
    h5.add_argument("--no-shuffle", action="store_true")
    h5.set_defaults(fn=cmd_create_h5)

    dbench = sub.add_parser("data-bench",
                            help="host input-pipeline throughput probe")
    dbench.add_argument("--preset", default="base", choices=PRESETS)
    dbench.add_argument("--data", type=existing_file,
                        help="HDF5 dataset (default: synthetic)")
    dbench.add_argument("--batches", type=int, default=50)
    dbench.add_argument("--set", action="append", metavar="PATH=VALUE")
    dbench.set_defaults(fn=cmd_data_bench)

    def add_train_args(sp, default_preset="base"):
        sp.add_argument("--preset", default=default_preset, choices=PRESETS)
        sp.add_argument("--data", type=existing_file,
                        help="HDF5 dataset (reference schema; default: "
                             "synthetic)")
        sp.add_argument("--max-steps", type=int)
        sp.add_argument("--multihost", action="store_true",
                        help="join the process group (COORDINATOR_ADDRESS/"
                             "NUM_PROCESSES/PROCESS_ID, or torchrun's env) "
                             "before building the mesh; one process a "
                             "card")
        sp.add_argument("--eval-frac", type=float, default=0.0,
                        help="hold out this fraction for periodic eval")
        sp.add_argument("--checkpoint-dir")
        sp.add_argument("--history-json", type=creatable_path)
        sp.add_argument("--metrics-jsonl", type=creatable_path,
                        help="append one JSON line per logged/eval step")
        sp.add_argument("--events-jsonl", type=creatable_path,
                        help="unified telemetry: append schema-versioned "
                             "run events here (run_start/step/ckpt_stage/"
                             "eval/requeue/nan_halt/run_end); also arms "
                             "the flight recorder, which dumps "
                             "flight_<pid>.json beside this file on "
                             "SIGTERM/NaN/crash")
        sp.add_argument("--profile-dir",
                        help="capture a torch.profiler trace here")
        sp.add_argument("--set", action="append", metavar="PATH=VALUE",
                        help="config override, e.g. --set model.local_dim=256;"
                             " --set train.overlap_eval=false keeps the "
                             "periodic eval synchronous (default true: the "
                             "eval is dispatched at its boundary and its "
                             "metrics fetched once, behind the next step)")

    tr = sub.add_parser("pretrain", help="denoising pretraining")
    add_train_args(tr)
    tr.set_defaults(fn=cmd_pretrain)

    sm = sub.add_parser("smoke", help="end-to-end sanity run (tiny preset)")
    add_train_args(sm, default_preset="tiny")
    sm.set_defaults(fn=cmd_smoke)

    ftp = sub.add_parser("finetune", help="fine-tune a task head on a trunk")
    ftp.add_argument("--preset", default="tiny", choices=PRESETS)
    ftp.add_argument("--task", default="token_classification",
                     choices=["token_classification",
                              "sequence_classification",
                              "sequence_regression"])
    ftp.add_argument("--num-outputs", type=int, default=8)
    ftp.add_argument("--epochs", type=int, default=3)
    ftp.add_argument("--freeze-trunk", action="store_true")
    ftp.add_argument("--pretrained", help="pretrain checkpoint dir for the trunk")
    ftp.add_argument("--pretrained-set", action="append", metavar="PATH=VALUE",
                     help="config override the PRETRAIN run was made with "
                          "(rebuilds its state template for restore)")
    ftp.add_argument("--data", type=existing_file,
                     help="labeled TSV (data/finetune_data.py format); "
                          "default: synthetic smoke batches")
    ftp.add_argument("--eval-data", type=existing_file)
    ftp.add_argument("--checkpoint-dir")
    ftp.add_argument("--history-json", type=creatable_path)
    ftp.add_argument("--events-jsonl", type=creatable_path,
                     help="unified telemetry events stream")
    ftp.add_argument("--register-head", metavar="REGISTRY_DIR",
                     help="save the trained head into this head registry "
                          "(content-addressed artifact with trunk "
                          "fingerprint + eval metrics; serve it with "
                          "`serve --registry`)")
    ftp.add_argument("--head-name",
                     help="human-readable name recorded on the "
                          "registered head artifact")
    ftp.add_argument("--set", action="append", metavar="PATH=VALUE")
    ftp.set_defaults(fn=cmd_finetune)

    eh = sub.add_parser("eval-heads",
                        help="score registered task heads against a "
                             "trunk (downstream eval harness)")
    eh.add_argument("--registry", required=True,
                    help="head registry directory (finetune "
                         "--register-head)")
    eh.add_argument("--pretrained", required=True,
                    help="pretrain checkpoint dir for the resident trunk")
    eh.add_argument("--preset", default="tiny", choices=PRESETS)
    eh.add_argument("--pretrained-set", action="append",
                    metavar="PATH=VALUE",
                    help="config override the pretrain run was made with")
    eh.add_argument("--heads", default="all",
                    help="comma-separated head ids, or 'all' (default)")
    eh.add_argument("--data", type=existing_file,
                    help="labeled TSV (data/finetune_data.py format; "
                         "single task kind); default: synthetic "
                         "labeled batches")
    eh.add_argument("--batch-size", type=int, default=16)
    eh.add_argument("--seed", type=int, default=0,
                    help="synthetic eval data seed")
    eh.add_argument("--no-trunk-check", action="store_true",
                    help="skip the trunk-fingerprint compatibility check "
                         "(scores then describe a mismatched pairing — "
                         "debugging only)")
    eh.add_argument("--events-jsonl", type=creatable_path,
                    help="append head_eval events to this JSONL stream")
    eh.add_argument("--output", type=creatable_path,
                    help="also write all results as one JSON object")
    eh.set_defaults(fn=cmd_eval_heads)

    def add_infer_args(sp, output_required=False):
        sp.add_argument("--pretrained", required=True,
                        help="pretrain checkpoint dir for the trunk")
        sp.add_argument("--preset", default="tiny", choices=PRESETS)
        sp.add_argument("--pretrained-set", action="append",
                        metavar="PATH=VALUE",
                        help="config override the pretrain run was made with")
        sp.add_argument("--fasta", type=existing_file)
        sp.add_argument("--seqs-file", type=existing_file,
                        help="one sequence per line, optionally id<TAB>seq")
        sp.add_argument("seqs", nargs="*", help="literal AA sequences")
        sp.add_argument("--batch-size", type=int, default=32)
        sp.add_argument("--output", type=creatable_path,
                        required=output_required)

    cv = sub.add_parser("convert-torch",
                        help="reference torch checkpoint → port run dir")
    cv.add_argument("--torch-ckpt", type=existing_file, required=True,
                    help="reference checkpoint .pt (periodic dict, bare "
                         "state_dict, or pickled module)")
    cv.add_argument("--output", type=creatable_path, required=True,
                    help="port run dir to create")
    cv.add_argument("--preset", default="tiny", choices=PRESETS)
    cv.add_argument("--step", type=int,
                    help="override the recorded iteration counter")
    cv.add_argument("--set", action="append", metavar="PATH=VALUE",
                    help="config matching the torch model's geometry")
    cv.set_defaults(fn=cmd_convert_torch)

    ev = sub.add_parser("evaluate",
                        help="score a checkpoint on a dataset")
    ev.add_argument("--pretrained", required=True,
                    help="pretrain checkpoint dir")
    ev.add_argument("--preset", default="tiny", choices=PRESETS)
    ev.add_argument("--pretrained-set", action="append",
                    metavar="PATH=VALUE",
                    help="config override the pretrain run was made with")
    ev.add_argument("--data", type=existing_file,
                    help="HDF5 dataset (default: synthetic)")
    ev.add_argument("--max-batches", type=int, default=0,
                    help="cap evaluated batches (0 = whole dataset)")
    ev.add_argument("--seed", type=int, default=1,
                    help="corruption key seed (fixed → reproducible)")
    ev.add_argument("--like-step", type=int,
                    help="corrupt as the training run's eval at this "
                         "history step did (matches its eval_* values "
                         "when the holdout divides the batch size and no "
                         "row exceeds the crop window)")
    ev.add_argument("--output", type=creatable_path,
                    help="also write the JSON result here")
    ev.set_defaults(fn=cmd_evaluate)

    dg = sub.add_parser("diagnose",
                        help="summarize a telemetry events JSONL "
                             "(+ flight-recorder dump)")
    dg.add_argument("events", type=existing_file,
                    help="events JSONL from --events-jsonl")
    dg.add_argument("--flight", type=existing_file,
                    help="flight_<pid>.json dump from a dead run")
    dg.add_argument("--last", type=int, default=10,
                    help="how many trailing events to list")
    dg.add_argument("--slow-top", type=int, default=5,
                    help="size of the slowest-windows list")
    dg.add_argument("--json", action="store_true",
                    help="machine-readable summary instead of the report")
    dg.add_argument("--serve", action="store_true",
                    help="render only the serving section (request "
                         "outcomes, stage attribution, SLO breaches)")
    dg.add_argument("--map", action="store_true",
                    help="render only the offline-mapping section")
    dg.add_argument("--fleet", action="store_true",
                    help="render only the fleet section (feed the "
                         "merged stream `fleet` writes)")
    dg.add_argument("--trace-id", default=None,
                    help="with --fleet: reconstruct ONE request's causal "
                         "chain by its fleet id (X-PBT-Request-Id)")
    dg.add_argument("--trace-perfetto", type=creatable_path, default=None,
                    help="with --fleet: write cross-process Perfetto "
                         "lanes reconstructed from the merged stream")
    dg.set_defaults(fn=cmd_diagnose)

    ex = sub.add_parser("export-weights",
                        help="trained params → flat NPZ of named arrays")
    ex.add_argument("--pretrained", required=True,
                    help="pretrain checkpoint dir")
    ex.add_argument("--preset", default="tiny", choices=PRESETS)
    ex.add_argument("--pretrained-set", action="append",
                    metavar="PATH=VALUE",
                    help="config override the pretrain run was made with")
    ex.add_argument("--output", type=creatable_path, required=True)
    ex.set_defaults(fn=cmd_export_weights)

    im = sub.add_parser("import-weights",
                        help="flat NPZ → port run dir")
    im.add_argument("--weights", type=existing_file, required=True,
                    help="NPZ in the export-weights format (either "
                         "package's)")
    im.add_argument("--output", type=creatable_path, required=True,
                    help="port run dir to create")
    im.add_argument("--preset", default="tiny", choices=PRESETS)
    im.add_argument("--step", type=int, default=0,
                    help="iteration counter to record")
    im.add_argument("--set", action="append", metavar="PATH=VALUE",
                    help="config matching the weights' geometry")
    im.set_defaults(fn=cmd_import_weights)

    em = sub.add_parser("embed", help="trunk representations → HDF5/NPZ")
    add_infer_args(em, output_required=True)
    em.add_argument("--per-residue", action="store_true",
                    help="also write per-residue local track (N, L, C)")
    em.set_defaults(fn=cmd_embed)

    pg = sub.add_parser("predict-go",
                        help="GO annotation probabilities from sequence")
    add_infer_args(pg)
    pg.add_argument("--top-k", type=int, default=10)
    pg.add_argument("--data", type=existing_file,
                    help="training HDF5: maps annotation columns → GO ids")
    pg.add_argument("--go-meta-csv", type=existing_file,
                    help="GO meta CSV: adds term names to the output")
    pg.set_defaults(fn=cmd_predict_go)

    pr = sub.add_parser("predict-residues",
                        help="fill '?'-masked residues via the local head")
    add_infer_args(pr)
    pr.set_defaults(fn=cmd_predict_residues)

    sv = sub.add_parser("serve",
                        help="online JSON/HTTP inference server "
                             "(continuous micro-batching)")
    sv.add_argument("--pretrained", required=True,
                    help="pretrain checkpoint dir for the trunk")
    sv.add_argument("--preset", default="tiny", choices=PRESETS)
    sv.add_argument("--pretrained-set", action="append",
                    metavar="PATH=VALUE",
                    help="config override the pretrain run was made with")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8476,
                    help="0 = ephemeral (read it back via --port-file)")
    sv.add_argument("--port-file", type=creatable_path,
                    help="write the bound port here once listening")
    sv.add_argument("--serve-mode", default="bucketed",
                    choices=["bucketed", "ragged"],
                    help="bucketed: one warm shape per (bucket, batch "
                         "class); ragged: pack heterogeneous requests "
                         "into fixed-shape (max_batch, seq_len) rows — "
                         "one shape per request kind")
    sv.add_argument("--pack-max-segments", type=int, default=8,
                    help="ragged mode: max requests packed into one row")
    sv.add_argument("--max-batch", type=int, default=8,
                    help="micro-batch size cap; in ragged mode, the "
                         "packed ROW count per shape")
    sv.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="max queueing delay before an under-full batch "
                         "dispatches anyway")
    sv.add_argument("--queue-depth", type=int, default=64,
                    help="admission-control bound; overflow evicts the "
                         "oldest queued request with a 429")
    sv.add_argument("--cache-size", type=int, default=1024,
                    help="LRU result-cache entries (0 disables)")
    sv.add_argument("--replica-id", default=None,
                    help="fleet identity stamped on every serve_request/"
                         "serve_batch event (fleet passes r0..rN-1)")
    sv.add_argument("--deadline-ms", type=float,
                    help="default per-request deadline (504 when missed)")
    sv.add_argument("--on-long", default="truncate",
                    choices=["truncate", "reject"],
                    help="over-window sequences: truncate-and-count or "
                         "reject with 400")
    sv.add_argument("--mesh", action="store_true",
                    help="split served batches over the data*fsdp "
                         "replicas of the run config's mesh, one lane a "
                         "replica card (both serve modes: bucketed micro-"
                         "batches and ragged packed rows)")
    sv.add_argument("--max-requests", type=int,
                    help="exit after this many requests (smoke tests)")
    sv.add_argument("--events-jsonl", type=creatable_path,
                    help="append serve_* run events to this JSONL stream")
    sv.add_argument("--trace-sample-rate", type=float, default=1.0,
                    help="fraction of requests whose serve_request event "
                         "+ spans are emitted (errors/rejections always "
                         "emit)")
    sv.add_argument("--trace-perfetto", type=creatable_path,
                    help="dump request-trace spans here at drain "
                         "(Perfetto traceEvents JSON, .gz ok)")
    sv.add_argument("--slo", action="append", metavar="SPEC",
                    help="declarative objective, repeatable: e.g. "
                         "'kind=latency,threshold_ms=250,target=0.99,"
                         "window_s=300' or 'kind=error_rate,"
                         "target=0.999'")
    sv.add_argument("--slo-profile-dir", type=creatable_path,
                    help="on an SLO breach, capture an on-demand "
                         "torch.profiler trace here (cooldown-limited)")
    sv.add_argument("--registry",
                    help="head registry directory: serve registered "
                         "finetuned heads over the shared trunk")
    sv.add_argument("--heads", default=None,
                    help="comma-separated head ids to load at start, or "
                         "'all' (default: all); requires --registry")
    sv.add_argument("--quant", default=None,
                    choices=["fp32", "int8", "int8_act"],
                    help="served arm: int8 = symmetric per-channel int8 "
                         "WEIGHTS through the kernels' int8 legs; "
                         "int8_act adds dynamic int8 fake-quant of the "
                         "trunk's outputs (bucketed mode only). Default: "
                         "the run config's serve.quant")
    sv.add_argument("--quant-parity-every", type=int, default=None,
                    metavar="N",
                    help="with a quantized arm: every Nth batch also runs "
                         "the fp32 arm and records the worst deviation. "
                         "0 disables. Default: the run config's "
                         "serve.quant_parity_every")
    sv.add_argument("--pipeline-depth", type=int, default=None,
                    metavar="N",
                    help="bounded in-flight dispatch window; 1 = serial. "
                         "Default: the run config's serve.pipeline_depth")
    sv.add_argument("--index",
                    help="neighbor-index directory (index) to serve "
                         "/v1/neighbors from; it must have been built "
                         "from THIS trunk's embedding store")
    sv.add_argument("--nprobe", type=int, default=8,
                    help="with --index: centroid lists probed per query")
    sv.set_defaults(fn=cmd_serve)

    mp = sub.add_parser("map",
                        help="resumable sharded batch inference: embed a "
                             "corpus through the packed trunk into a "
                             "content-addressed, integrity-verified "
                             "embedding store")
    mp.add_argument("--store", required=True,
                    help="embedding-store directory (created on first "
                         "run; an existing store RESUMES from its shard "
                         "cursors)")
    mp.add_argument("--verify", action="store_true",
                    help="audit an existing store instead of mapping "
                         "(typed, nonzero exit on corruption or holes). "
                         "Needs only --store")
    mp.add_argument("--pretrained",
                    help="pretrain checkpoint dir for the trunk "
                         "(required unless --verify)")
    mp.add_argument("--preset", default="tiny", choices=PRESETS)
    mp.add_argument("--pretrained-set", action="append",
                    metavar="PATH=VALUE",
                    help="config override the pretrain run was made with")
    mp.add_argument("--fasta", type=existing_file)
    mp.add_argument("--seqs-file", type=existing_file,
                    help="one sequence per line, optionally id<TAB>seq")
    mp.add_argument("seqs", nargs="*", help="literal AA sequences")
    mp.add_argument("--num-shards", type=int, default=1,
                    help="deterministic contiguous corpus shards, each "
                         "with its own crash-safe cursor")
    mp.add_argument("--block-size", type=int, default=64,
                    help="sequences per durably-committed block")
    mp.add_argument("--rows-per-batch", type=int, default=8,
                    help="packed rows per dispatch")
    mp.add_argument("--max-segments", type=int, default=8,
                    help="max sequences packed into one row")
    mp.add_argument("--buckets",
                    help="span-quantization ladder as a JSON list (e.g. "
                         "[64,128,512]; ascending, last == seq_len); "
                         "default: the run config's data.buckets, else "
                         "the single full-length bucket. Pinned in the "
                         "store manifest")
    mp.add_argument("--max-blocks", type=int,
                    help="stop (resumably, exit 75) after this many "
                         "blocks this invocation")
    mp.add_argument("--no-pipeline", action="store_true",
                    help="run compute → fetch → commit strictly serially "
                         "per block (same bytes; the A/B knob)")
    mp.add_argument("--events-jsonl", type=creatable_path,
                    help="append map_* events here (diagnose --map reads "
                         "them); also arms the flight recorder")
    mp.set_defaults(fn=cmd_map)

    ix = sub.add_parser("index",
                        help="build an int8 IVF neighbor index over a "
                             "completed embedding store (resumable, "
                             "kill-anywhere; serves /v1/neighbors)")
    ix.add_argument("--index", required=True,
                    help="index directory (created on first run; an "
                         "existing one RESUMES from its shard cursors)")
    ix.add_argument("--store",
                    help="COMPLETED embedding store (map) to index; "
                         "required unless --verify")
    ix.add_argument("--verify", action="store_true",
                    help="audit an existing index instead of building "
                         "(typed, nonzero exit). Needs only --index")
    ix.add_argument("--centroids", type=int, default=64,
                    help="coarse k-means centroid count (clamped to the "
                         "corpus size; pinned in the manifest)")
    ix.add_argument("--block-size", type=int, default=256,
                    help="vectors per durably-committed index block")
    ix.add_argument("--seed", type=int, default=0,
                    help="k-means seed — same store + same knobs → "
                         "byte-identical index")
    ix.add_argument("--kmeans-iters", type=int, default=8,
                    help="Lloyd iterations for the coarse centroids")
    ix.add_argument("--sample-cap", type=int, default=4096,
                    help="deterministic strided sample size the centroids "
                         "are fit on")
    ix.add_argument("--max-blocks", type=int,
                    help="stop (resumably, exit 75) after this many "
                         "blocks this invocation")
    ix.add_argument("--json", action="store_true",
                    help="print the terminal build stats as one JSON line")
    ix.add_argument("--events-jsonl", type=creatable_path,
                    help="append index_build/index_shard events here; "
                         "also arms the flight recorder")
    ix.set_defaults(fn=cmd_index)

    fl = sub.add_parser("fleet",
                        help="N serve replicas behind a self-healing "
                             "router (health checks, retries, load "
                             "shedding, shared result cache)")
    fl.add_argument("--pretrained", required=True,
                    help="pretrain checkpoint dir for the trunk")
    fl.add_argument("--preset", default="tiny", choices=PRESETS)
    fl.add_argument("--pretrained-set", action="append",
                    metavar="PATH=VALUE")
    fl.add_argument("--replicas", type=int, default=2,
                    help="serve replica subprocesses to spawn")
    fl.add_argument("--host", default="127.0.0.1")
    fl.add_argument("--port", type=int, default=8475,
                    help="router port; 0 = ephemeral (read it back via "
                         "--port-file)")
    fl.add_argument("--port-file", type=creatable_path)
    fl.add_argument("--serve-mode", default="bucketed",
                    choices=["bucketed", "ragged"])
    fl.add_argument("--max-batch", type=int, default=8)
    fl.add_argument("--max-wait-ms", type=float, default=10.0)
    fl.add_argument("--queue-depth", type=int, default=64)
    fl.add_argument("--cache-size", type=int, default=1024,
                    help="per-replica result-cache entries")
    fl.add_argument("--fleet-cache-size", type=int, default=2048,
                    help="router-level shared result-cache entries "
                         "(0 disables)")
    fl.add_argument("--deadline-ms", type=float)
    fl.add_argument("--on-long", default="truncate",
                    choices=["truncate", "reject"])
    fl.add_argument("--slo", action="append", metavar="SPEC",
                    help="passed through to every replica; burn rates "
                         "feed the router's degraded state")
    fl.add_argument("--health-interval-ms", type=float, default=500.0)
    fl.add_argument("--max-retries", type=int, default=2)
    fl.add_argument("--retry-budget-ratio", type=float, default=0.2)
    fl.add_argument("--boot-timeout-s", type=float, default=300.0)
    fl.add_argument("--exit-on-replica-death", action="store_true",
                    help="shut the fleet down when any replica process "
                         "exits (default: keep serving on the survivors)")
    fl.add_argument("--events-jsonl", type=creatable_path,
                    help="append fleet_* router events here (each replica "
                         "writes its own stream beside its log)")
    fl.set_defaults(fn=cmd_fleet)

    ck = sub.add_parser(
        "check",
        help="project-invariant static analyzer over the port (graph "
             "purity and launch or raise, lock discipline, durability "
             "protocol, event schema, doc drift, dead exports)")
    ck.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ck.add_argument("--json-artifact", type=creatable_path,
                    help="also write the JSON report here")
    ck.add_argument("--rule", action="append", metavar="NAME",
                    help="run only this rule (repeatable)")
    ck.add_argument("--events-jsonl", type=creatable_path,
                    help="mirror the counts as a note(kind=check_capture) "
                         "event")
    ck.add_argument("--baseline",
                    help="suppression baseline JSON (default: "
                         "proteinbert_tpu_torch/analysis/"
                         "check_baseline.json)")
    ck.add_argument("--root", help="tree to analyze (default: the repo "
                                   "that holds the port)")
    ck.add_argument("--write-baseline", action="store_true",
                    help="record current findings as suppressions for "
                         "human review")
    ck.set_defaults(fn=cmd_check)

    rs = sub.add_parser("reshard",
                        help="carry a checkpoint to a new mesh layout "
                             "(a fresh run dir at the target topology; "
                             "the step file is full-shape, so no device "
                             "of either mesh is needed)")
    rs.add_argument("--src", required=True,
                    help="source run directory (checkpoints + "
                         "config.json)")
    rs.add_argument("--output", type=creatable_path, required=True,
                    help="run directory to create at the target layout")
    rs.add_argument("--target-mesh",
                    help="target topology: '4x2' (data x fsdp), "
                         "'8x1x1x1' (data x fsdp x model x seq), '1' "
                         "(single device), or 'data=4,fsdp=2'; "
                         "default: the source config's mesh")
    rs.add_argument("--step", type=int,
                    help="checkpoint step to reshard (default: latest; "
                         "explicit steps are strict — no torn-tail "
                         "fallback)")
    rs.add_argument("--zero-update", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="record the target's optimizer state as ZeRO-1-"
                         "sharded (--no-zero-update: replicated; default: "
                         "the source config's parallel.zero_update)")
    rs.add_argument("--no-verify", action="store_true",
                    help="skip the round-trip byte-parity check "
                         "(verification re-reads the written "
                         "checkpoint)")
    rs.add_argument("--preset", default="tiny",
                    choices=["tiny", "base", "long", "large"])
    rs.add_argument("--pretrained-set", action="append",
                    metavar="PATH=VALUE",
                    help="config override the source run was made with "
                         "(when it lacks a config.json)")
    rs.add_argument("--events-jsonl", type=creatable_path,
                    help="append the reshard event (+ wire-bytes "
                         "metrics) to this JSONL stream")
    rs.set_defaults(fn=cmd_reshard)

    ro = sub.add_parser(
        "rollout",
        help="blue-green trunk rollout against a running fleet router: "
             "shadow a candidate trunk on live traffic, gate on parity/"
             "SLO/heads-eval windows, promote atomically, abort/roll back")
    ro.add_argument("verb",
                    choices=["start", "status", "promote", "abort"],
                    help="start: load + shadow a candidate; status: gate "
                         "windows + fleet fingerprint coherence; promote: "
                         "atomic flip (requires the green streak); abort: "
                         "unload, or roll a promoted flip back")
    ro.add_argument("--url", default="http://127.0.0.1:8475",
                    help="fleet router base URL")
    ro.add_argument("--source",
                    help="candidate trunk run directory, resolved by each "
                         "replica's own loader (start only)")
    ro.add_argument("--sample-every", type=int, default=2,
                    help="mirror every Nth live request to the shadow arm "
                         "(1 = all traffic)")
    ro.add_argument("--window-requests", type=int, default=8,
                    help="shadow responses per gate window")
    ro.add_argument("--windows", type=int, default=2,
                    help="consecutive green windows required before "
                         "promotion")
    ro.add_argument("--parity-max", type=float, default=1e-3,
                    help="max |live − shadow| over shared numeric "
                         "response leaves")
    ro.add_argument("--burn-delta-max", type=float, default=0.5,
                    help="max fleet SLO burn-rate rise vs the pre-rollout "
                         "baseline")
    ro.add_argument("--hbm-budget-bytes", type=int,
                    help="per-replica device-memory budget for the "
                         "two-trunk residency check (default: "
                         "replica-side detection)")
    ro.add_argument("--no-auto-promote", action="store_true",
                    help="stop at the green streak and wait for an "
                         "explicit `rollout promote`")
    ro.add_argument("--timeout-s", type=float, default=120.0,
                    help="HTTP timeout per control verb (start blocks on "
                         "candidate load + warmup fleet-wide)")
    ro.add_argument("--json", action="store_true",
                    help="raw router reply on stdout")
    ro.set_defaults(fn=cmd_rollout)

    return p


def _refused(argv: List[str]) -> Optional[str]:
    """The message of the first refused JAX-CLI flag in `argv`."""
    for tok in argv:
        if tok == "--":
            break
        flag = tok.split("=", 1)[0]
        if flag in REFUSED_FLAGS:
            return REFUSED_FLAGS[flag]
    return None


def main(argv: Optional[List[str]] = None) -> int:
    start_log()
    self_destruct = int(os.environ.get("PBT_SELF_DESTRUCT_SECS", "0"))
    if self_destruct > 0:
        # Opt-in hard deadline for harness-driven runs: if the harness is
        # killed while this process hangs (device init, a stuck kernel),
        # the orphan must not hold the card forever. No handler is
        # installed, so SIGALRM's default action terminates even inside
        # native code.
        import signal

        signal.alarm(self_destruct)
    argv = list(sys.argv[1:] if argv is None else argv)
    refused = _refused(argv)
    if refused:
        raise SystemExit(refused)
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
