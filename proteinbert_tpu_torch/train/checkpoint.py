"""Checkpoints of the port's train state — the torch counterpart of
`proteinbert_tpu/train/checkpoint.py`, which is built on orbax (and orbax
imports JAX, so nothing of it is used here).

Format: one directory a step, `<dir>/<step>/`:
- `state.pt` — `torch.save` of a CPU tree {"step", "params", "opt_state":
  {"count", "mu", "nu", "plateau"}, "generator"}: the whole `TrainState`,
  the corruption generator's `get_state()` included;
- `data.json` — the optional data item (the trainer's data position and
  eval stream).
A step is written into a temporary sibling (`<dir>/.tmp-<step>-<pid>`),
each file fsynced, then renamed into place and the directory fsynced, so
a reader finds a whole step or none; a crash mid-write leaves a temporary
directory, which the next `Checkpointer` on the directory removes. Steps
load with `torch.load(..., weights_only=True)`.

The contracts of orbax's manager that the trainer relies on are kept:
`save` returns False and writes nothing for a step <= `latest_step()`;
`max_to_keep` keeps the newest steps; the data item is optional;
`on_event` fires "save", "dispatch" and "landed", `on_note` reports a
restore fallback, and a hook's errors are logged, never raised.
`async_save` writes on the saver thread after a synchronous copy to the
host (orbax's async write); `wait()` joins it.

The staged (overlapped) save differs from JAX's in where the snapshot is
taken. JAX snapshots immutable device arrays, which no later step can
change; the port's `train_step` updates the params and both Adam moments
IN PLACE, so a copy still in flight when the next update runs would save
a torn state. `save_staged` therefore takes the LIVE state and snapshots
it itself, on the caller's stream at the boundary: one device-to-device
copy into flat device buffers (one a dtype) allocated at the first
staged save and reused (the state's size once more in device memory —
4.0 GB at Large — for a copy that costs milliseconds). The saver thread
then copies each buffer to a flat pinned host twin (also allocated once,
on that thread) in one transfer on a side stream that waits for the
snapshot's event, and writes them, while the train stream runs on. At most one stage is in flight: the next boundary
waits for it (`flush_staged`). On the CPU the snapshot is a host copy
already.

Multi-rank runs — a `seq_group`, or a `mesh` (`parallel.mesh.Mesh`) of
more than one rank: rank 0 writes, synchronously, and every rank meets at
a barrier; every rank keeps the same step list, and every rank restores
from disk. Staged saves need a one-rank group. A step file is always
full-shape, whoever wrote it: under ZeRO-1 on a data-only mesh (moments
at this rank's shard shape, `parallel/zero.py`) a save first gathers the
moments across the replica group; on an fsdp- or model-bearing mesh (a
state whose `layout` is set, `parallel/fsdp.py`) it gathers the params'
fsdp and model shards and the moments' ZeRO pieces. A restore slices the
full tensors to the template's layout: this rank's ZeRO shard of each
moment, or through the template's `layout` its shards of everything. So
a plain, a ZeRO, an fsdp or a model run of the same state writes the
same file, and any of them resumes it.

Restore checks every leaf's shape and dtype against the template and
raises ValueError on a mismatch (a wrong template is a real error, never
a torn step); the leaves land on the template's device and the generator
state goes through `set_state` on a generator of the template's device
type, so a state saved on the card restores onto a card.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from proteinbert_tpu_torch.train.schedule import OptState, tree_leaves
from proteinbert_tpu_torch.train.train_state import TrainState

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
DATA_FILE = "data.json"
_TMP_PREFIX = ".tmp-"
# What reading a missing or torn step raises: a missing file (OSError),
# a truncated zip (RuntimeError from torch's reader), a cut pickle or
# JSON stream. A template mismatch is checked after the read, outside.
_UNREADABLE = (OSError, RuntimeError, EOFError, pickle.UnpicklingError,
               ValueError)


def _map(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree) if torch.is_tensor(tree) else tree


def _rebuild(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """`tree` with its tensors replaced, in order, by `leaves`."""
    it = iter(leaves)
    return _map(tree, lambda t: next(it))


def _align_leaf_order(tree: Dict[str, Any], like: Dict[str, Any]) -> None:
    """Put a read tree's params dicts in the template's leaf order, in
    place, when the two hold the same leaf paths in another order (a
    params tree built from a flat NPZ lists `blocks` last; `init` lists it
    third), and its moment lists too where they followed the saved
    params' order (a moment list already in the template's order, by its
    shapes, stays)."""
    from proteinbert_tpu_torch.parallel.sharding import leaf_paths

    saved = [p for p, _ in leaf_paths(tree["params"])]
    want = [p for p, _ in leaf_paths(like["params"])]
    if saved == want or sorted(map(str, saved)) != sorted(map(str, want)):
        return
    pos = {p: i for i, p in enumerate(saved)}
    leaves = tree_leaves(tree["params"])
    tree["params"] = _rebuild(like["params"], [leaves[pos[p]] for p in want])
    o = tree["opt_state"]
    ordered = [tuple(leaves[pos[p]].shape) for p in want]
    for k in ("mu", "nu"):
        if len(o[k]) != len(saved) or [
                tuple(t.shape) for t in o[k]] == ordered:
            continue
        o[k] = [o[k][pos[p]] for p in want]


def _tensors(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(tree, out.append)
    return out


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The checkpointed tree of a TrainState, its tensors where they live
    (the generator state is a CPU tensor)."""
    o = state.opt_state
    return {"step": int(state.step), "params": state.params,
            "opt_state": {"count": int(o.count), "mu": list(o.mu),
                          "nu": list(o.nu), "plateau": o.plateau},
            "generator": state.generator.get_state()}


def _host_copy(tree: Any) -> Any:
    return _map(tree, lambda t: t.detach().to("cpu", copy=True))


def _check_like(saved: Any, like: Any, path: str) -> None:
    """ValueError unless `saved` has `like`'s structure and every tensor
    its shape and dtype."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError(
                f"checkpoint {path or 'tree'}: keys "
                f"{sorted(saved) if isinstance(saved, dict) else saved!r}"
                f" != template {sorted(like)}")
        for k in like:
            _check_like(saved[k], like[k], f"{path}.{k}" if path else k)
    elif isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint {path}: {len(saved)} entries "
                             f"!= template {len(like)}")
        for i, (s, t) in enumerate(zip(saved, like)):
            _check_like(s, t, f"{path}[{i}]")
    elif torch.is_tensor(like):
        if (not torch.is_tensor(saved) or saved.shape != like.shape
                or saved.dtype != like.dtype):
            got = (f"{tuple(saved.shape)} {saved.dtype}"
                   if torch.is_tensor(saved) else repr(saved))
            raise ValueError(f"checkpoint {path}: {got} != template "
                             f"{tuple(like.shape)} {like.dtype}")
    elif (like is None) != (saved is None):
        raise ValueError(f"checkpoint {path}: {saved!r} against template "
                         f"{like!r}")


def _layout(tensors: List[torch.Tensor]) -> List[Tuple]:
    return [(t.shape, t.dtype, t.device) for t in tensors]


def _flat_views(tensors: List[torch.Tensor], device: torch.device,
                pin: bool = False):
    """One flat buffer a dtype on `device` (pinned on request) and a view
    of it shaped like each tensor → ({dtype: buffer}, views). torch.save
    keeps views of one storage as views, of one dtype each."""
    sizes: Dict[torch.dtype, int] = {}
    offsets = []
    for t in tensors:
        offsets.append(sizes.get(t.dtype, 0))
        sizes[t.dtype] = offsets[-1] + t.numel()
    bufs = {dt: torch.empty(n, dtype=dt, device=device, pin_memory=pin)
            for dt, n in sizes.items()}
    views = [bufs[t.dtype][o:o + t.numel()].view(t.shape)
             for o, t in zip(offsets, tensors)]
    return bufs, views


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Checkpoints of one run directory: JAX's `Checkpointer` surface
    (`save`, `save_staged`, `flush_staged`, `poll_staged`,
    `staged_in_flight`, `restore`, `all_steps`, `latest_step`,
    `in_flight`, `wait`, `close`) over `torch.save` files."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True, seq_group=None, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        # Optional hooks, as in the JAX Checkpointer: on_event(phase,
        # step, **info) for phase in obs.events.CKPT_PHASES, on_note(
        # **fields) for a restore fallback. Errors in them are logged.
        self.on_event = None
        self.on_note = None
        self._group = seq_group
        self._mesh = mesh
        self.world = 1
        self._writer = True
        if mesh is not None:
            if seq_group is not None:
                raise ValueError("pass a seq_group or a mesh, not both")
            self.world = mesh.size
            self._writer = mesh.rank == 0
            if self.world > 1:
                import torch.distributed as dist

                self._group = dist.group.WORLD
        elif seq_group is not None:
            import torch.distributed as dist

            self.world = dist.get_world_size(seq_group)
            self._writer = dist.get_rank(seq_group) == 0
        self._lock = threading.Lock()
        self._steps: List[int] = []               # guarded-by: _lock
        self._saver = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="ckpt-saver")
        self._write: Optional[Future] = None      # pending async write
        self._staged: Optional[Tuple[Future, Dict[str, Any]]] = None
        # ({dtype: flat buffer}, views) of the staged snapshot on the
        # state's device and of its pinned host copy, made once, reused.
        self._snap: Optional[Tuple[Dict, List[torch.Tensor]]] = None
        self._pinned: Optional[Tuple[Dict, List[torch.Tensor]]] = None
        self._side_stream = None
        names = (os.listdir(self.directory)
                 if os.path.isdir(self.directory) else [])
        for name in names:
            path = os.path.join(self.directory, name)
            if name.startswith(_TMP_PREFIX) and self._writer:
                shutil.rmtree(path, ignore_errors=True)   # a torn write
            elif re.fullmatch(r"\d+", name) and os.path.isdir(path):
                self._steps.append(int(name))
        self._steps.sort()

    # ------------------------------------------------------------ hooks

    def _notify(self, phase: str, step: int, **info) -> None:
        cb = self.on_event
        if cb is None:
            return
        try:
            cb(phase, step, **info)
        except Exception:
            logger.exception("checkpoint on_event hook failed (phase=%s "
                             "step=%d) — save path unaffected", phase, step)

    # ------------------------------------------------------------ writes

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _write_step(self, step: int, host_tree: Any,
                    data_state: Optional[Dict]) -> None:
        """Write one step atomically (temporary sibling, fsync, rename),
        then drop the steps past `max_to_keep`."""
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)  # and the run directory, at its first save
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(host_tree, f)
            f.flush()
            os.fsync(f.fileno())
        if data_state is not None:
            with open(os.path.join(tmp, DATA_FILE), "w") as f:
                json.dump(data_state, f)
                f.flush()
                os.fsync(f.fileno())
        os.rename(tmp, self._step_dir(step))
        _fsync_dir(self.directory)
        self._land(step)

    def _land(self, step: int) -> None:
        """Record a written step and apply the retention window (only the
        writing rank removes files)."""
        with self._lock:
            self._steps = sorted(set(self._steps) | {step})
            drop = self._steps[:-self.max_to_keep] if self.max_to_keep \
                else []
            self._steps = self._steps[len(drop):]
        if self._writer:
            for s in drop:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _join_write(self) -> None:
        fut, self._write = self._write, None
        if fut is not None:
            fut.result()  # re-raises a write error

    def _settle(self) -> None:
        """One save writing at a time: land the staged save and the async
        write before the next save looks at `latest_step()`."""
        self.flush_staged()
        self._join_write()

    def save(self, step: int, state: TrainState,
             data_state: Optional[Dict] = None) -> bool:
        """Save `state` at `step`; False (nothing written) when the
        directory already holds a step >= `step` — callers that need the
        save to have happened must check. The copy to the host is
        synchronous; with `async_save` the write then runs on the saver
        thread (`wait()` joins it). Under a multi-rank seq group rank 0
        writes synchronously and every rank meets at a barrier."""
        self._settle()
        latest = self.latest_step()
        saved = latest is None or step > latest
        if saved:
            state = self._full_moments(state)
            if self.world > 1:
                if self._writer:
                    self._write_step(step, _host_copy(state_tree(state)),
                                     data_state)
                else:
                    self._land(step)
                import torch.distributed as dist

                dist.barrier(group=self._group)
            else:
                host = _host_copy(state_tree(state))
                if self.async_save:
                    self._write = self._saver.submit(
                        self._write_step, step, host, data_state)
                else:
                    self._write_step(step, host, data_state)
        self._notify("save", step, saved=saved)
        return saved

    def write(self, step: int, host_tree: Dict[str, Any],
              data_state: Optional[Dict] = None) -> bool:
        """Write a host tree in `state.pt`'s layout (`read`'s output) at
        `step`, synchronously, from one process; False (nothing written)
        when the directory already holds a step >= `step`."""
        self._settle()
        latest = self.latest_step()
        saved = latest is None or step > latest
        if saved:
            self._write_step(step, host_tree, data_state)
        self._notify("save", step, saved=saved)
        return saved

    def _full_moments(self, state: TrainState) -> TrainState:
        """The state at full shape: a sharded state's params and moments
        gathered through its layout, ZeRO-sharded moments gathered over
        the mesh's replica group (collective); as is otherwise."""
        if state.layout is not None:
            return state.layout.full_state(state)
        o = state.opt_state
        if self.world == 1 or all(
                m.shape == p.shape
                for m, p in zip(o.mu, tree_leaves(state.params))):
            return state
        from proteinbert_tpu_torch.parallel.zero import moments_full

        return TrainState(state.step, state.params,
                          moments_full(o, state.params,
                                       self._mesh.replica_group),
                          state.generator)

    # ------------------------------------------- overlapped (staged) saves

    def _snapshot(self, state: TrainState):
        """Copy the state's tensors into the reusable snapshot buffer on the
        current stream → (tree of its views, the copy's CUDA event or
        None)."""
        tree = state_tree(state)
        gen = tree.pop("generator")      # a fresh host tensor already
        live = _tensors(tree)
        if self._snap is None or _layout(self._snap[1]) != _layout(live):
            self._snap = _flat_views(live, live[0].device)
            self._pinned = None
        torch._foreach_copy_(self._snap[1], live)
        views = iter(self._snap[1])
        snap = _map(tree, lambda t: next(views))
        snap["generator"] = gen
        event = None
        if live[0].is_cuda:
            event = torch.cuda.Event()
            event.record()
        return snap, event

    def _stage_fetch(self, snapshot) -> Any:
        """The snapshot as a host tree; runs on the saver thread (a method,
        so tests can interpose latency). On the card a side stream waits
        for the snapshot's event, then copies each flat buffer to its
        pinned twin in one transfer."""
        tree, event = snapshot
        if event is None:
            return tree
        gen = tree.pop("generator")
        bufs, dev_views = self._snap
        if self._pinned is None:
            self._pinned = _flat_views(dev_views, torch.device("cpu"),
                                       pin=True)
            self._side_stream = torch.cuda.Stream(dev_views[0].device)
        with torch.cuda.stream(self._side_stream):
            self._side_stream.wait_event(event)
            for dt, buf in bufs.items():
                self._pinned[0][dt].copy_(buf, non_blocking=True)
        self._side_stream.synchronize()
        views = iter(self._pinned[1])
        host = _map(tree, lambda t: next(views))
        host["generator"] = gen
        return host

    def save_staged(self, step: int, state: TrainState,
                    data_state: Optional[Dict] = None) -> None:
        """Snapshot the LIVE state at this boundary and hand the copy to
        the host and the write to the saver thread; returns at once.
        Backpressure: one stage in flight (a stage still running blocks
        here first). Errors of the stage re-raise at the next
        flush_staged() / poll_staged() / wait(); a skipped step (<=
        latest) is logged as loudly as the synchronous path."""
        if self.world > 1:
            raise ValueError("staged saves need a one-rank seq group; "
                             "multi-rank runs save synchronously")
        self._settle()
        latest = self.latest_step()
        holder: Dict[str, Any] = {"step": step,
                                  "saved": latest is None or step > latest}
        snapshot = self._snapshot(state) if holder["saved"] else None

        def work():
            t0 = time.perf_counter()
            try:
                if snapshot is not None:
                    self._write_step(step, self._stage_fetch(snapshot),
                                     data_state)
            finally:
                holder["overlap_s"] = time.perf_counter() - t0

        self._notify("dispatch", step)
        self._staged = (self._saver.submit(work), holder)

    def flush_staged(self) -> Optional[Dict[str, Any]]:
        """Join the in-flight staged save (no-op when none); re-raises its
        error; returns its stats ({step, saved, overlap_s}) or None."""
        if self._staged is None:
            return None
        fut, holder = self._staged
        self._staged = None
        fut.result()
        if not holder["saved"]:
            logger.warning(
                "staged checkpoint save at step %d was SKIPPED (directory "
                "already holds a step >= %d) — state was NOT written",
                holder["step"], holder["step"])
        self._notify("landed", holder["step"], saved=holder["saved"],
                     overlap_s=round(holder.get("overlap_s", 0.0), 6))
        return holder

    def poll_staged(self) -> Optional[Dict[str, Any]]:
        """Non-blocking flush: stats if the stage has finished, else None."""
        if self._staged is None or not self._staged[0].done():
            return None
        return self.flush_staged()

    def staged_in_flight(self) -> bool:
        return self._staged is not None and not self._staged[0].done()

    # ------------------------------------------------------------ restore

    def _read_step(self, step: int) -> Tuple[Any, Optional[Dict]]:
        path = self._step_dir(step)
        tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)
        data_path = os.path.join(path, DATA_FILE)
        data = None
        if os.path.exists(data_path):
            with open(data_path) as f:
                data = json.load(f)
        return tree, data

    def restore(self, state_like: TrainState, step: Optional[int] = None,
                fallback: bool = True):
        """(state, data_state) at `step` (default: the latest), or (None,
        None) for an empty directory. `state_like` is the template: its
        leaves' shapes and dtypes must match (ValueError otherwise) and
        its device receives the leaves.

        Torn-final tolerance (`fallback`, only when `step` is None): a
        missing or unreadable NEWEST step falls back to the previous one,
        reported through `on_note(source="checkpoint",
        kind="restore_fallback", bad_step, landed_step, error)`. Exactly
        one step is ever skipped: a failure at the fallback step, an
        explicit `step`, or a single-step directory raises as itself."""
        tree, data = self.read(step, fallback)
        if tree is None:
            return None, None
        return self._state_from(tree, state_like), data

    def read(self, step: Optional[int] = None, fallback: bool = True):
        """(the step's full-shape CPU tree — `state.pt` as written —,
        data_state) at `step` (default: the latest, with `restore`'s
        torn-final fallback), or (None, None) for an empty directory."""
        explicit = step is not None
        steps = [step] if explicit else sorted(self.all_steps(),
                                               reverse=True)
        if not steps:
            return None, None
        for i, s in enumerate(steps):
            try:
                return self._read_step(s)
            except _UNREADABLE as exc:
                if explicit or not fallback or i > 0 or len(steps) == 1:
                    raise
                logger.warning(
                    "checkpoint at step %d in %s is unreadable (%s: %s) — "
                    "falling back to the previous retained step %d",
                    s, self.directory, type(exc).__name__, exc, steps[i + 1])
                self._note_restore_fallback(s, steps[i + 1], exc)
        raise AssertionError("unreachable: the loop returns or raises")

    def _state_from(self, tree: Dict[str, Any],
                    like: TrainState) -> TrainState:
        like_tree = state_tree(like)
        o = tree["opt_state"]
        _align_leaf_order(tree, like_tree)
        if like.layout is not None:
            # This rank's shards of the full-shape step, through the
            # template's layout (a tensor of another shape is left for
            # the check below to refuse).
            lay = like.layout
            full = tree_leaves(tree["params"])
            if [tuple(t.shape) for t in full] == lay.full_shapes:
                tree["params"] = _rebuild(tree["params"], [
                    lay.local_of(t, i) for i, t in enumerate(full)])
                for k in ("mu", "nu"):
                    o[k] = [lay.piece_of(lay.local_of(t, i), i)
                            for i, t in enumerate(o[k])]
        elif self._mesh is not None:
            # A ZeRO template: keep this rank's shard of each full moment.
            from proteinbert_tpu_torch.parallel.zero import shard_of

            for k in ("mu", "nu"):
                o[k] = [shard_of(t, tuple(v.shape), self._mesh.data_index,
                                 self._mesh.data_extent)
                        if torch.is_tensor(t) and t.dim() == v.dim() else t
                        for t, v in zip(o[k], like_tree["opt_state"][k])]
        _check_like(tree, like_tree, "")
        dev = tree_leaves(like.params)[0].device
        put = lambda t: t.to(dev)  # noqa: E731
        gen = torch.Generator(device=like.generator.device)
        gen.set_state(tree["generator"])
        return TrainState(
            int(tree["step"]), _map(tree["params"], put),
            OptState(int(o["count"]), _map(o["mu"], put),
                     _map(o["nu"], put), _map(o["plateau"], put)),
            gen, like.layout)

    def _note_restore_fallback(self, bad_step: int, landed_step: int,
                               exc: Exception) -> None:
        cb = self.on_note
        if cb is None:
            return
        try:
            cb(source="checkpoint", kind="restore_fallback",
               bad_step=int(bad_step), landed_step=int(landed_step),
               error=f"{type(exc).__name__}: {exc}")
        except Exception:
            logger.exception("checkpoint on_note hook failed — restore "
                             "path unaffected")

    # ------------------------------------------------------------ state

    def all_steps(self) -> List[int]:
        with self._lock:
            return list(self._steps)

    def latest_step(self) -> Optional[int]:
        with self._lock:
            return self._steps[-1] if self._steps else None

    def in_flight(self) -> bool:
        """True while a staged save or an async write is still running."""
        return bool(self.staged_in_flight() or (
            self._write is not None and not self._write.done()))

    def wait(self) -> None:
        """Block until the staged save and the async write land; their
        errors propagate from here."""
        self._settle()

    def close(self) -> None:
        """Land every save, stop the saver thread and release the staged
        snapshot's device buffers and pinned host twins."""
        try:
            self._settle()
        finally:
            self._saver.shutdown(wait=True)
            self._snap = self._pinned = self._side_stream = None
