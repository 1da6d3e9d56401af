"""Bucketed and ragged dispatch — port of `proteinbert_tpu/serve/
dispatch.py` (`InFlightBatch`, the fp32 and int8 arms of
`BucketDispatcher` and `RaggedDispatcher`, and their task heads).

Online traffic is ragged. Each request is routed to the smallest length
bucket that holds it (ascending, last == seq_len), and a micro-batch of
r rows is padded up to the smallest batch class ≥ r (powers of two up to
`max_batch` by default), so a 40-residue query does not pay full-seq_len
work and a row's numbers do not depend on the traffic around it.

Warm shapes. The JAX dispatcher keeps one warm jitted executable per
shape; its counterpart on the card is a CUDA graph (`WarmShape`). The
first batch of a (kind, bucket, batch class) — for ragged serving, of a
kind — runs once eagerly on a side stream (that builds and loads the
kernels, sets their attributes and settles the allocator), then is
captured into a `torch.cuda.CUDAGraph` over static input buffers; every
later batch of that shape copies its inputs into those buffers and
replays the graph. All graphs share one memory pool. On the int8 arm
`partial_dequantize_params` runs inside the graph, as the dequantize runs
inside the JAX executable. `warmup()` captures every shape up front;
a shape it did not cover is captured on its first batch, as JAX compiles
such a shape on first use. A capture or a replay that fails raises
`RuntimeError`; nothing reruns eagerly. On the CPU nothing is captured:
each batch is the eager call it always was.

The kernels count their launches in Python (`kernels/build.Kernel`), and
a replay runs no Python, so each graph records at capture which kernels
it launches and every replay credits them (`kernels/build.credit`).

Async dispatch. `run_timed_async` / `run_packed_timed_async` return an
`InFlightBatch` once the batch is enqueued: on the card the inputs go to
the shape's buffers from pinned staging, the graph is replayed, the
outputs start their copy into pinned host buffers owned by the batch,
and an event is recorded — all on the calling thread's current stream.
`finalize()` waits for the event, then trims and fans out on the host
and runs the parity shadow. The synchronous entries are submit plus
immediate finalize, so both give the same outputs bit for bit.

`run_rows` is the offline entry (`inference.embed(..., bucketed=True)`):
group a whole token matrix by bucket, run each group at its bucket
length, reassemble in input order.

`quant="int8"` / `"int8_act"` is the int8 serving arm (JAX dispatch.py:
228-282): the dispatcher quantizes the trunk once at load
(`parallel/quant.quantize_params`) and every batch runs the quantized
entries, whose block weights reach the int8 legs of #3, K2 and #6. With
`quant_parity_every <= 0` the fp32 trunk moves to the host, so the card
holds only the int8 tree; with N > 0 it stays on the card and every Nth
live batch also runs the fp32 entries eagerly on the same inputs (the
parity shadow, `quant_report["parity_max"]`).

Task heads (`TASK_KIND`, "predict_task"). A dispatcher holds registered
heads (`add_head`, `remove_head`, `get_head`, `list_heads`); a
`predict_task` batch carries one head a row (or a rider, ragged), and may
mix heads. The trunk is ONE graph per served shape shared by every head,
under the key ("trunk", L, batch class) that `trunk_executable_count`
counts (`heads/apply.trunk_batch` / `packed_trunk_batch`; on the int8 arm
`parallel/quant._q_trunk_batch` / `_q_packed_trunk_batch`). Right after
the trunk's replay, on the same stream, each distinct head's tail runs
eagerly over the graph's output buffers (`heads/apply.head_outputs`),
before the next replay can overwrite them; only the tails' float32
outputs are copied to the host. The tails run eagerly rather than as a
graph per head structure: they are one or two small denses, a graph each
would need a capture per (head structure × served shape) and a pool that
grows with every tenant, and hot-adding a head must capture nothing. So
adding or removing a head never captures a trunk graph; `warm_head` runs
a new head's tail once per warm trunk shape on zero inputs (no trunk
run) and records its seconds in `warmup_report["heads"]`.

Neighbour requests (`NEIGHBORS_KIND`, "neighbors") are embed requests to
both dispatchers: the kind is normalised on entry, so they share the
embed graphs and their launches (the index lookup is the server's).

Blue-green candidate arm (JAX dispatch.py:283-295, :510-713). A
candidate trunk of the resident's tree, shapes and dtypes loads beside
it (`load_candidate`, priced in device memory against
`hbm_budget_bytes` or the card's `total_memory`; `CandidateUnfitError`
when the two do not fit) into tensors of its own; on the int8 arm it is
quantized as the resident was, and its fp32 source waits on the host
when `quant_parity_every <= 0`. The candidate never gets a graph:
`warm_candidate` runs it eagerly once at every warm shape, and shadow
requests (`run_candidate`, `run_packed_candidate`) run it eagerly on a
stream of their own, so graphs and pool stay as they were. The graphs
bake the addresses of the resident's tensors into their kernels, so
`flip` cannot swap trees as the JAX dispatcher does: on the serving
stream, behind every batch already enqueued, it parks the resident
values in pinned host buffers, copies the candidate's values into the
resident's own tensors and frees the candidate. Batches enqueued before
the copy read the old trunk, batches after it the new one; every graph
stays valid. On the int8 arm the fp32 tree, which only eager code reads,
is swapped as in JAX. `rollback` copies the parked values back into the
same tensors (bit for bit the pre-flip numerics) and moves the demoted
trunk to the candidate slot. One lock (`_arm_lock`) covers every batch
from the read of its arm (`_arm_lanes`) to the end of its enqueue, so
a flip from another thread lands between two batches, never inside one.

Serving over a mesh (`mesh=`, a `parallel/mesh.ServeMesh`; JAX
dispatch.py:179-227, :1064-1108). The JAX dispatchers place each served
batch with its rows split over the joint (data, fsdp) replica axis and
the trunk replicated (`parallel/sharding.serve_batch_sharding`); the
port does the same by hand in one process, with one lane per replica
device (`mesh.replica_devices`). A lane holds its own copy of the
serving trunk (the int8 tree on the int8 arms), its own serving and
shadow streams, its own graph pool, its own head params and its own
`WarmShape`s at `class / data_extent` rows (ragged: `rows_per_batch /
data_extent`). A batch is padded and timed as a whole, split into
contiguous row slices, one a lane in replica order, each enqueued under
its lane's device and stream; the handle waits on every lane's event and
concatenates the host outputs in order, which is what fetching a
batch-sharded JAX array gives. Every class (ragged: `rows_per_batch`)
must divide by `data_extent` (JAX's message); the default ladder is
built on that multiple. Lanes replay concurrently, so each has its own
pool. The fp32 parity shadow runs the whole batch on the first lane,
where the fp32 trunk lives (the only copy, on the int8 arms). A
candidate is priced per device over every lane placed there and loaded
once a lane; `flip` and `rollback` act on every lane inside one hold of
`_arm_lock`, and a batch holds that lock over the enqueue of all of its
slices, so no batch is torn between arms across replicas.
`executable_count` keeps JAX's meaning (shapes, one a class); the graphs
across lanes are `graph_count`, their pools `graph_pool_bytes()`, both
by lane in `lane_report()`. Without a mesh there is one lane on `device`.

`metrics` (an obs `MetricsRegistry`) receives the JAX dispatcher's
`serve_executable_count`, `serve_warmup_seconds_total`,
`serve_compile_seconds` and `serve_quant_parity_max`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteinbert_tpu_torch import DeviceLike, resolve_device
from proteinbert_tpu_torch import inference
from proteinbert_tpu_torch.configs import PretrainConfig
from proteinbert_tpu_torch.data.vocab import EOS_ID, PAD_ID, SOS_ID
from proteinbert_tpu_torch.heads import apply as heads_apply
from proteinbert_tpu_torch.heads.registry import LoadedHead, UnknownHeadError
from proteinbert_tpu_torch.kernels.build import credit, recording_launches
from proteinbert_tpu_torch.kernels.path_counter import quiet
from proteinbert_tpu_torch.models.proteinbert import activation_dtype, to_device
from proteinbert_tpu_torch.parallel.quant import (
    SERVE_QUANT_MODES, _q_packed_trunk_batch, _q_trunk_batch, param_bytes,
    quant_entry, quant_packed_entry, quantize_params,
)
from proteinbert_tpu_torch.serve.errors import (
    CandidateUnfitError, NoCandidateError,
)

KINDS = ("embed", "predict_go", "predict_residues")
# Task-head requests: every head shares the kind, so a micro-batch mixes
# heads over one trunk graph (module doc).
TASK_KIND = "predict_task"
# Neighbour requests (`Server.neighbors`, `/v1/neighbors`): the same device
# work as "embed", so both dispatchers normalise the kind on entry and a
# neighbours batch replays the embed graph; the index lookup runs after,
# in the server's finalize.
NEIGHBORS_KIND = "neighbors"

_BATCH_FNS = {
    "embed": inference._encode_batch,
    "predict_go": inference._go_probs_batch,
    "predict_residues": inference._residue_probs_batch,
}

_PACKED_FNS = {
    "embed": inference._packed_encode_batch,
    "predict_go": inference._packed_go_probs_batch,
    "predict_residues": inference._packed_residue_probs_batch,
}

Rider = Tuple[int, int, int, int]  # (row, segment index, start, span)
Fetch = Callable[[], Any]


def _host_leaves(tree) -> List[np.ndarray]:
    """The arrays of a host output (a dict, list or array), in a fixed
    order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _host_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _host_leaves(v)]
    return [np.asarray(tree)]


def parity_max(a, b) -> float:
    """Max |a - b| over two host outputs of the same structure."""
    worst = 0.0
    for x, y in zip(_host_leaves(a), _host_leaves(b)):
        if x.size:
            worst = max(worst, float(np.max(np.abs(
                x.astype(np.float32) - y.astype(np.float32)))))
    return worst


def _device_hbm_bytes(device: torch.device) -> Optional[int]:
    """The card's memory in bytes (the candidate's budget when the caller
    gives none); None on the CPU, where only an explicit budget
    refuses."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a params tree in a fixed order, each once (an int8
    tree's block-vector scales are shared by several leaves)."""
    out: List[torch.Tensor] = []
    _collect(tree, out, set())
    return out


def _collect(tree, out: List[torch.Tensor], seen: set) -> None:
    # Module-level recursion: a recursive closure would hold `out` in a
    # reference cycle, keeping a dropped trunk's tensors alive until the
    # garbage collector runs.
    if isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], out, seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, out, seen)
    elif id(tree) not in seen:
        seen.add(id(tree))
        out.append(tree)


def _same_structure(a, b) -> bool:
    """Whether two params trees have the same keys, list lengths, shapes
    and dtypes."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return (isinstance(b, torch.Tensor) and a.shape == b.shape
            and a.dtype == b.dtype)


def _copy_tree(tree, copy: Callable[[torch.Tensor], torch.Tensor],
               done: Optional[Dict[int, torch.Tensor]] = None):
    """`tree` with every tensor replaced by `copy(tensor)`; a tensor that
    several leaves share stays shared (`done`: the copies so far)."""
    done = {} if done is None else done
    if isinstance(tree, dict):
        return {k: _copy_tree(v, copy, done) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v, copy, done) for v in tree)
    if id(tree) not in done:
        done[id(tree)] = copy(tree)
    return done[id(tree)]


def _own(tree, device: torch.device):
    """A copy of `tree` on `device` in tensors of its own (enqueued on the
    current stream; from pinned host memory it does not block)."""
    return _copy_tree(tree, lambda t: t.to(device, copy=True,
                                           non_blocking=True))


def _host_copy(tree):
    """A host copy of `tree`: from the card into pinned buffers, enqueued
    on the current stream (valid once it is synchronised); on the CPU a
    plain clone."""
    def copy(t):
        if t.device.type == "cpu":
            return t.clone()
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t, non_blocking=True)

    return _copy_tree(tree, copy)


def _copy_into(dst, src) -> None:
    """Every tensor of `src` into the same-place tensor of `dst`, in
    place (the addresses a graph holds stay), on the current stream."""
    dst, src = _tensors(dst), _tensors(src)
    if len(dst) != len(src) or any(d.shape != s.shape
                                   for d, s in zip(dst, src)):
        raise RuntimeError("trunk trees differ in tensors or shapes")
    for d, s in zip(dst, src):
        d.copy_(s, non_blocking=True)


def _map(fn, out):
    """`fn` over a batch function's output: a dict of tensors or one."""
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    return fn(out)


def resolve_buckets(cfg: PretrainConfig, buckets=None) -> Tuple[int, ...]:
    """Serving bucket boundaries: the explicit argument, else the
    config's training buckets (cfg.data.buckets), else the single
    full-length bucket. Ints, strictly ascending, last == seq_len."""
    if buckets is None:
        buckets = cfg.data.buckets or (cfg.data.seq_len,)
    try:
        buckets = tuple(int(b) for b in buckets)
    except (TypeError, ValueError):
        raise ValueError(f"buckets must be ints, got {buckets!r}") from None
    if not buckets or sorted(set(buckets)) != list(buckets):
        raise ValueError(f"buckets must be strictly ascending, got {buckets}")
    if buckets[-1] != cfg.data.seq_len:
        raise ValueError(f"last bucket {buckets[-1]} must equal "
                         f"data.seq_len {cfg.data.seq_len}")
    if buckets[0] < 3:
        raise ValueError(f"smallest bucket {buckets[0]} cannot hold "
                         "<sos> + one residue + <eos>")
    return buckets


def default_batch_classes(max_batch: int,
                          multiple: int = 1) -> Tuple[int, ...]:
    """Ascending power-of-two ladder capped by (and always containing)
    max_batch: 8 → (1, 2, 4, 8); 12 → (1, 2, 4, 8, 12). With
    `multiple` — a mesh's data*fsdp extent — every rung is a multiple
    of it so a served batch splits evenly across the replicas:
    (16, multiple=4) → (4, 8, 16)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    if max_batch % multiple:
        raise ValueError(
            f"max_batch {max_batch} is not divisible by the mesh's "
            f"data*fsdp extent {multiple} — pick a max_batch the mesh "
            "can split evenly over the batch dim")
    classes = []
    c = multiple
    while c < max_batch:
        classes.append(c)
        c *= 2
    classes.append(max_batch)
    return tuple(classes)


class InFlightBatch:
    """Handle for one asynchronously dispatched micro-batch (JAX
    dispatch.py:133). `run_*_async` returns one as soon as the batch is
    enqueued; everything that blocks (the wait for the device, the
    per-request fan-out, the quant parity shadow) lives in `finalize()`,
    which the scheduler's completer thread calls when it resolves the
    batch. The sync entries are submit + immediate finalize, so async and
    sync outputs are bit-identical by construction."""

    __slots__ = ("rows", "timings", "_fetch", "_result")

    def __init__(self, rows: int, timings: Dict, fetch):
        self.rows = rows
        self.timings = timings
        self._fetch = fetch
        self._result = None

    def finalize(self):
        """Block for the device result (host fetch + fan-out + parity
        shadow) and return (outputs, timings) — the exact pair the sync
        entry returns. Idempotent: a second call returns the first
        call's result."""
        if self._fetch is not None:
            out = self._fetch()
            self._result = (out, self.timings)
            self._fetch = None
        return self._result


class WarmShape:
    """One warm shape on the card: a CUDA graph captured over one call
    of a batch function (`fn(params, *inputs, cfg.model)`), the static
    device buffers its inputs are copied into, its output tensors, and
    the kernel launches one replay makes.

    Every tensor a kernel of the graph touches keeps its address across
    replays — the bf16 kernels bake TMA tensor maps of those addresses
    into their parameters at capture: the inputs are these buffers, the
    weights are the lane's, and the intermediates and per-call scratches
    come from the graph's pool. Replays of graphs that share a pool must
    not overlap; a lane's graphs share its pool and replay on one thread,
    each batch enqueued behind the last on the lane's one stream."""

    def __init__(self, fn: Callable, params, cfg: PretrainConfig,
                 arrays: Sequence[np.ndarray], device: torch.device,
                 pool, stream: torch.cuda.Stream):
        self.inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in arrays]
        # The eager warm run: it builds and loads the kernels and makes
        # their one-time CUDA runtime calls outside the capture. Its route
        # decisions are not counted: the capture's are.
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream), quiet():
            fn(params, *self.inputs, cfg.model)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with recording_launches() as recorded:
                # thread_local: a live server's completer thread keeps
                # waiting on events while the scheduler thread captures.
                with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.outputs = fn(params, *self.inputs, cfg.model)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture failed: {e}") from e
        self.launches = recorded

    def launch(self, arrays: Sequence[np.ndarray]):
        """Enqueue one batch on the current stream: `arrays` into the
        static buffers (from pinned staging, one per batch), then the
        replay. Returns the graph's output tensors: valid until the next
        replay of a graph of this pool, so read them on this stream
        before that."""
        for buf, a in zip(self.inputs, arrays):
            staged = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            buf.copy_(staged, non_blocking=True)
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError(f"CUDA graph replay failed: {e}") from e
        credit(self.launches)
        return self.outputs


def host_fetch(out) -> Fetch:
    """Start the copy of device outputs (a dict of tensors or one) into
    pinned host buffers the batch owns, on the current stream, and record
    an event. Returns the fetch that waits for the event and hands back
    host copies."""
    host = _map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, pin_memory=True).copy_(
            t, non_blocking=True), out)
    done = torch.cuda.Event()
    done.record()

    def fetch():
        done.synchronize()
        # Copies: a result the cache keeps must not pin the buffer.
        return _map(lambda t: t.numpy().copy(), host)

    return fetch


def _gather(parts: List[Any]):
    """The lanes' host outputs (each a dict of arrays or one) joined
    along the rows, in lane order."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


class _Lane:
    """One replica of a dispatcher: its device, the trunk its batches
    read (`serving`: the fp32 tree, or the int8 tree on the int8 arms;
    the same object for the dispatcher's life, since flips copy in
    place), its candidate (`cand`, same kind), the live batches' stream
    and the shadow stream, and its warm shapes with their pool."""

    def __init__(self, index: int, device: torch.device, serving):
        self.index = index
        self.device = device
        self.serving = serving
        self.cand = None       # under the dispatcher's _arm_lock
        self.stream = self.shadow_stream = None
        if device.type == "cuda":
            # Lane 0 enqueues on the constructing thread's current stream
            # (a dispatcher without a mesh, as before); the others on
            # streams of their own, so the lanes' replays overlap.
            self.stream = (torch.cuda.current_stream(device) if index == 0
                           else torch.cuda.Stream(device))
            self.shadow_stream = torch.cuda.Stream(device)
        # Captured graphs by (kind, L, batch class), each at this lane's
        # share of the class's rows. Added by the thread that dispatches,
        # read by stats() from client threads (under _warm_lock).
        self.graphs: Dict[Tuple[str, int, int], WarmShape] = {}
        self.pool = None             # the lane's graphs' shared pool
        self.capture_stream = None

    @contextlib.contextmanager
    def on(self, stream=None):
        """This lane's device current (and `stream`, when given)."""
        if self.device.type != "cuda":
            yield
            return
        with torch.cuda.device(self.device), (
                contextlib.nullcontext() if stream is None
                else torch.cuda.stream(stream)):
            yield

    def sync(self) -> None:
        """Wait for this thread's current stream on the lane's device."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()


class BucketDispatcher:
    """Routes (kind, tokens, annotations) micro-batches to their warm
    shape on `device` (None → "cuda") — or, with `mesh`, split over one
    lane per replica device of the mesh — and returns trimmed host
    outputs. `quant` picks the arm (`SERVE_QUANT_MODES`)."""

    def __init__(
        self,
        params,
        cfg: PretrainConfig,
        buckets: Optional[Sequence[int]] = None,
        max_batch: int = 8,
        batch_classes: Optional[Sequence[int]] = None,
        device: DeviceLike = None,
        metrics=None,
        quant: str = "fp32",
        quant_parity_every: int = 0,
        mesh=None,
    ):
        if quant not in SERVE_QUANT_MODES:
            raise ValueError(f"quant must be one of {SERVE_QUANT_MODES}, "
                             f"got {quant!r}")
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        if mesh is None:
            lane_devices = [resolve_device(device)]
        else:
            lane_devices = list(mesh.replica_devices)
            if (device is not None and resolve_device(device).type
                    != lane_devices[0].type):
                raise ValueError(
                    f"device {device} is not the mesh's device type "
                    f"({lane_devices[0].type}): with a mesh the lanes run "
                    "on its replica devices")
        self.device = lane_devices[0]
        divisor = len(lane_devices)
        self.buckets = resolve_buckets(cfg, buckets)
        self.max_batch = int(max_batch)
        if batch_classes is None:
            # Mesh-aware default: every rung divisible by the replica
            # count, so `serve --mesh` works out of the box.
            batch_classes = default_batch_classes(self.max_batch, divisor)
        self.batch_classes = tuple(sorted(int(c) for c in set(batch_classes)))
        if self.batch_classes[-1] < self.max_batch:
            raise ValueError(
                f"largest batch class {self.batch_classes[-1]} cannot hold "
                f"a full micro-batch of {self.max_batch}")
        bad = [c for c in self.batch_classes if c % divisor]
        if bad:
            raise ValueError(
                f"batch classes {bad} are not divisible by the mesh's "
                f"data*fsdp extent {divisor} — a served batch shards "
                "over the batch dim, so every compiled class must "
                "split evenly across the replicas")
        if mesh is not None:
            self.params = to_device(self.params, self.device)
        self.quant = quant
        self.quant_parity_every = int(quant_parity_every)
        # True while warmup() runs its dummy batches: they neither consume
        # the parity cadence nor count as parity samples.
        self._warming = False
        self._quant_batches = 0
        self.qparams = None
        self.quant_report: Dict = {}
        self.quant_parity_max: Optional[float] = None
        self._quant_parity_g = (
            metrics.gauge("serve_quant_parity_max")
            if metrics is not None and quant != "fp32" else None)
        if quant != "fp32":
            fp32_bytes = param_bytes(self.params)
            self.qparams = quantize_params(self.params)
            q_bytes = param_bytes(self.qparams)
            if self.quant_parity_every <= 0:
                # No parity shadow: nothing on the card reads the fp32
                # trunk, so it waits on the host.
                self.params = to_device(self.params, torch.device("cpu"))
            self.quant_report = {
                "mode": quant,
                "weight_bytes_fp32": fp32_bytes,
                "weight_bytes_quant": q_bytes,
                "weight_bytes_ratio": round(q_bytes / max(fp32_bytes, 1), 4),
                "parity_every": self.quant_parity_every,
                "fp32_resident": ("device" if self.quant_parity_every > 0
                                  else "host"),
            }
            if mesh is not None:
                # The weight bytes above are one lane's; every lane holds
                # them, the fp32 shadow tree only the first.
                self.quant_report["lanes"] = len(lane_devices)
        # One lane a replica: lane 0 serves the tree it was given, every
        # other lane a copy of its own (the graphs bake its addresses).
        serving = self.qparams if quant != "fp32" else self.params
        self._lanes: List[_Lane] = []
        for i, dev in enumerate(lane_devices):
            lane = _Lane(i, dev, serving)
            if i:
                with lane.on():
                    lane.serving = _own(serving, dev)
            self._lanes.append(lane)
        # The blue-green candidate arm: `cand_*` serve shadow requests
        # until flip() copies them into the resident tensors; the values
        # flip() replaced wait on the host (`parked_*`) for rollback().
        # Every batch holds _arm_lock from the read of its arm to the end
        # of its enqueue (`_arm_lanes`).
        self._arm_lock = threading.Lock()
        self.cand_params = None  # guarded-by: _arm_lock
        self.cand_qparams = None  # guarded-by: _arm_lock
        self.parked_params = None  # guarded-by: _arm_lock
        self.parked_qparams = None  # guarded-by: _arm_lock
        self.candidate_report: Dict = {}  # guarded-by: _arm_lock
        self._compile_hist = (metrics.histogram("serve_compile_seconds")
                              if metrics is not None else None)
        self._exec_g = (metrics.gauge("serve_executable_count")
                        if metrics is not None else None)
        self._warmup_g = (metrics.gauge("serve_warmup_seconds_total")
                          if metrics is not None else None)
        self.warmup_seconds_total = 0.0
        # Guards every lane's `graphs` and `_counted`.
        self._warm_lock = threading.Lock()
        # The shape keys whose kernel route decisions have been counted.
        self._counted: set = set()
        # Registered heads: head_id -> LoadedHead with its params on the
        # first lane's device; `_head_lanes` keeps (those params, their
        # copy on each lane). Requests keep the head they were admitted
        # with, so a removal drains queued work.
        self.heads: Dict[str, LoadedHead] = {}
        self._head_lanes: Dict[str, Tuple[Any, List[Any]]] = {}
        self._heads_lock = threading.Lock()
        self.warmup_report: Dict = {"trunk_executables": 0,
                                    "trunk_s": 0.0, "heads": {}}
        if len(self._lanes) > 1:
            self._sync()  # the lanes' copies, before their own streams

    # ------------------------------------------------------------ routing

    def bucket_len(self, seq_len_residues: int) -> int:
        """Smallest bucket holding a sequence of this many residues
        (tokenized length = residues + <sos> + <eos>, capped at the
        model window like tokenization caps it)."""
        tok_len = min(seq_len_residues + 2, self.cfg.data.seq_len)
        i = int(np.searchsorted(self.buckets, tok_len))
        return self.buckets[i]

    def batch_class(self, rows: int) -> int:
        """Smallest batch class that fits `rows`."""
        for c in self.batch_classes:
            if c >= rows:
                return c
        raise ValueError(f"{rows} rows exceed the largest batch class "
                         f"{self.batch_classes[-1]}")

    def _dummy_batch(self, L: int, cls: int):
        tokens = np.full((cls, L), PAD_ID, np.int32)
        tokens[:, 0] = SOS_ID
        tokens[:, 1] = EOS_ID
        return tokens

    # ------------------------------------------------------ head registry

    def add_head(self, head: LoadedHead, warm: bool = False) -> float:
        """Register a head for predict_task: its params go to every
        lane's device once, as float32 tensors. With `warm` (a live
        server) its tail runs once per warm trunk shape (`warm_head`);
        returns those seconds. No trunk graph is captured."""
        placed = [heads_apply.head_params_on(head.params, lane.device)
                  for lane in self._lanes]
        head = LoadedHead(head_id=head.head_id, name=head.name,
                          task=head.task, params=placed[0], meta=head.meta)
        if len(self._lanes) > 1:
            self._sync()
        with self._heads_lock:
            self.heads[head.head_id] = head
            self._head_lanes[head.head_id] = (placed[0], placed)
        return self.warm_head(head) if warm else 0.0

    def remove_head(self, head_id: str) -> LoadedHead:
        """Unregister a head; UnknownHeadError if absent. New submits for
        it are refused; admitted requests hold their own reference and
        complete."""
        with self._heads_lock:
            self._head_lanes.pop(head_id, None)
            try:
                return self.heads.pop(head_id)
            except KeyError:
                raise UnknownHeadError(
                    f"no head {head_id!r} is registered on this "
                    "server") from None

    def get_head(self, head_id: str) -> LoadedHead:
        with self._heads_lock:
            try:
                return self.heads[head_id]
            except KeyError:
                raise UnknownHeadError(
                    f"no head {head_id!r} is registered on this server; "
                    f"have {sorted(self.heads)}") from None

    def list_heads(self) -> List[Dict]:
        with self._heads_lock:
            return [{"head_id": h.head_id, "name": h.name,
                     "kind": h.task.kind,
                     "num_outputs": h.task.num_outputs}
                    for h in self.heads.values()]

    def _lane_heads(self, heads: Sequence[LoadedHead],
                    lane: int) -> Sequence[LoadedHead]:
        """`heads` with each registered head's params swapped for its
        copy on lane `lane` (a head admitted before a removal keeps the
        params it came with)."""
        if lane == 0:
            return heads
        with self._heads_lock:
            placed = dict(self._head_lanes)
        swapped: Dict[str, LoadedHead] = {}
        out = []
        for h in heads:
            if h.head_id not in swapped:
                entry = placed.get(h.head_id)
                swapped[h.head_id] = (
                    dataclasses.replace(h, params=entry[1][lane])
                    if entry is not None and entry[0] is h.params else h)
            out.append(swapped[h.head_id])
        return out

    def _trunk_shapes(self) -> List[Tuple[int, int]]:
        """(L, rows) of every warm trunk graph (rows: the whole class)."""
        with self._warm_lock:
            return sorted({(k[1], k[2]) for k in self._lanes[0].graphs
                           if k[0] == "trunk"})

    def _split(self, arrays: Sequence[np.ndarray]) -> List[Tuple]:
        """Host batch arrays → one contiguous row slice a lane, in lane
        order (`serve_batch_sharding`: rows over the replicas)."""
        n = len(self._lanes)
        if n == 1:
            return [tuple(arrays)]
        per = arrays[0].shape[0] // n
        return [tuple(a[i * per:(i + 1) * per] for a in arrays)
                for i in range(n)]

    def _zero_trunk_out(self, L: int, rows: int,
                        dev: torch.device) -> Dict[str, torch.Tensor]:
        """Zeros shaped as a bucketed trunk output."""
        m = self.cfg.model
        dtype = activation_dtype(m)
        return {"local": torch.zeros((rows, L, m.local_dim), dtype=dtype,
                                     device=dev),
                "global": torch.zeros((rows, m.global_dim), dtype=dtype,
                                      device=dev),
                "pad_mask": torch.zeros((rows, L), dtype=torch.bool,
                                        device=dev)}

    def _head_tails(self, trunk_out, heads):
        return heads_apply.head_outputs(trunk_out, heads)

    def warm_head(self, head: LoadedHead) -> float:
        """Run one head's tail once per warm trunk shape, on zeros shaped
        as the trunk's outputs (no trunk run, nothing captured); returns
        the seconds, also recorded in `warmup_report["heads"]`."""
        total = 0.0
        n = len(self._lanes)
        for L, rows in self._trunk_shapes():
            t0 = time.perf_counter()
            for lane in self._lanes:
                with lane.on():
                    self._head_tails(
                        self._zero_trunk_out(L, rows // n, lane.device),
                        self._lane_heads([head], lane.index))
            self._sync()
            total += time.perf_counter() - t0
        self.warmup_report["heads"][head.head_id] = round(total, 6)
        return total

    # -------------------------------------------------------- warm shapes

    @property
    def trunk_executable_count(self) -> int:
        """Warm shared-trunk shapes — the number that stays flat across
        head add and remove (0 on the CPU, where nothing is captured)."""
        with self._warm_lock:
            return sum(1 for k in self._lanes[0].graphs if k[0] == "trunk")

    @property
    def executable_count(self) -> int:
        """Warm shapes — the JAX dispatcher's warm executables, one a
        shape whatever the lanes (0 on the CPU, where nothing is
        captured)."""
        with self._warm_lock:
            return len(self._lanes[0].graphs)

    @property
    def graph_count(self) -> int:
        """Captured CUDA graphs across the lanes (a shape's graph on each
        lane)."""
        with self._warm_lock:
            return sum(len(lane.graphs) for lane in self._lanes)

    def _pool_bytes(self) -> List[int]:
        """Device bytes each lane's graph pool holds: its segments in the
        caching allocator's snapshot (0 before the lane's first
        capture)."""
        pools = [None if lane.pool is None else tuple(lane.pool)
                 for lane in self._lanes]
        if all(p is None for p in pools):
            return [0] * len(pools)
        sizes = {p: 0 for p in pools if p is not None}
        for seg in torch.cuda.memory_snapshot():
            pool = tuple(seg.get("segment_pool_id", ()))
            if pool in sizes:
                sizes[pool] += seg["total_size"]
        return [0 if p is None else sizes[p] for p in pools]

    def graph_pool_bytes(self) -> int:
        """Device bytes the lanes' graph pools hold, summed."""
        return sum(self._pool_bytes())

    def lane_report(self) -> List[Dict[str, Any]]:
        """Each lane's device, captured graphs and pool bytes."""
        pools = self._pool_bytes()
        with self._warm_lock:
            return [{"device": str(lane.device), "graphs": len(lane.graphs),
                     "pool_bytes": pool}
                    for lane, pool in zip(self._lanes, pools)]

    def _warm_shape(self, lane: _Lane, key, fn, params,
                    arrays: Sequence[np.ndarray]) -> WarmShape:
        """The lane's graph of `key`, captured now on `arrays` (the
        lane's slice) if it is new."""
        with self._warm_lock:
            warm = lane.graphs.get(key)
        if warm is not None:
            return warm
        if lane.pool is None:
            lane.pool = torch.cuda.graph_pool_handle()
            lane.capture_stream = torch.cuda.Stream(lane.device)
        warm = WarmShape(fn, params, self.cfg, arrays, lane.device,
                         lane.pool, lane.capture_stream)
        with self._warm_lock:
            lane.graphs[key] = warm
            n = len(self._lanes[0].graphs)
        if self._exec_g is not None:
            self._exec_g.set(n)
        return warm

    def _count_once(self, key) -> bool:
        """True the first time `key` runs on this dispatcher (a served
        shape's route decisions count once, as a JAX executable's do at
        its trace); False for None (the candidate's warm runs: the same
        shapes)."""
        if key is None:
            return False
        with self._warm_lock:
            if key in self._counted:
                return False
            self._counted.add(key)
            return True

    def _device_out(self, lane: _Lane, key, fn, params,
                    arrays: Sequence[np.ndarray], eager: bool = False):
        """`fn` on host `arrays` → its outputs on the lane's device: on
        the card a replay of the lane's graph of the shape (captured now
        if new), on the CPU — or with `eager` (the candidate arm) — the
        eager call, its inputs staged through pinned memory on the
        card. Route decisions count on the shape's first run only."""
        with (contextlib.nullcontext() if self._count_once(key)
              else quiet()):
            if lane.device.type == "cpu":
                return fn(params, *(
                    torch.from_numpy(np.ascontiguousarray(a))
                    for a in arrays), self.cfg.model)
            if eager:
                return fn(params, *(
                    torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                    .to(lane.device, non_blocking=True) for a in arrays),
                    self.cfg.model)
            return self._warm_shape(lane, key, fn, params,
                                    arrays).launch(arrays)

    def _submit(self, key, fn, runs: Sequence[Any], streams: Sequence[Any],
                arrays: Sequence[np.ndarray],
                tail: Optional[Callable] = None,
                eager: bool = False) -> Fetch:
        """Start `fn` on host `arrays`, a row slice on each lane (its
        params `runs[i]`, on its stream `streams[i]`) → the fetch of the
        lanes' host outputs joined in order (on the CPU already done).
        `tail(out, lane)` (the head tails) maps a lane's device outputs
        to what is fetched, on the same stream right after."""
        fetches = []
        for lane, params, stream, part in zip(self._lanes, runs, streams,
                                              self._split(arrays)):
            with lane.on(stream):
                out = self._device_out(lane, key, fn, params, part, eager)
                if tail is not None:
                    out = tail(out, lane.index)
                if lane.device.type == "cpu":
                    host = _map(lambda t: t.numpy(), out)
                    fetches.append(lambda host=host: host)
                else:
                    fetches.append(host_fetch(out))
        if len(fetches) == 1:
            return fetches[0]
        return lambda: _gather([f() for f in fetches])

    def _sync(self) -> None:
        """Wait for this thread's stream on every lane's device (not the
        device: a live server's scheduler may be capturing on another
        stream meanwhile)."""
        for lane in self._lanes:
            lane.sync()

    def _warm_trunk(self, key, fn, arrays: Sequence[np.ndarray]) -> int:
        """Warm the shared trunk at one shape (capture its graph on the
        card; on the CPU run it) and run every registered head's tail on
        its output, timing each into `warmup_report`; returns 1 if the
        trunk shape was new. A shape already captured is not replayed:
        the tails warm on zeros of its output shapes."""
        report = self.warmup_report
        with self._heads_lock:
            heads = list(self.heads.values())
        with self._warm_lock:
            new = key not in self._lanes[0].graphs
        lanes = self._lanes
        if new:
            t0 = time.perf_counter()
            outs = []
            with self._arm_lanes() as (runs, _, streams):
                for lane, params, stream, part in zip(
                        lanes, runs, streams, self._split(arrays)):
                    with lane.on(stream):
                        outs.append(self._device_out(lane, key, fn, params,
                                                     part))
                        lane.sync()
            dt = time.perf_counter() - t0
            report["trunk_executables"] += 1
            report["trunk_s"] = round(report["trunk_s"] + dt, 6)
            if self._compile_hist is not None:
                self._compile_hist.observe(dt)
        else:
            outs = [self._zero_trunk_out(key[1], key[2] // len(lanes),
                                         lane.device) for lane in lanes]
        for head in heads:
            t0 = time.perf_counter()
            for lane, out in zip(lanes, outs):
                with lane.on():
                    self._head_tails(out, self._lane_heads([head],
                                                           lane.index))
            self._sync()
            report["heads"][head.head_id] = round(
                report["heads"].get(head.head_id, 0.0)
                + time.perf_counter() - t0, 6)
        return int(new)

    def _note_warmup_seconds(self, seconds: float) -> None:
        self.warmup_seconds_total += seconds
        if self._warmup_g is not None:
            self._warmup_g.set(round(self.warmup_seconds_total, 6))

    def _timed_warm(self, run: Callable[[], Any]) -> None:
        if self._compile_hist is None:
            run()
            return
        t0 = time.perf_counter()
        run()
        self._compile_hist.observe(time.perf_counter() - t0)

    # ----------------------------------------------------------- execution

    def _fn(self, kind: str, quantized: bool):
        """The batch function of one request kind on the quantized arm or
        the fp32 one."""
        if kind not in _BATCH_FNS:
            raise ValueError(f"unknown request kind {kind!r}; have {KINDS}")
        if quantized:
            return quant_entry(kind, act=self.quant == "int8_act")
        return _BATCH_FNS[kind]

    @property
    def _quantized(self) -> bool:
        """Whether batches run the int8 entries."""
        return self.quant != "fp32"

    @contextlib.contextmanager
    def _arm_lanes(self, arm: str = "resident"):
        """Hold `_arm_lock` and yield (the params each lane's batches of
        `arm` run on, the fp32 reference params, each lane's stream for
        `arm`) — the resident arm's, or the candidate's
        (NoCandidateError when none is loaded); the streams are the live
        batches' or the shadow streams. The caller enqueues every lane's
        slice of its batch inside, so a flip lands before or after the
        whole batch, never inside it or between two of its lanes."""
        with self._arm_lock:
            if arm == "resident":
                runs = [lane.serving for lane in self._lanes]
                ref = self.params
                streams = [lane.stream for lane in self._lanes]
            elif arm == "candidate":
                if self.cand_params is None:
                    raise NoCandidateError(
                        "no candidate trunk is loaded on this replica "
                        "(load one with Server.load_candidate / "
                        "POST /v1/rollout/load)")
                runs = [lane.cand for lane in self._lanes]
                ref = self.cand_params
                streams = [lane.shadow_stream for lane in self._lanes]
            else:
                raise ValueError(f"unknown arm {arm!r}; have "
                                 "('resident', 'candidate')")
            yield runs, ref, streams

    @contextlib.contextmanager
    def _arm_snapshot(self, arm: str = "resident"):
        """`_arm_lanes` for the first lane: yield (the params its batches
        of `arm` run on, the fp32 reference params) with its device and
        stream for `arm` current."""
        with self._arm_lanes(arm) as (runs, ref, streams):
            with self._lanes[0].on(streams[0]):
                yield runs[0], ref

    def _eager(self, fn, params, arrays: Sequence[np.ndarray]):
        """`fn` on `params` (the fp32 reference), eagerly, on host
        `arrays` → its device outputs (the parity shadow, a yardstick:
        its route decisions are not counted)."""
        with quiet():
            return fn(params, *(torch.from_numpy(np.ascontiguousarray(a))
                                .to(self.device) for a in arrays),
                      self.cfg.model)

    @staticmethod
    def _trunk_fn(quantized: bool):
        """The shared predict_task trunk: the int8 arm's on quantized
        weights (weight-only on both int8 modes; the tails that read it
        stay float32)."""
        return _q_trunk_batch if quantized else heads_apply.trunk_batch

    def _quant_batch_tick(self, timings: Dict) -> bool:
        """Per-batch quant bookkeeping: stamp the arm onto the timings,
        count the batch, and say whether THIS batch runs the fp32 parity
        shadow. Warmup batches are left out entirely."""
        if self.quant == "fp32" or self._warming:
            return False
        timings["quant"] = self.quant
        self._quant_batches += 1
        return (self.quant_parity_every > 0
                and (self._quant_batches - 1) % self.quant_parity_every == 0)

    def _shadow_parity(self, out, ref_thunk, timings: Dict) -> None:
        """Run the fp32 shadow (`ref_thunk`) and record the worst
        deviation of `out` from it."""
        worst = parity_max(out, ref_thunk())
        self.quant_parity_max = max(self.quant_parity_max or 0.0, worst)
        self.quant_report["parity_max"] = round(self.quant_parity_max, 9)
        self.quant_report["parity_samples"] = (
            self.quant_report.get("parity_samples", 0) + 1)
        if self._quant_parity_g is not None:
            self._quant_parity_g.set(round(self.quant_parity_max, 9))
        timings["quant_parity_max"] = round(worst, 9)

    def _tails(self, heads: Optional[Sequence[LoadedHead]]):
        """The per-lane head tails of a predict_task batch (None for the
        other kinds): one trunk graph for a (possibly mixed-head) batch,
        then each distinct head's tail over the lane's rows, with the
        head's params on that lane; each row keeps its own head's
        output."""
        if heads is None:
            return None
        return lambda out, lane: self._head_tails(
            out, self._lane_heads(heads, lane))

    @staticmethod
    def _finalizer(fetch: Fetch, timings: Dict, t1: float,
                   timed: bool) -> Fetch:
        """`fetch` stamping device_s (enqueued → outputs on host) and
        finalize_s (the wait inside finalize) when `timed`."""
        def finalize_fetch():
            tf = time.perf_counter()
            out = fetch()
            if timed:
                now = time.perf_counter()
                timings["device_s"] = round(now - t1, 9)
                timings["finalize_s"] = round(now - tf, 9)
            return out

        return finalize_fetch

    def run(self, kind: str, tokens: np.ndarray,
            annotations: Optional[np.ndarray] = None,
            heads: Optional[Sequence[LoadedHead]] = None):
        """Run one micro-batch: tokens (r, L) with L a bucket length,
        annotations (r, A) or None. Rows are padded up to the batch
        class; outputs come back trimmed to r on host —
        {"global", "local_mean"} for "embed", (r, A) probs for
        "predict_go", (r, L, V) probs for "predict_residues". For
        "predict_task", `heads` carries row i's head and the result is a
        list of r float32 head outputs (shaped by each head's kind)."""
        result, _ = self.run_timed(kind, tokens, annotations, timed=False,
                                   heads=heads)
        return result

    def run_timed(self, kind: str, tokens: np.ndarray,
                  annotations: Optional[np.ndarray] = None,
                  timed: bool = True,
                  heads: Optional[Sequence[LoadedHead]] = None):
        """`run()` that also returns {"prep_s": padding, "device_s":
        enqueue through host fetch, "finalize_s": the host-fetch share of
        device_s, "pad_fraction": padding share of the (batch_class, L)
        grid} when `timed` — submit + immediate finalize of the async
        entry."""
        return self.run_timed_async(kind, tokens, annotations, timed=timed,
                                    heads=heads).finalize()

    def run_timed_async(self, kind: str, tokens: np.ndarray,
                        annotations: Optional[np.ndarray] = None,
                        timed: bool = True,
                        heads: Optional[Sequence[LoadedHead]] = None,
                        arm: str = "resident") -> InFlightBatch:
        """Submit one micro-batch and return an `InFlightBatch` as soon
        as it is enqueued. Validation, padding, the replay and (for
        predict_task) the head tails are enqueued here on the calling
        (scheduler) thread; the wait for the device, the trim and the
        parity shadow run in the handle's `finalize()`. `arm` picks the
        trunk: "resident" (the live arm, a graph replay on the card) or
        "candidate" (the shadow arm, eager on the shadow stream, outside
        the parity cadence)."""
        if kind == NEIGHBORS_KIND:
            kind = "embed"  # identical device work, shared graph
        if (kind == TASK_KIND) != (heads is not None):
            raise ValueError(
                f"kind {kind!r} and heads="
                f"{'set' if heads is not None else 'None'} do not agree: "
                "predict_task batches carry per-row heads, the other "
                "kinds never do")
        quantized = self._quantized
        fn = (self._trunk_fn(quantized) if heads is not None
              else self._fn(kind, quantized))
        rows, L = tokens.shape
        if L not in self.buckets:
            raise ValueError(f"tokens length {L} is not one of the "
                             f"buckets {self.buckets}")
        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        annotations = inference.check_annotations(annotations, rows,
                                                  self.cfg)
        cls = self.batch_class(rows)
        if timed:
            real = int((tokens != PAD_ID).sum())
            timings["pad_fraction"] = round(1.0 - real / (cls * L), 6)
        if rows < cls:
            tokens = np.pad(tokens, ((0, cls - rows), (0, 0)))
            annotations = np.pad(annotations, ((0, cls - rows), (0, 0)))
        t1 = time.perf_counter()
        if timed:
            timings["prep_s"] = round(t1 - t0, 9)
        eager = arm == "candidate"
        parity_due = not eager and self._quant_batch_tick(timings)
        key = ("trunk" if heads is not None else kind, L, cls)
        with self._arm_lanes(arm) as (runs, ref_params, streams):
            pending = self._submit(key, fn, runs, streams,
                                   (tokens, annotations),
                                   tail=self._tails(heads), eager=eager)
        if heads is not None:
            def trimmed(outs):
                return heads_apply.rows_of(outs, heads)

            def reference():
                return heads_apply.apply_heads(self._eager(
                    heads_apply.trunk_batch, ref_params,
                    (tokens, annotations)), heads)
        else:
            def trimmed(out):
                if isinstance(out, dict):
                    return {k: v[:rows] for k, v in out.items()}
                return out[:rows]

            def reference():
                return trimmed(inference.run_batch(
                    self._fn(kind, False), ref_params, self.cfg, tokens,
                    annotations, device=self.device))

        def fetch():
            out = trimmed(pending())
            if parity_due:
                self._shadow_parity(out, reference, timings)
            return out

        return InFlightBatch(rows, timings,
                             self._finalizer(fetch, timings, t1, timed))

    def warmup(self, kinds: Sequence[str] = ("embed",)) -> int:
        """Capture every (bucket_len, batch_class) shape of `kinds` on
        dummy rows (on the CPU: run each once); returns how many shapes
        ran. The others are captured on first use. With "predict_task"
        in `kinds`, or any head registered, the shared trunk is warmed at
        every shape and each head's tail run on it (`warmup_report`)."""
        t0 = time.perf_counter()
        n = 0
        self._warming = True
        try:
            for kind in kinds:
                if kind == TASK_KIND:
                    continue
                if kind not in KINDS:
                    raise ValueError(f"unknown request kind {kind!r}; "
                                     f"have {KINDS + (TASK_KIND,)}")
                for L in self.buckets:
                    for cls in self.batch_classes:
                        with self._warm_lock:
                            if (kind, L, cls) in self._lanes[0].graphs:
                                continue
                        dummy = self._dummy_batch(L, cls)
                        self._timed_warm(lambda: self.run(kind, dummy))
                        n += 1
            if TASK_KIND in kinds or self.heads:
                n += self._warmup_task()
        finally:
            self._warming = False
        self._note_warmup_seconds(time.perf_counter() - t0)
        return n

    def _warmup_task(self) -> int:
        """The shared trunk at every (bucket_len, batch_class) and each
        registered head's tail on it; returns the new trunk shapes."""
        fn = self._trunk_fn(self._quantized)
        A = self.cfg.model.num_annotations
        n = 0
        for L in self.buckets:
            for cls in self.batch_classes:
                n += self._warm_trunk(
                    ("trunk", L, cls), fn,
                    (self._dummy_batch(L, cls),
                     np.zeros((cls, A), np.float32)))
        return n

    # ------------------------------------------------ blue-green arms

    def _key_fn(self, kind: str, quantized: bool):
        """The batch function of a warm shape's kind."""
        return (self._trunk_fn(quantized) if kind == "trunk"
                else self._fn(kind, quantized))

    def _key_inputs(self, L: int, rows: int):
        """Dummy host inputs of a warm shape."""
        return (self._dummy_batch(L, rows),
                np.zeros((rows, self.cfg.model.num_annotations), np.float32))

    def load_candidate(self, params,
                       hbm_budget_bytes: Optional[int] = None) -> Dict:
        """Load a candidate trunk beside the resident one into tensors of
        its own on every lane. It must match the resident trunk's tree,
        shapes and dtypes (ValueError otherwise): its values will be
        copied into the tensors the graphs read. On the int8 arm it is
        quantized on the first lane as the resident was (each other lane
        gets a copy of that int8 tree), and its fp32 source waits on the
        host when `quant_parity_every <= 0`.

        Priced before anything is placed, on each device over every lane
        placed there (two lanes on one card count twice): the device
        bytes of both arms (the weights; `candidate_status()` reports
        the graph pools beside them) against `hbm_budget_bytes`, else the
        card's memory, else (CPU) nothing; `CandidateUnfitError` when
        they do not fit. The candidate's bytes are the resident's: the
        same tree. Returns the candidate report (also kept for
        candidate_status()); its bytes are summed over the devices."""
        if not _same_structure(self.params, params):
            raise ValueError(
                "candidate trunk does not match the resident trunk's "
                "parameter structure/shapes/dtypes — only a structurally "
                "identical trunk can take the resident's place in the "
                "warm graphs")
        lanes = self._lanes
        per_lane = param_bytes(lanes[0].serving)
        by_device: Dict[str, int] = {}
        for lane in lanes:
            key = str(lane.device)
            by_device[key] = by_device.get(key, 0) + per_lane
        if self._quantized and self.quant_parity_every > 0:
            # The fp32 shadow tree, on the first lane only.
            by_device[str(lanes[0].device)] += param_bytes(self.params)
        budget = None
        for dev, res_dev in by_device.items():
            cand_dev = res_dev
            dev_budget = (hbm_budget_bytes if hbm_budget_bytes is not None
                          else _device_hbm_bytes(torch.device(dev)))
            if budget is None:
                budget = dev_budget
            if dev_budget is not None and res_dev + cand_dev > dev_budget:
                raise CandidateUnfitError(
                    f"candidate trunk needs {cand_dev} device bytes beside "
                    f"the resident arm's {res_dev} ({res_dev + cand_dev} "
                    f"total > device memory budget {dev_budget}) — serve "
                    "quant='int8' (~0.27x resident bytes) to buy the "
                    "headroom, or raise the budget")
        res_total = sum(by_device.values())
        with lanes[0].on():
            placed = _own(params, lanes[0].device)
        if self._quantized:
            with lanes[0].on():
                trees = [quantize_params(placed)]
            if self.quant_parity_every <= 0:
                # No parity shadow reads it: the fp32 source waits on the
                # host, as the resident's does.
                placed = _copy_tree(placed, lambda t: t.cpu())
        else:
            trees = [placed]
        for lane in lanes[1:]:
            with lane.on():
                trees.append(_own(trees[0], lane.device))
        self._sync()
        report = {
            "quant": self.quant,
            "weight_bytes_resident": int(res_total),
            "weight_bytes_candidate": int(res_total),
            "hbm_budget_bytes": budget,
        }
        with self._arm_lock:
            released = ([lane.cand for lane in lanes], self.cand_params)
            for lane, tree in zip(lanes, trees):
                lane.cand = tree
            self.cand_params = placed
            self.cand_qparams = trees[0] if self._quantized else None
            self.candidate_report = dict(report)
        self._drain_shadows()
        del released
        return report

    def warm_candidate(self) -> float:
        """Run the candidate arm eagerly once at every warm shape on
        every lane (no capture: the graph counts and pools stay as they
        were); returns the wall seconds. Each shape is enqueued under the
        arm lock on the shadow streams and waited for outside it, so
        live batches keep flowing."""
        with self._warm_lock:
            keys = sorted(self._lanes[0].graphs)
        quantized = self._quantized
        t0 = time.perf_counter()
        for kind, L, rows in keys:
            fn = self._key_fn(kind, quantized)
            with self._arm_lanes("candidate") as (runs, _, streams):
                for lane, params, stream, part in zip(
                        self._lanes, runs, streams,
                        self._split(self._key_inputs(L, rows))):
                    with lane.on(stream):
                        self._device_out(lane, None, fn, params, part,
                                         eager=True)
            self._drain_shadows()
        return time.perf_counter() - t0

    def flip(self) -> float:
        """Promote the candidate: on each lane's live batches' stream,
        behind every batch already enqueued, copy the candidate's values
        into the lane's own resident tensors (the graphs keep their
        addresses), the first lane parking the resident values in pinned
        host buffers first; then free the candidate. Every lane flips
        inside one hold of `_arm_lock`: batches enqueued before the flip
        read the old trunk on every lane, batches after it the new one;
        when flip returns the new trunk is live and the park is on the
        host. On the int8 arm the fp32 tree (read only eagerly) is
        swapped, the old one parked on the host. Returns the wall
        seconds."""
        t0 = time.perf_counter()
        with self._arm_lock:
            if self.cand_params is None:
                raise NoCandidateError(
                    "flip asked with no candidate trunk loaded")
            quantized = self._quantized
            waits = []
            for lane in self._lanes:
                with lane.on(lane.stream), torch.inference_mode():
                    if lane.index == 0:
                        # Every lane holds the same values: one park.
                        parked = _host_copy(lane.serving)
                        if quantized:
                            parked_fp32 = self._parked(self.params)
                            self.params = self.cand_params
                    _copy_into(lane.serving, lane.cand)
                    waits.append(self._event(lane.stream))
            released = ([lane.cand for lane in self._lanes],
                        self.cand_params)
            for lane in self._lanes:
                lane.cand = None
            self.cand_params = self.cand_qparams = None
            self.parked_params = parked_fp32 if quantized else parked
            self.parked_qparams = parked if quantized else None
        for done in waits:
            done()
        self._drain_shadows()
        del released
        return time.perf_counter() - t0

    def rollback(self) -> float:
        """Return the parked trunk: its host values are copied back into
        every lane's resident tensors on the lane's live batches' stream
        (the same graphs, bit for bit the pre-flip numerics), all inside
        one hold of `_arm_lock`, and the demoted trunk moves to the
        candidate slot in tensors of its own on each lane (a fixed
        re-promotion need not reload). NoCandidateError when nothing is
        parked. Returns the wall seconds."""
        t0 = time.perf_counter()
        with self._arm_lock:
            if self.parked_params is None:
                raise NoCandidateError(
                    "rollback asked with no parked trunk")
            quantized = self._quantized
            parked = self.parked_qparams if quantized else self.parked_params
            demoted, waits = [], []
            for lane in self._lanes:
                with lane.on(lane.stream), torch.inference_mode():
                    demoted.append(_own(lane.serving, lane.device))
                    _copy_into(lane.serving, parked)
                    if quantized and lane.index == 0:
                        demoted_fp32 = self.params
                        self.params = (_own(self.parked_params, lane.device)
                                       if self.quant_parity_every > 0
                                       else self.parked_params)
                    waits.append(self._event(lane.stream))
            for lane, tree in zip(self._lanes, demoted):
                lane.cand = tree
            self.cand_params = demoted_fp32 if quantized else demoted[0]
            self.cand_qparams = demoted[0] if quantized else None
            self.parked_params = self.parked_qparams = None
        for done in waits:
            done()
        return time.perf_counter() - t0

    def unload_candidate(self) -> bool:
        """Drop the candidate arm (rollout abort or refusal) on every
        lane; the resident arm is untouched. Returns whether one was
        loaded."""
        with self._arm_lock:
            released = ([lane.cand for lane in self._lanes],
                        self.cand_params)
            for lane in self._lanes:
                lane.cand = None
            self.cand_params = self.cand_qparams = None
            self.candidate_report = {}
        self._drain_shadows()
        return released[1] is not None

    def candidate_status(self) -> Dict:
        """Arm occupancy and the candidate report, one atomic read, with
        the graph pools' bytes beside the weights'."""
        with self._arm_lock:
            status = {"loaded": self.cand_params is not None,
                      "parked": self.parked_params is not None,
                      **self.candidate_report}
        status["graph_pool_bytes"] = self.graph_pool_bytes()
        return status

    def run_candidate(self, kind: str, tokens: np.ndarray,
                      annotations: Optional[np.ndarray] = None,
                      heads: Optional[Sequence[LoadedHead]] = None):
        """`run` on the candidate arm — the shadow entry: the live path's
        padding and batch class, eager on the shadow streams, waited for
        before it returns; nothing here touches the parity cadence or a
        live counter."""
        result, _ = self.run_timed_async(
            kind, tokens, annotations, timed=False, heads=heads,
            arm="candidate").finalize()
        return result

    def _parked(self, tree):
        """Where an fp32 tree the flip swaps out waits: itself when it is
        on the host, else a pinned host copy."""
        if all(t.device.type == "cpu" for t in _tensors(tree)):
            return tree
        return _host_copy(tree)

    @staticmethod
    def _event(stream) -> Callable[[], None]:
        """A wait for everything enqueued on `stream` so far."""
        if stream is None:
            return lambda: None
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev.synchronize

    def _drain_shadows(self) -> None:
        """Wait for every shadow request enqueued so far on every lane: a
        dropped candidate arm's tensors may be freed (their memory
        reused) only once nothing on a shadow stream reads them. Callers
        drop their last reference after this."""
        for lane in self._lanes:
            if lane.shadow_stream is not None:
                lane.shadow_stream.synchronize()

    # ------------------------------------------------- offline batch path

    def run_rows(self, kind: str, tokens: np.ndarray,
                 annotations: Optional[np.ndarray], batch_size: int):
        """Offline whole-matrix entry: group (N, seq_len) rows by
        bucket, run each group at its bucket length in input-order
        chunks of `batch_size`, reassemble by original row index.
        `predict_residues` rows are zero-filled back to seq_len."""
        n = tokens.shape[0]
        annotations = inference.check_annotations(annotations, n, self.cfg)
        lengths = (tokens != PAD_ID).sum(axis=1)
        bucket_of = np.searchsorted(self.buckets, lengths)
        out: Dict[str, np.ndarray] = {}
        flat: Optional[np.ndarray] = None
        for b, L in enumerate(self.buckets):
            idx = np.flatnonzero(bucket_of == b)
            for lo in range(0, len(idx), batch_size):
                sel = idx[lo: lo + batch_size]
                res = self.run(kind, tokens[sel][:, :L], annotations[sel])
                if kind == "embed":
                    for k, v in res.items():
                        if k not in out:
                            out[k] = np.zeros((n,) + v.shape[1:], v.dtype)
                        out[k][sel] = v
                elif kind == "predict_go":
                    if flat is None:
                        flat = np.zeros((n, res.shape[1]), res.dtype)
                    flat[sel] = res
                else:  # predict_residues: zero-fill the pad tail
                    if flat is None:
                        flat = np.zeros(
                            (n, self.cfg.data.seq_len, res.shape[2]),
                            res.dtype)
                    flat[sel, :L] = res
        return out if kind == "embed" else flat


class RaggedDispatcher(BucketDispatcher):
    """Ragged PACKED dispatch: one fixed shape (rows_per_batch, seq_len)
    per request kind — one graph per kind — fed the packed representation
    {tokens, segment_ids, annotations} (data/packing.py) instead of a
    (bucket_len, batch_class) ladder.

    Requests are packed at BUCKET-QUANTIZED spans: a request's span is its
    `bucket_len`, its tokens `[<sos> seq <eos> <pad>...]` fill the span,
    and segment_ids cover the WHOLE span. That is what makes ragged
    answers match the bucketed dispatcher's: the boundary-masked convs
    zero the taps outside the span exactly as a 'SAME' conv sees the zero
    halo at a (cls, bucket_len) row's edges, in-span <pad> positions feed
    nearby taps as they do inside a bucketed row, and attention and
    pooling leave in-span <pad> out through the real-token mask. The
    bucket set is a span rule only; the device shape never changes.
    """

    def __init__(
        self,
        params,
        cfg: PretrainConfig,
        buckets: Optional[Sequence[int]] = None,
        rows_per_batch: int = 4,
        max_segments: int = 8,
        device: DeviceLike = None,
        metrics=None,
        quant: str = "fp32",
        quant_parity_every: int = 0,
        mesh=None,
    ):
        if quant == "int8_act":
            raise ValueError(
                "quant='int8_act' is a bucketed-arm option: the packed "
                "entries have no activation fake-quant variant (use "
                "quant='int8' for weight-only quantized ragged serving)")
        if rows_per_batch < 1:
            raise ValueError(f"rows_per_batch must be >= 1, "
                             f"got {rows_per_batch}")
        if max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, "
                             f"got {max_segments}")
        # With a mesh the packed rows split over the replicas as the
        # bucketed rows do (segment ids and annotations with the tokens
        # they annotate); the one class, rows_per_batch, must divide by
        # the data*fsdp extent (the parent's check and message).
        super().__init__(params, cfg, buckets=buckets,
                         max_batch=rows_per_batch,
                         batch_classes=(rows_per_batch,), device=device,
                         metrics=metrics, quant=quant,
                         quant_parity_every=quant_parity_every, mesh=mesh)
        self.rows_per_batch = int(rows_per_batch)
        self.max_segments = int(max_segments)

    def run_timed(self, *args, **kwargs):
        raise NotImplementedError(
            "RaggedDispatcher consumes packed batches only — use "
            "run_packed()/run_packed_timed() "
            "(serve/scheduler.PackedBatchScheduler builds them)")

    @staticmethod
    def _trunk_fn(quantized: bool):
        return (_q_packed_trunk_batch if quantized
                else heads_apply.packed_trunk_batch)

    def _head_tails(self, trunk_out, heads):
        return heads_apply.packed_head_outputs(trunk_out, heads)

    def _zero_trunk_out(self, L: int, rows: int,
                        dev: torch.device) -> Dict[str, torch.Tensor]:
        """Zeros shaped as a packed trunk output."""
        m, S = self.cfg.model, self.max_segments
        dtype = activation_dtype(m)
        return {"local": torch.zeros((rows, L, m.local_dim), dtype=dtype,
                                     device=dev),
                "global": torch.zeros((rows, S, m.global_dim), dtype=dtype,
                                      device=dev),
                "seg_mask": torch.zeros((rows, S, L), dtype=torch.bool,
                                        device=dev)}

    def run_timed_async(self, *args, **kwargs):
        raise NotImplementedError(
            "RaggedDispatcher consumes packed batches only — use "
            "run_packed_timed_async() "
            "(serve/scheduler.PackedBatchScheduler builds them)")

    def run_packed(self, kind: str, tokens: np.ndarray,
                   segment_ids: np.ndarray, annotations: np.ndarray,
                   riders: Sequence[Rider], heads=None) -> List:
        outs, _ = self.run_packed_timed(kind, tokens, segment_ids,
                                        annotations, riders, heads=heads,
                                        timed=False)
        return outs

    def _packed_fn(self, kind: str, quantized: bool):
        if kind not in _PACKED_FNS:
            raise ValueError(f"unknown request kind {kind!r}; have {KINDS}")
        return quant_packed_entry(kind) if quantized else _PACKED_FNS[kind]

    def run_packed_timed(self, kind: str, tokens: np.ndarray,
                         segment_ids: np.ndarray, annotations: np.ndarray,
                         riders: Sequence[Rider], heads=None,
                         timed: bool = True):
        """Run one packed batch synchronously — submit + immediate
        finalize of `run_packed_timed_async`."""
        return self.run_packed_timed_async(
            kind, tokens, segment_ids, annotations, riders, heads=heads,
            timed=timed).finalize()

    def run_packed_timed_async(self, kind: str, tokens: np.ndarray,
                               segment_ids: np.ndarray,
                               annotations: np.ndarray,
                               riders: Sequence[Rider], heads=None,
                               timed: bool = True,
                               arm: str = "resident") -> InFlightBatch:
        """Submit one packed batch through the kind's warm shape; the
        returned `InFlightBatch.finalize()` fans per-segment outputs back
        out after the host fetch.

        tokens/segment_ids are (rows_per_batch, seq_len), annotations
        (rows_per_batch, max_segments, A), `riders` one (row,
        segment_index, start, span) per request, row-major, segment_index
        0-based. Finalize returns (per-rider outputs aligned with
        `riders`, timings); each output has the shape the bucketed
        dispatcher returns for that request: {"global" (G,), "local_mean"
        (C,)} / (A,) probs / (span, V) probs; for predict_task (`heads`,
        one head a rider) the rider's head output. `arm` as in the
        bucketed `run_timed_async`."""
        if kind == NEIGHBORS_KIND:
            kind = "embed"  # identical device work, shared graph
        if (kind == TASK_KIND) != (heads is not None):
            raise ValueError(
                f"kind {kind!r} and heads="
                f"{'set' if heads is not None else 'None'} do not agree: "
                "predict_task batches carry per-rider heads, the other "
                "kinds never do")
        quantized = self._quantized
        fn = (self._trunk_fn(quantized) if heads is not None
              else self._packed_fn(kind, quantized))
        R, L = tokens.shape
        if (R, L) != (self.rows_per_batch, self.cfg.data.seq_len):
            raise ValueError(
                f"packed tokens shape {(R, L)} != the fixed "
                f"({self.rows_per_batch}, {self.cfg.data.seq_len})")
        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        if timed:
            real = int((tokens != PAD_ID).sum())
            timings["pad_fraction"] = round(1.0 - real / (R * L), 6)
            timings["segments"] = len(riders)
            timings["segments_per_row"] = round(len(riders) / R, 4)
        t1 = time.perf_counter()
        if timed:
            timings["prep_s"] = round(t1 - t0, 9)
        eager = arm == "candidate"
        parity_due = not eager and self._quant_batch_tick(timings)
        arrays = (tokens, segment_ids, annotations)
        key = ("trunk" if heads is not None else kind, L, R)
        with self._arm_lanes(arm) as (runs, ref_params, streams):
            pending = self._submit(key, fn, runs, streams, arrays,
                                   tail=self._tails(heads), eager=eager)
        if heads is not None:
            hriders = [(h,) + tuple(r) for h, r in zip(heads, riders)]

            def fan_out(host):
                return heads_apply.riders_of(host, hriders)

            def reference():
                return heads_apply.apply_heads_packed(self._eager(
                    heads_apply.packed_trunk_batch, ref_params, arrays),
                    hriders)
        else:
            def fan_out(host):
                outs = []
                for row, seg, start, span in riders:
                    if kind == "embed":
                        outs.append({"global": host["global"][row, seg],
                                     "local_mean":
                                     host["local_mean"][row, seg]})
                    elif kind == "predict_go":
                        outs.append(host[row, seg])
                    else:  # the span lines up with the bucketed
                        # (bucket_len, V) output
                        outs.append(host[row, start:start + span])
                return outs

            def reference():
                return fan_out(inference.run_batch(
                    self._packed_fn(kind, False), ref_params, self.cfg,
                    *arrays, device=self.device))

        def fetch():
            outs = fan_out(pending())
            if parity_due:
                self._shadow_parity(outs, reference, timings)
            return outs

        return InFlightBatch(len(riders), timings,
                             self._finalizer(fetch, timings, t1, timed))

    def _key_fn(self, kind: str, quantized: bool):
        return (self._trunk_fn(quantized) if kind == "trunk"
                else self._packed_fn(kind, quantized))

    def _key_inputs(self, L: int, rows: int):
        return self._dummy_packed()[:3]

    def run_candidate(self, *args, **kwargs):
        raise NotImplementedError(
            "RaggedDispatcher consumes packed batches only — use "
            "run_packed_candidate() (Server.shadow_submit builds the "
            "single-rider packed batch)")

    def run_packed_candidate(self, kind: str, tokens: np.ndarray,
                             segment_ids: np.ndarray,
                             annotations: np.ndarray,
                             riders: Sequence[Rider], heads=None) -> List:
        """`run_packed` on the candidate arm — the ragged shadow entry
        (see the bucketed `run_candidate`)."""
        outs, _ = self.run_packed_timed_async(
            kind, tokens, segment_ids, annotations, riders, heads=heads,
            timed=False, arm="candidate").finalize()
        return outs

    def _dummy_packed(self):
        """One valid packed batch (a minimal-span segment per row)."""
        R, L = self.rows_per_batch, self.cfg.data.seq_len
        span = self.buckets[0]
        tokens = np.full((R, L), PAD_ID, np.int32)
        tokens[:, 0] = SOS_ID
        tokens[:, 1] = EOS_ID
        seg = np.zeros((R, L), np.int32)
        seg[:, :span] = 1
        ann = np.zeros((R, self.max_segments,
                        self.cfg.model.num_annotations), np.float32)
        riders = [(r, 0, 0, span) for r in range(R)]
        return tokens, seg, ann, riders

    def warmup(self, kinds: Sequence[str] = ("embed",)) -> int:
        """Capture the ONE packed shape of each kind (on the CPU: run it
        once); returns how many ran. With "predict_task" in `kinds`, or
        any head registered, also the shared packed trunk and each head's
        tail on it."""
        t0 = time.perf_counter()
        tokens, seg, ann, riders = self._dummy_packed()
        R, L = self.rows_per_batch, self.cfg.data.seq_len
        n = 0
        self._warming = True
        try:
            for kind in kinds:
                if kind == TASK_KIND:
                    continue
                if kind not in KINDS:
                    raise ValueError(f"unknown request kind {kind!r}; "
                                     f"have {KINDS + (TASK_KIND,)}")
                with self._warm_lock:
                    if (kind, L, R) in self._lanes[0].graphs:
                        continue
                self._timed_warm(lambda: self.run_packed(
                    kind, tokens, seg, ann, riders))
                n += 1
            if TASK_KIND in kinds or self.heads:
                n += self._warm_trunk(("trunk", L, R),
                                      self._trunk_fn(self._quantized),
                                      (tokens, seg, ann))
        finally:
            self._warming = False
        self._note_warmup_seconds(time.perf_counter() - t0)
        return n
