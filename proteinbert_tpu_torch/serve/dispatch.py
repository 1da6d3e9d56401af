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

`metrics` (an obs `MetricsRegistry`) receives the JAX dispatcher's
`serve_executable_count`, `serve_warmup_seconds_total`,
`serve_compile_seconds` and `serve_quant_parity_max`.
"""

from __future__ import annotations

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
from proteinbert_tpu_torch.models.proteinbert import activation_dtype, to_device
from proteinbert_tpu_torch.parallel.quant import (
    SERVE_QUANT_MODES, _q_packed_trunk_batch, _q_trunk_batch, param_bytes,
    quant_entry, quant_packed_entry, quantize_params,
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


def default_batch_classes(max_batch: int) -> Tuple[int, ...]:
    """Ascending power-of-two ladder capped by (and always containing)
    max_batch: 8 → (1, 2, 4, 8); 12 → (1, 2, 4, 8, 12)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    classes = []
    c = 1
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
    weights are the dispatcher's, and the intermediates and per-call
    scratches come from the graph's pool. Replays of graphs that share a
    pool must not overlap; a dispatcher replays on one thread, each batch
    enqueued behind the last on one stream."""

    def __init__(self, fn: Callable, params, cfg: PretrainConfig,
                 arrays: Sequence[np.ndarray], device: torch.device,
                 pool, stream: torch.cuda.Stream):
        self.inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in arrays]
        # The eager warm run: it builds and loads the kernels and makes
        # their one-time CUDA runtime calls outside the capture.
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
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


class BucketDispatcher:
    """Routes (kind, tokens, annotations) micro-batches to their warm
    shape on `device` (None → "cuda") and returns trimmed host outputs.
    `quant` picks the arm (`SERVE_QUANT_MODES`)."""

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
    ):
        if quant not in SERVE_QUANT_MODES:
            raise ValueError(f"quant must be one of {SERVE_QUANT_MODES}, "
                             f"got {quant!r}")
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.buckets = resolve_buckets(cfg, buckets)
        self.max_batch = int(max_batch)
        if batch_classes is None:
            batch_classes = default_batch_classes(self.max_batch)
        self.batch_classes = tuple(sorted(int(c) for c in set(batch_classes)))
        if self.batch_classes[-1] < self.max_batch:
            raise ValueError(
                f"largest batch class {self.batch_classes[-1]} cannot hold "
                f"a full micro-batch of {self.max_batch}")
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
        self._compile_hist = (metrics.histogram("serve_compile_seconds")
                              if metrics is not None else None)
        self._exec_g = (metrics.gauge("serve_executable_count")
                        if metrics is not None else None)
        self._warmup_g = (metrics.gauge("serve_warmup_seconds_total")
                          if metrics is not None else None)
        self.warmup_seconds_total = 0.0
        # Captured graphs by (kind, L, batch class). Added by the thread
        # that dispatches, read by stats() from client threads.
        self._graphs: Dict[Tuple[str, int, int], WarmShape] = {}
        self._warm_lock = threading.Lock()
        self._pool = None             # the graphs' shared memory pool
        self._capture_stream = None
        # Registered heads: head_id -> LoadedHead with its params on the
        # device. Requests keep the head they were admitted with, so a
        # removal drains queued work.
        self.heads: Dict[str, LoadedHead] = {}
        self._heads_lock = threading.Lock()
        self.warmup_report: Dict = {"trunk_executables": 0,
                                    "trunk_s": 0.0, "heads": {}}

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
        """Register a head for predict_task: its params go to the device
        once, as float32 tensors. With `warm` (a live server) its tail
        runs once per warm trunk shape (`warm_head`); returns those
        seconds. No trunk graph is captured."""
        placed = heads_apply.head_params_on(head.params, self.device)
        head = LoadedHead(head_id=head.head_id, name=head.name,
                          task=head.task, params=placed, meta=head.meta)
        with self._heads_lock:
            self.heads[head.head_id] = head
        return self.warm_head(head) if warm else 0.0

    def remove_head(self, head_id: str) -> LoadedHead:
        """Unregister a head; UnknownHeadError if absent. New submits for
        it are refused; admitted requests hold their own reference and
        complete."""
        with self._heads_lock:
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

    def _trunk_shapes(self) -> List[Tuple[int, int]]:
        """(L, rows) of every warm trunk graph."""
        with self._warm_lock:
            return sorted({(k[1], k[2]) for k in self._graphs
                           if k[0] == "trunk"})

    def _zero_trunk_out(self, L: int, rows: int) -> Dict[str, torch.Tensor]:
        """Zeros shaped as a bucketed trunk output."""
        m, dev = self.cfg.model, self.device
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
        for L, rows in self._trunk_shapes():
            t0 = time.perf_counter()
            self._head_tails(self._zero_trunk_out(L, rows), [head])
            self._sync()
            total += time.perf_counter() - t0
        self.warmup_report["heads"][head.head_id] = round(total, 6)
        return total

    # -------------------------------------------------------- warm shapes

    @property
    def trunk_executable_count(self) -> int:
        """Warm shared-trunk graphs — the number that stays flat across
        head add and remove (0 on the CPU, where nothing is captured)."""
        with self._warm_lock:
            return sum(1 for k in self._graphs if k[0] == "trunk")

    @property
    def executable_count(self) -> int:
        """Captured CUDA graphs — the JAX dispatcher's warm executables
        (0 on the CPU, where nothing is captured)."""
        with self._warm_lock:
            return len(self._graphs)

    def graph_pool_bytes(self) -> int:
        """Device bytes the graphs' shared pool holds: its segments in
        the caching allocator's snapshot (0 before the first capture)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def _warm_shape(self, key, fn, params,
                    arrays: Sequence[np.ndarray]) -> WarmShape:
        """The graph of `key`, captured now on `arrays` if it is new."""
        with self._warm_lock:
            warm = self._graphs.get(key)
        if warm is not None:
            return warm
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        warm = WarmShape(fn, params, self.cfg, arrays, self.device,
                         self._pool, self._capture_stream)
        with self._warm_lock:
            self._graphs[key] = warm
            n = len(self._graphs)
        if self._exec_g is not None:
            self._exec_g.set(n)
        return warm

    def _device_out(self, key, fn, params, arrays: Sequence[np.ndarray]):
        """`fn` on host `arrays` → its outputs on the device: on the card
        a replay of the shape's graph (captured now if new), on the CPU
        the eager call."""
        if self.device.type == "cpu":
            return fn(params, *(torch.from_numpy(np.ascontiguousarray(a))
                                for a in arrays), self.cfg.model)
        return self._warm_shape(key, fn, params, arrays).launch(arrays)

    def _submit(self, key, fn, params, arrays: Sequence[np.ndarray],
                tail: Optional[Callable] = None) -> Fetch:
        """Start `fn` on host `arrays` → the fetch of its host outputs
        (on the CPU already done). `tail` (the head tails) maps the
        device outputs to what is fetched, on the same stream right
        after."""
        out = self._device_out(key, fn, params, arrays)
        if tail is not None:
            out = tail(out)
        if self.device.type == "cpu":
            host = _map(lambda t: t.numpy(), out)
            return lambda: host
        return host_fetch(out)

    def _sync(self) -> None:
        """Wait for this thread's stream (not the device: a live server's
        scheduler may be capturing on another stream meanwhile)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

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
            new = key not in self._graphs
        if new:
            _, run_params = self._arm()
            t0 = time.perf_counter()
            out = self._device_out(key, fn, run_params, arrays)
            self._sync()
            dt = time.perf_counter() - t0
            report["trunk_executables"] += 1
            report["trunk_s"] = round(report["trunk_s"] + dt, 6)
            if self._compile_hist is not None:
                self._compile_hist.observe(dt)
        else:
            out = self._zero_trunk_out(key[1], key[2])
        for head in heads:
            t0 = time.perf_counter()
            self._head_tails(out, [head])
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

    def _arm(self):
        """(whether batches run quantized, the params they run on)."""
        if self.quant == "fp32":
            return False, self.params
        return True, self.qparams

    def _eager(self, fn, arrays: Sequence[np.ndarray]):
        """`fn` on the fp32 params, eagerly, on host `arrays` → its
        device outputs (the parity shadow)."""
        return fn(self.params, *(torch.from_numpy(np.ascontiguousarray(a))
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
                        heads: Optional[Sequence[LoadedHead]] = None
                        ) -> InFlightBatch:
        """Submit one micro-batch and return an `InFlightBatch` as soon
        as it is enqueued. Validation, padding, the replay and (for
        predict_task) the head tails are enqueued here on the calling
        (scheduler) thread; the wait for the device, the trim and the
        parity shadow run in the handle's `finalize()`."""
        if kind == NEIGHBORS_KIND:
            kind = "embed"  # identical device work, shared graph
        if (kind == TASK_KIND) != (heads is not None):
            raise ValueError(
                f"kind {kind!r} and heads="
                f"{'set' if heads is not None else 'None'} do not agree: "
                "predict_task batches carry per-row heads, the other "
                "kinds never do")
        quantized, run_params = self._arm()
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
        parity_due = self._quant_batch_tick(timings)
        if heads is not None:
            # One trunk graph for the (possibly mixed-head) batch, then
            # each distinct head's tail over the whole batch; each row
            # keeps its own head's output.
            pending = self._submit(
                ("trunk", L, cls), fn, run_params, (tokens, annotations),
                tail=lambda out: self._head_tails(out, heads))

            def trimmed(outs):
                return heads_apply.rows_of(outs, heads)

            def reference():
                return heads_apply.apply_heads(self._eager(
                    heads_apply.trunk_batch, (tokens, annotations)), heads)
        else:
            pending = self._submit((kind, L, cls), fn, run_params,
                                   (tokens, annotations))

            def trimmed(out):
                if isinstance(out, dict):
                    return {k: v[:rows] for k, v in out.items()}
                return out[:rows]

            def reference():
                return trimmed(inference.run_batch(
                    self._fn(kind, False), self.params, self.cfg, tokens,
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
                            if (kind, L, cls) in self._graphs:
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
        fn = self._trunk_fn(self._arm()[0])
        A = self.cfg.model.num_annotations
        n = 0
        for L in self.buckets:
            for cls in self.batch_classes:
                n += self._warm_trunk(
                    ("trunk", L, cls), fn,
                    (self._dummy_batch(L, cls),
                     np.zeros((cls, A), np.float32)))
        return n

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
        super().__init__(params, cfg, buckets=buckets,
                         max_batch=rows_per_batch,
                         batch_classes=(rows_per_batch,), device=device,
                         metrics=metrics, quant=quant,
                         quant_parity_every=quant_parity_every)
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

    def _zero_trunk_out(self, L: int, rows: int) -> Dict[str, torch.Tensor]:
        """Zeros shaped as a packed trunk output."""
        m, dev, S = self.cfg.model, self.device, self.max_segments
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
                               timed: bool = True) -> InFlightBatch:
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
        one head a rider) the rider's head output."""
        if kind == NEIGHBORS_KIND:
            kind = "embed"  # identical device work, shared graph
        if (kind == TASK_KIND) != (heads is not None):
            raise ValueError(
                f"kind {kind!r} and heads="
                f"{'set' if heads is not None else 'None'} do not agree: "
                "predict_task batches carry per-rider heads, the other "
                "kinds never do")
        quantized, run_params = self._arm()
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
        parity_due = self._quant_batch_tick(timings)
        arrays = (tokens, segment_ids, annotations)
        if heads is not None:
            hriders = [(h,) + tuple(r) for h, r in zip(heads, riders)]
            pending = self._submit(
                ("trunk", L, R), fn, run_params, arrays,
                tail=lambda out: self._head_tails(out, heads))

            def fan_out(host):
                return heads_apply.riders_of(host, hriders)

            def reference():
                return heads_apply.apply_heads_packed(self._eager(
                    heads_apply.packed_trunk_batch, arrays), hriders)
        else:
            pending = self._submit((kind, L, R), fn, run_params, arrays)

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
                    self._packed_fn(kind, False), self.params, self.cfg,
                    *arrays, device=self.device))

        def fetch():
            outs = fan_out(pending())
            if parity_due:
                self._shadow_parity(outs, reference, timings)
            return outs

        return InFlightBatch(len(riders), timings,
                             self._finalizer(fetch, timings, t1, timed))

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
                    if (kind, L, R) in self._graphs:
                        continue
                self._timed_warm(lambda: self.run_packed(
                    kind, tokens, seg, ann, riders))
                n += 1
            if TASK_KIND in kinds or self.heads:
                n += self._warm_trunk(("trunk", L, R),
                                      self._trunk_fn(self._arm()[0]),
                                      (tokens, seg, ann))
        finally:
            self._warming = False
        self._note_warmup_seconds(time.perf_counter() - t0)
        return n
