"""Bucketed and ragged dispatch — port of `proteinbert_tpu/serve/
dispatch.py` (`InFlightBatch` and the fp32 and int8 arms of
`BucketDispatcher` and `RaggedDispatcher`).

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
from proteinbert_tpu_torch.kernels.build import credit, recording_launches
from proteinbert_tpu_torch.models.proteinbert import to_device
from proteinbert_tpu_torch.parallel.quant import (
    SERVE_QUANT_MODES, param_bytes, quant_entry, quant_packed_entry,
    quantize_params,
)

KINDS = ("embed", "predict_go", "predict_residues")

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

    def replay(self, arrays: Sequence[np.ndarray]) -> Fetch:
        """Enqueue one batch on the current stream: `arrays` into the
        static buffers (from pinned staging, one per batch), the replay,
        the outputs' copy into pinned host buffers this batch owns, and
        an event. Returns the fetch that waits for the event and hands
        back host copies."""
        for buf, a in zip(self.inputs, arrays):
            staged = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            buf.copy_(staged, non_blocking=True)
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError(f"CUDA graph replay failed: {e}") from e
        credit(self.launches)
        host = _map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True), self.outputs)
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

    # -------------------------------------------------------- warm shapes

    @property
    def trunk_executable_count(self) -> int:
        """Warm shared-trunk graphs (the heads' trunk, JAX :347; none
        until the heads are ported)."""
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

    def _submit(self, key, fn, params, arrays: Sequence[np.ndarray]
                ) -> Fetch:
        """Start `fn` on host `arrays` → the fetch of its host outputs:
        on the card a replay of the shape's graph, on the CPU the eager
        call, already done."""
        if self.device.type == "cpu":
            out = inference.run_batch(fn, params, self.cfg, *arrays,
                                      device=self.device)
            return lambda: out
        return self._warm_shape(key, fn, params, arrays).replay(arrays)

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
            annotations: Optional[np.ndarray] = None):
        """Run one micro-batch: tokens (r, L) with L a bucket length,
        annotations (r, A) or None. Rows are padded up to the batch
        class; outputs come back trimmed to r on host —
        {"global", "local_mean"} for "embed", (r, A) probs for
        "predict_go", (r, L, V) probs for "predict_residues"."""
        result, _ = self.run_timed(kind, tokens, annotations, timed=False)
        return result

    def run_timed(self, kind: str, tokens: np.ndarray,
                  annotations: Optional[np.ndarray] = None,
                  timed: bool = True):
        """`run()` that also returns {"prep_s": padding, "device_s":
        enqueue through host fetch, "finalize_s": the host-fetch share of
        device_s, "pad_fraction": padding share of the (batch_class, L)
        grid} when `timed` — submit + immediate finalize of the async
        entry."""
        return self.run_timed_async(kind, tokens, annotations,
                                    timed=timed).finalize()

    def run_timed_async(self, kind: str, tokens: np.ndarray,
                        annotations: Optional[np.ndarray] = None,
                        timed: bool = True) -> InFlightBatch:
        """Submit one micro-batch and return an `InFlightBatch` as soon
        as it is enqueued. Validation, padding and the replay happen here
        on the calling (scheduler) thread; the wait for the device, the
        trim and the parity shadow run in the handle's `finalize()`."""
        quantized, run_params = self._arm()
        fn = self._fn(kind, quantized)
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
        pending = self._submit((kind, L, cls), fn, run_params,
                               (tokens, annotations))

        def trimmed(out):
            if isinstance(out, dict):
                return {k: v[:rows] for k, v in out.items()}
            return out[:rows]

        def fetch():
            out = trimmed(pending())
            if parity_due:
                self._shadow_parity(
                    out, lambda: trimmed(inference.run_batch(
                        self._fn(kind, False), self.params, self.cfg,
                        tokens, annotations, device=self.device)),
                    timings)
            return out

        return InFlightBatch(rows, timings,
                             self._finalizer(fetch, timings, t1, timed))

    def warmup(self, kinds: Sequence[str] = ("embed",)) -> int:
        """Capture every (bucket_len, batch_class) shape of `kinds` on
        dummy rows (on the CPU: run each once); returns how many shapes
        ran. The others are captured on first use."""
        t0 = time.perf_counter()
        n = 0
        self._warming = True
        try:
            for kind in kinds:
                if kind not in KINDS:
                    raise ValueError(f"unknown request kind {kind!r}; "
                                     f"have {KINDS}")
                for L in self.buckets:
                    for cls in self.batch_classes:
                        with self._warm_lock:
                            if (kind, L, cls) in self._graphs:
                                continue
                        dummy = self._dummy_batch(L, cls)
                        self._timed_warm(lambda: self.run(kind, dummy))
                        n += 1
        finally:
            self._warming = False
        self._note_warmup_seconds(time.perf_counter() - t0)
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

    def run_timed_async(self, *args, **kwargs):
        raise NotImplementedError(
            "RaggedDispatcher consumes packed batches only — use "
            "run_packed_timed_async() "
            "(serve/scheduler.PackedBatchScheduler builds them)")

    def run_packed(self, kind: str, tokens: np.ndarray,
                   segment_ids: np.ndarray, annotations: np.ndarray,
                   riders: Sequence[Rider]) -> List:
        outs, _ = self.run_packed_timed(kind, tokens, segment_ids,
                                        annotations, riders, timed=False)
        return outs

    def _packed_fn(self, kind: str, quantized: bool):
        if kind not in _PACKED_FNS:
            raise ValueError(f"unknown request kind {kind!r}; have {KINDS}")
        return quant_packed_entry(kind) if quantized else _PACKED_FNS[kind]

    def run_packed_timed(self, kind: str, tokens: np.ndarray,
                         segment_ids: np.ndarray, annotations: np.ndarray,
                         riders: Sequence[Rider], timed: bool = True):
        """Run one packed batch synchronously — submit + immediate
        finalize of `run_packed_timed_async`."""
        return self.run_packed_timed_async(
            kind, tokens, segment_ids, annotations, riders,
            timed=timed).finalize()

    def run_packed_timed_async(self, kind: str, tokens: np.ndarray,
                               segment_ids: np.ndarray,
                               annotations: np.ndarray,
                               riders: Sequence[Rider],
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
        (C,)} / (A,) probs / (span, V) probs."""
        quantized, run_params = self._arm()
        fn = self._packed_fn(kind, quantized)
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
        pending = self._submit((kind, L, R), fn, run_params, arrays)

        def fan_out(host):
            outs = []
            for row, seg, start, span in riders:
                if kind == "embed":
                    outs.append({"global": host["global"][row, seg],
                                 "local_mean": host["local_mean"][row, seg]})
                elif kind == "predict_go":
                    outs.append(host[row, seg])
                else:  # the span lines up with the bucketed (bucket_len, V)
                    outs.append(host[row, start:start + span])
            return outs

        def fetch():
            outs = fan_out(pending())
            if parity_due:
                self._shadow_parity(
                    outs, lambda: fan_out(inference.run_batch(
                        self._packed_fn(kind, False), self.params,
                        self.cfg, *arrays, device=self.device)),
                    timings)
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
        once); returns how many ran."""
        t0 = time.perf_counter()
        tokens, seg, ann, riders = self._dummy_packed()
        R, L = self.rows_per_batch, self.cfg.data.seq_len
        n = 0
        self._warming = True
        try:
            for kind in kinds:
                if kind not in KINDS:
                    raise ValueError(f"unknown request kind {kind!r}; "
                                     f"have {KINDS}")
                with self._warm_lock:
                    if (kind, L, R) in self._graphs:
                        continue
                self._timed_warm(lambda: self.run_packed(
                    kind, tokens, seg, ann, riders))
                n += 1
        finally:
            self._warming = False
        self._note_warmup_seconds(time.perf_counter() - t0)
        return n
