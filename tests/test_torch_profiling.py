"""The port's `utils/profiling.py` against the JAX package's on the CPU:
`TimeMeasure`, `Profiler` and `BoundaryStallMeter` on one scripted clock
give the same numbers and strings; the heap walker finds numpy arrays
and torch tensors at their `nbytes` without firing an instance
`__getattr__`; `device_memory_report()` reads torch.cuda's counters under
the JAX report's names (nothing without a card); the trainer's
first-step memory gauges keep the JAX names."""

import ast
import collections
import pathlib
import time
import types

import numpy as np
import pytest
import torch

from proteinbert_tpu.utils import profiling as jprof
from proteinbert_tpu_torch import obs, utils
from proteinbert_tpu_torch.train import trainer
from proteinbert_tpu_torch.utils import profiling as tprof
from tests.test_torch_obs import _body

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Seconds the scripted clock advances at each read: uneven, so means and
# medians of the stalls differ.
STEPS = [0.25, 1.5, 0.125, 3.0, 0.5, 0.75, 2.0, 0.0625, 1.25, 0.375,
         4.0, 0.875, 0.5, 2.5, 0.625, 1.75, 0.25]


def _scripted(monkeypatch):
    ticks = iter(np.cumsum([100.0] + STEPS).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


def _drive(mod):
    with mod.TimeMeasure("phase", verbose=False) as tm:
        pass
    prof = mod.Profiler()
    for name in ("load", "step", "load"):
        with prof.measure(name):
            pass
    meter = mod.BoundaryStallMeter()
    for _ in range(4):
        with meter.boundary():
            pass
    return tm.elapsed, prof.summary(), prof.report(), meter.summary()


def test_timers_match_jax_on_one_clock(monkeypatch):
    _scripted(monkeypatch)
    want = _drive(jprof)
    _scripted(monkeypatch)
    got = _drive(tprof)
    assert got == want
    assert got[1]["load"]["count"] == 2 and got[3]["boundaries"] == 4
    assert tprof.BoundaryStallMeter().summary() == {"boundaries": 0}


@pytest.mark.parametrize("name", [
    "TimeMeasure", "Profiler", "BoundaryStallMeter", "monitor_memory"])
def test_helpers_are_the_jax_code(name):
    """Each helper is its JAX definition but for docstrings, imports and
    comments."""
    def pick(path):
        tree = ast.parse(path.read_text())
        node = next(n for n in tree.body if getattr(n, "name", "") == name)
        return _body(ast.unparse(node))

    assert pick(ROOT / "proteinbert_tpu_torch/utils/profiling.py") == pick(
        ROOT / "proteinbert_tpu/utils/profiling.py")


def test_exports_are_the_jax_exports_and_the_stall_meter():
    import proteinbert_tpu.utils as jutils

    assert set(utils.__all__) == set(jutils.__all__) | {"BoundaryStallMeter"}
    assert utils.BoundaryStallMeter is tprof.BoundaryStallMeter


def test_monitor_memory_finds_arrays_and_tensors_without_getattr():
    """A numpy array and a torch tensor (in an instance __dict__ and an
    untracked dict, beside a deque) at their nbytes; an instance
    `__getattr__` never fires during the walk."""
    fired = []

    class Lazy:
        def __getattr__(self, attr):
            fired.append(attr)
            raise AttributeError(attr)

    class Holder:
        def __init__(self):
            self.arr = np.zeros(23 * 1024 ** 2 + 7, dtype=np.uint8)

    holder = Holder()
    held = {"t": torch.zeros(26 * 1024 ** 2 + 11, dtype=torch.uint8)}
    dq = collections.deque([torch.zeros((3, 1024 ** 2 * 3),
                                        dtype=torch.float32)])
    lazy = Lazy()
    found = tprof.monitor_memory(threshold_bytes=20 * 1024 ** 2,
                                 verbose=False)
    assert ("ndarray", holder.arr.nbytes) in found
    assert ("Tensor", held["t"].nbytes) in found
    assert ("Tensor", dq[0].nbytes) in found
    assert fired == []
    sizes = [n for _, n in found]
    assert sizes == sorted(sizes, reverse=True)
    # The JAX walker finds the numpy array too (torch tensors alike: the
    # same code).
    assert ("ndarray", holder.arr.nbytes) in jprof.monitor_memory(
        threshold_bytes=20 * 1024 ** 2, verbose=False)
    del holder, held, dq, lazy


def test_device_memory_report_without_a_card():
    """No CUDA device: no entry, as the JAX report gives no stats for a
    CPU backend."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tprof.device_memory_report() == {}


def _fake_card(monkeypatch, allocated=123, peak=456, total=789):
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": allocated, "num_alloc_retries": 0,
        "note": "not a number"})
    monkeypatch.setattr(cuda, "memory_allocated", lambda i: allocated)
    monkeypatch.setattr(cuda, "max_memory_allocated", lambda i: peak)
    monkeypatch.setattr(cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=total))
    monkeypatch.setattr(cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(cuda, "current_device", lambda: 0)


def test_device_memory_report_reads_torch_cuda(monkeypatch):
    _fake_card(monkeypatch)
    assert tprof.device_memory_report() == {"cuda:0": {
        "allocated_bytes.all.current": 123, "num_alloc_retries": 0,
        "bytes_in_use": 123, "peak_bytes_in_use": 456, "bytes_limit": 789}}


def _jax_hbm_gauges():
    """The gauge names the JAX trainer sets after its first step: the
    `f"hbm_{k}"` loop's constants."""
    tree = ast.parse((ROOT / "proteinbert_tpu/train/trainer.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and "hbm_" in ast.unparse(node.body[0]):
            return {f"hbm_{c.value}" for c in node.iter.elts}
    raise AssertionError("the JAX trainer sets no hbm_ gauges")


def test_first_step_memory_gauges_keep_the_jax_names(monkeypatch):
    tele = obs.Telemetry()
    assert trainer.first_step_memory(tele, torch.device("cpu")) is None
    assert tele.metrics.snapshot()["gauges"] == {}
    _fake_card(monkeypatch)
    stats = trainer.first_step_memory(tele, torch.device("cuda"))
    assert stats["bytes_in_use"] == 123
    gauges = tele.metrics.snapshot()["gauges"]
    assert set(gauges) == _jax_hbm_gauges() == {
        "hbm_bytes_in_use", "hbm_peak_bytes_in_use", "hbm_bytes_limit"}
    assert gauges == {"hbm_bytes_in_use": 123, "hbm_peak_bytes_in_use": 456,
                      "hbm_bytes_limit": 789}
    tele.close()
