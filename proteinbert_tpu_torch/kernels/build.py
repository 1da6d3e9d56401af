"""Build and load the port's CUDA kernels: nvcc → shared library → ctypes.

Each kernel source in `proteinbert_tpu_torch/csrc/` is compiled by hand
with nvcc into a shared library with a plain C interface, for
`sm_90a`, and loaded with ctypes — no PyTorch headers, so a build takes
seconds, not minutes. Libraries land in `<repo>/build/` under a name
that hashes the sources and flags, so an edited source is never served
by a stale library. A build happens at first use (or all at once, in
parallel, through `build_all`); a failed build raises — there is no
fallback.

The Hopper kernels that load through TMA (`csrc/hopper.cuh`) encode their
tensor maps with the driver's `cuTensorMapEncodeTiled`, fetched at run
time through the CUDA runtime's `cudaGetDriverEntryPointByVersion`, so no
library links against libcuda and the flags below stay as they are.

Every C entry point returns `cudaGetLastError()` after its launch, and
`Kernel.launch` raises when that is not 0. Each `Kernel` carries a
plain integer `launches`, bumped once per launch of its CUDA kernel and
nowhere else, so a run can show that its main path went through it.

A call made while its thread captures a CUDA graph launches nothing: the
kernel runs when the graph is replayed. `recording_launches()` collects
such calls per kernel instead of counting them, and `credit()` adds one
replay's worth to the counts (serve/dispatch.py replays warm shapes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from contextlib import contextmanager
from typing import Dict, Iterable, Iterator, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes argument kinds for the C entry points.
PTR = ctypes.c_void_p
INT = ctypes.c_int

# Per thread: the launches recorded into the CUDA graph this thread is
# capturing (None while it captures nothing).
_capture = threading.local()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the port's kernels are "
                       "built from source at first use")


class Kernel:
    """One CUDA source → one shared library with one C entry point."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.ptxas_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def _sources(self) -> List[Path]:
        return [self.source] + sorted(CSRC.glob("*.cuh"))

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in self._sources():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"pbt_{self.name}_{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this kernel unless its library exists; returns
        (process, temporary output, library path), or None."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, lib

    def function(self):
        """The loaded C entry point (building the library first if
        needed)."""
        with self._lock:
            if self._fn is None:
                build_all([self])
                lib = ctypes.CDLL(str(self.library_path()))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise if the launch reported a CUDA
        error; count the launch (or, under `recording_launches`, record
        it for the graph's replays)."""
        rc = self.function()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc}")
        recorded = getattr(_capture, "launches", None)
        if recorded is None:
            self.launches += 1
        else:
            recorded[self] = recorded.get(self, 0) + 1


@contextmanager
def recording_launches() -> Iterator[Dict[Kernel, int]]:
    """While the calling thread captures a CUDA graph: each `launch` on
    this thread goes into the yielded {kernel: calls} instead of its
    count, since the graph, not the call, runs the kernel."""
    if getattr(_capture, "launches", None) is not None:
        raise RuntimeError("recording_launches does not nest")
    _capture.launches = recorded = {}
    try:
        yield recorded
    finally:
        _capture.launches = None


def credit(launches: Dict[Kernel, int]) -> None:
    """Count one replay of a graph whose capture recorded `launches`."""
    for kernel, n in launches.items():
        kernel.launches += n


def build_all(kernels: Iterable[Kernel]) -> None:
    """Build every kernel whose library is missing — one nvcc per source,
    all started together. Raises with nvcc's output if any build fails."""
    jobs = [(k, k.start_build()) for k in kernels]
    errors = []
    for k, job in jobs:
        if job is None:
            continue
        proc, tmp, lib = job
        k.ptxas_log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {k.source.name} "
                          f"(exit {proc.returncode}):\n{k.ptxas_log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on `device`, as the C entry points
    take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor a kernel reads or writes lies on one CUDA device and
    is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: a {tuple(t.shape)} operand is not "
                             "contiguous")


def check_tma(name: str, *tensors: torch.Tensor) -> None:
    """Each tensor can be read by TMA as rows of its last dimension: the
    base address 16-byte aligned and every outer stride a multiple of 16
    bytes (the tensor-map encoder refuses anything else). Needs no
    device: the checks read only addresses and strides."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a {tuple(t.shape)} operand starts at "
                             f"an address that is not 16-byte aligned "
                             f"(offset {t.storage_offset()} elements); TMA "
                             "needs 16")
        size = t.element_size()
        for d, stride in enumerate(t.stride()[:-1]):
            if (stride * size) % 16:
                raise ValueError(f"{name}: a {tuple(t.shape)} operand has "
                                 f"a stride of {stride} elements in "
                                 f"dimension {d}, not a multiple of 16 "
                                 "bytes; TMA needs one")
