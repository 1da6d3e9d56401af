"""Native (C++) host runtime components, compiled on first use — the
port's copy of `proteinbert_tpu/native/`, with its own sources.

The reference has no native code at all (SURVEY §2 native-code census);
this package supplies the host-side native pieces. `calls` counts each
library's calls. Components
are built from the sources in this directory with the system toolchain on
first import, cached by source hash under `_build/`, and loaded via
ctypes — if no compiler is available everything falls back to the numpy
implementations transparently (`native_available()` reports which path is
live).
"""

from proteinbert_tpu_torch.native.build import (
    calls, load_library, native_available,
)
from proteinbert_tpu_torch.native.fasta_index import build_fai_native
from proteinbert_tpu_torch.native.tokenizer import tokenize_batch_native

__all__ = ["build_fai_native", "calls", "load_library", "native_available",
           "tokenize_batch_native"]
