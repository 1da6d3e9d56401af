"""The port's `check` — project-invariant static analysis over
`proteinbert_tpu_torch/` (the JAX package's `analysis/`, re-aimed).

Six stdlib-`ast` rules derived from the port's own correctness
contracts, each with positive/negative fixture self-tests
(tests/test_torch_analysis.py) and a checked-in suppression baseline
(analysis/check_baseline.json — every entry carries a reason):

- `graph-purity`     — no host clocks/randomness/env reads/global
                       mutation reachable from a captured CUDA graph
                       body or a kernel wrapper, and launch or raise in
                       the wrappers (analysis/purity.py);
- `lock-discipline`  — `# guarded-by: _lock` attributes only touched
                       under their lock, plus a static lock-order
                       cycle check (analysis/locks.py);
- `durability-protocol` — tmp→fsync→rename (per file, or a directory
                       at a time) or nothing in the durable writers
                       (analysis/durability.py);
- `event-schema`     — every `emit("<name>", ...)` call site checked
                       against EVENT_FIELDS, statically
                       (analysis/schema_rule.py);
- `obs-doc-drift`    — events/metrics vs docs/observability.md, both
                       directions (analysis/docs_rule.py);
- `dead-export`      — `__init__` exports nothing references
                       (analysis/exports_rule.py).

This package imports NOTHING from the rest of the port and nothing of
torch (the event schema is parsed off the AST, never imported), so it
runs under a stub parent package without torch, as a pre-test gate.
"""

from proteinbert_tpu_torch.analysis.context import CheckConfig, CheckContext
from proteinbert_tpu_torch.analysis.findings import (
    BaselineError, Finding, load_baseline, report_dict, save_baseline,
    split_by_baseline,
)
from proteinbert_tpu_torch.analysis.runner import RULES, main, run_check

__all__ = [
    "CheckConfig", "CheckContext", "Finding", "BaselineError",
    "load_baseline", "save_baseline", "split_by_baseline",
    "report_dict", "RULES", "run_check", "main",
]
