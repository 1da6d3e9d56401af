"""The port's `check` analyzer (`proteinbert_tpu_torch/analysis/`): per-rule
seeded-violation and clean fixtures, `graph-purity`'s roots (captured
bodies, kernel wrappers) and its launch-or-raise cases, the durability
rule's directory form, the baseline and the report, the copied rules
held to the JAX files by syntax tree, the JAX analyzer and the port's
agreeing on the port's tree, and the port-tree gate run torch-free.

Fixtures are tiny trees written under tmp_path and run through the same
`run_check` the verb uses — no monkeypatching of rule internals, so a
rule that silently stopped matching its pattern fails its seeded
fixture here before it silently passes the tree. Everything is AST
work: one subprocess (the gate without torch or jax) for the module."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from proteinbert_tpu.analysis import CheckConfig as JaxCheckConfig
from proteinbert_tpu.analysis import run_check as jax_run_check
from proteinbert_tpu_torch.analysis import (
    CheckConfig, CheckContext, load_baseline, run_check, save_baseline,
    split_by_baseline,
)
from proteinbert_tpu_torch.analysis import purity, runner
from proteinbert_tpu_torch.analysis.findings import (
    BaselineError, report_dict,
)
from tests.test_torch_obs import _body

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIX_RULES = {"graph-purity", "lock-discipline", "durability-protocol",
             "event-schema", "obs-doc-drift", "dead-export"}
# The rules the JAX analyzer and the port's share unchanged.
SHARED_RULES = ["lock-discipline", "event-schema", "dead-export",
                "obs-doc-drift"]
# Doc findings the JAX analyzer makes on the port's tree and the port's
# does not: none, since the port's Server registers the kernel route
# counters (`fused_kernel_path_total`, ...) the doc names.
ALLOWED_IN_PORT: set = set()


def write_tree(root, files):
    for rel, content in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(content))


def fixture_cfg(root, **overrides):
    defaults = dict(
        root=str(root), scan_roots=("pkg",), durability_files=(),
        events_py="pkg/events.py", docs_md="docs.md",
        reference_roots=("pkg",), kernel_roots=("pkg",),
        captured_functions=())
    defaults.update(overrides)
    return CheckConfig(**defaults)


def keys(result):
    return {f.key for f in result["findings"]}


def write_port_tree(root, files):
    """A minimal tree in the port's default layout (so the verb's
    defaults run against it): the event schema, the doc, a stub of every
    configured captured function, and `files`."""
    stubs = {}
    for spec in CheckConfig(str(root)).captured_functions:
        path, _, name = spec.partition(":")
        stubs[path] = stubs.get(path, "") + f"def {name}(*args):\n    pass\n"
    write_tree(root, {
        "proteinbert_tpu_torch/obs/events.py": "EVENT_FIELDS = {}\n",
        "docs/observability.md": "## Event schema\n\n## Metric names\n",
        **stubs, **files})


# ------------------------------------------------------- rule 1: purity

CAPTURED_VIOLATION = """
    import os
    import random
    import time

    import numpy as np
    import torch

    COUNT = 0


    def helper(x):
        return x * time.time()          # clock at capture


    def step(x):
        global COUNT                    # global mutated at capture
        if os.environ.get("MY_FLAG"):   # unsanctioned env read
            x = x + random.random()     # host randomness
        return helper(x) + np.random.rand()


    def capture(graph, x):
        t0 = time.perf_counter()        # before the capture: fine
        with torch.cuda.graph(graph):
            out = step(x)
        return out, time.perf_counter() - t0
"""


def test_graph_purity_seeded_captured_body(tmp_path):
    write_tree(tmp_path, {"pkg/m.py": CAPTURED_VIOLATION})
    res = run_check(fixture_cfg(tmp_path), rules=["graph-purity"])
    got = keys(res)
    # Every host-state class, through the call chain body -> step ->
    # helper; the clocks around the capture are host side.
    assert "graph-purity::pkg/m.py::helper:time.time" in got
    assert "graph-purity::pkg/m.py::step:os.environ" in got
    assert "graph-purity::pkg/m.py::step:random.random" in got
    assert "graph-purity::pkg/m.py::step:np.random.rand" in got
    assert "graph-purity::pkg/m.py::step:global COUNT" in got
    assert not any("capture" in k for k in got)


def test_graph_purity_captured_function_across_modules(tmp_path):
    """A configured captured function (what WarmShape gets as `fn`) is a
    root, and the rule follows its imports into other scanned modules."""
    write_tree(tmp_path, {
        "pkg/__init__.py": "",
        "pkg/util.py": """
            import time


            def stamp(x):
                return x + time.perf_counter()
        """,
        "pkg/batch.py": """
            from pkg import util
            from pkg.util import stamp


            def embed_batch(x):
                return stamp(x) + util.stamp(x)


            def not_captured(x):
                import os
                return os.getenv("FLAG")
        """,
    })
    cfg = fixture_cfg(tmp_path,
                      captured_functions=("pkg/batch.py:embed_batch",))
    res = run_check(cfg, rules=["graph-purity"])
    assert keys(res) == {"graph-purity::pkg/util.py::stamp:"
                         "time.perf_counter"}
    assert res["errors"] == []


def test_graph_purity_unresolved_captured_function_is_a_config_error(
        tmp_path):
    write_tree(tmp_path, {"pkg/batch.py": "def renamed(x):\n    return x\n"})
    cfg = fixture_cfg(tmp_path,
                      captured_functions=("pkg/batch.py:embed_batch",
                                          "pkg/gone.py:embed_batch"))
    res = run_check(cfg, rules=["graph-purity"])
    assert len(res["errors"]) == 2
    assert all("does not resolve" in e for e in res["errors"])


WRAPPER_CLEAN = """
    import os

    import torch


    def _device_check(name, x):
        if x.device.type == "cpu":
            return True
        if x.device.type != "cuda":
            raise ValueError(name)
        return False


    def k_reference(x):
        return x * 2


    def k_grad_reference(x):
        return x * 2


    def recompute_vjp(run, backward_ref, *args):
        return run(*args)


    def int8_leg(name, x, plain, kernel, *args):
        if x.device.type == "cpu":
            return plain(*args)
        return kernel(*args)


    def sanctioned_reader():
        return os.environ.get("CUDA_HOME")


    def _launch(x):
        try:
            KERNEL.launch(x.data_ptr())
        except RuntimeError as e:
            raise ValueError("launch failed") from e
        return x


    def by_test(x):
        if x.device.type == "cpu":
            run = k_reference
        elif x.device.type == "cuda":
            run = _launch
        else:
            raise ValueError(x.device)
        return recompute_vjp(run, k_grad_reference, x)


    def by_predicate(x):
        run = k_reference if _device_check("k", x) else _launch
        return recompute_vjp(run, k_grad_reference, x)


    def by_negation(x):
        if x.device.type != "cpu":
            sanctioned_reader()
            return _launch(x)
        else:
            return k_reference(x)


    def by_taker(x):
        return int8_leg("k", x, k_reference, _launch, x)
"""


def test_graph_purity_clean_wrappers_and_cpu_routes(tmp_path):
    write_tree(tmp_path, {"pkg/k.py": WRAPPER_CLEAN})
    cfg = fixture_cfg(tmp_path, sanctioned_env_readers=("sanctioned_reader",))
    res = run_check(cfg, rules=["graph-purity"])
    assert res["findings"] == [] and res["errors"] == []
    roots = {q for kind, _, q in purity.graph_roots(CheckContext(cfg))
             if kind == "wrapper"}
    # Every function that reaches the launch, by call or by name.
    assert roots == {"_launch", "by_test", "by_predicate", "by_negation",
                     "by_taker"}


WRAPPER_VIOLATION = """
    import time


    def k_reference(x):
        return x * 2


    def run_it(fn, x):
        return fn(x)


    def _launch(x):
        t0 = time.perf_counter()                # clock in a wrapper
        KERNEL.launch(x.data_ptr())
        return x


    def swallows(x):
        try:
            return _launch(x)
        except RuntimeError:
            return None                         # no raise


    def falls_back(x):
        try:
            return _launch(x)
        except RuntimeError:
            return k_reference(x)               # plain in a handler


    def not_a_cpu_test(x):
        if x.device.type == "cuda":
            return _launch(x)
        return k_reference(x)                   # "mps" lands here too


    def through_a_taker(x):
        if x.device.type == "cuda":
            return run_it(k_reference, x)       # run_it has no CPU test
        return _launch(x)
"""


def test_graph_purity_seeded_wrappers_launch_or_raise(tmp_path):
    write_tree(tmp_path, {"pkg/k.py": WRAPPER_VIOLATION})
    res = run_check(fixture_cfg(tmp_path), rules=["graph-purity"])
    prefix = "graph-purity::pkg/k.py::"
    assert keys(res) == {prefix + k for k in (
        "_launch:time.perf_counter",
        "swallows:except-swallows:RuntimeError",
        "falls_back:except-swallows:RuntimeError",
        "falls_back:except-plain:k_reference",
        "not_a_cpu_test:plain-route:k_reference",
        "through_a_taker:plain-route:k_reference")}


# --------------------------------------------------- graph-purity: tree

ATTENTION_WRAPPERS = {"_attention_launch", "_attention_ids",
                      "fused_attention", "fused_global_attention",
                      "fused_packed_attention"}
FUSED_BLOCK_WRAPPERS = {"_launch_track", "_local_track_kernel",
                        "_local_track_valid_kernel", "fused_local_track",
                        "fused_local_track_valid", "_segments_kernel",
                        "fused_local_track_segments"}
ONE_PASS_WRAPPERS = {"_onepass_kernel", "fused_onepass",
                     "fused_onepass_segments", "fused_onepass_dense"}


def test_graph_purity_roots_on_the_port_tree():
    """The rule resolves its roots on the real tree: every launch-reaching
    wrapper of the three kernel modules, every configured captured
    function, and WarmShape's capture. A rule without roots checks
    nothing."""
    cfg = CheckConfig(str(ROOT))
    ctx = CheckContext(cfg)
    roots = purity.graph_roots(ctx)
    assert ctx.errors == []
    by_kind = {}
    for kind, path, qual in roots:
        by_kind.setdefault(kind, set()).add(f"{path}:{qual}")
    kernels = "proteinbert_tpu_torch/kernels/"
    for module, names in (("attention.py", ATTENTION_WRAPPERS),
                          ("fused_block.py", FUSED_BLOCK_WRAPPERS),
                          ("one_pass.py", ONE_PASS_WRAPPERS)):
        want = {f"{kernels}{module}:{n}" for n in names}
        assert want <= by_kind["wrapper"], want - by_kind["wrapper"]
        # Every function holding a launch call is among them.
        tree = __import__("ast").parse((ROOT / kernels / module).read_text())
        for fn in tree.body:
            if hasattr(fn, "name") and ".launch(" in __import__(
                    "ast").unparse(fn):
                assert fn.name in names
    assert by_kind["captured"] == set(cfg.captured_functions)
    assert by_kind["graph-body"] == {
        "proteinbert_tpu_torch/serve/dispatch.py:WarmShape.__init__:<graph>"}


def test_captured_functions_are_what_the_dispatchers_capture():
    """`CheckConfig.captured_functions` names exactly the batch functions
    the two dispatchers can hand to WarmShape: the fp32 tables, the int8
    entries and the predict_task trunks."""
    from proteinbert_tpu_torch.parallel.quant import (
        quant_entry, quant_packed_entry,
    )
    from proteinbert_tpu_torch.serve import dispatch

    fns = [*dispatch._BATCH_FNS.values(), *dispatch._PACKED_FNS.values()]
    for kind in dispatch.KINDS:
        fns += [quant_entry(kind), quant_entry(kind, act=True),
                quant_packed_entry(kind)]
    for cls in (dispatch.BucketDispatcher, dispatch.RaggedDispatcher):
        fns += [cls._trunk_fn(False), cls._trunk_fn(True)]
    got = {f"{fn.__module__.replace('.', '/')}.py:{fn.__qualname__}"
           for fn in fns}
    assert got == set(CheckConfig(str(ROOT)).captured_functions)


# --------------------------------------------------- rule 2: locks

LOCK_VIOLATION = """
    import threading


    class Router:
        def __init__(self):
            self._lock = threading.Lock()
            self.sealed = 0        # guarded-by: _lock
            self.ended = False     # guarded-by: _lock

        def seal(self):
            with self._lock:
                self.sealed += 1

        def drain(self):
            if not self.ended:     # unlocked read
                self.ended = True  # unlocked write
"""

LOCK_CLEAN = """
    import threading


    class Router:
        def __init__(self):
            self._lock = threading.Lock()
            self.sealed = 0        # guarded-by: _lock

        def seal(self):
            with self._lock:
                self.sealed += 1

        def _report(self):  # lock-held: _lock
            return self.sealed

        def stats(self):
            with self._lock:
                return {"sealed": self.sealed, "r": self._report()}
"""

LOCK_ORDER = """
    import threading

    a_lock = threading.Lock()
    b_lock = threading.Lock()


    def one():
        with a_lock:
            with b_lock:
                pass


    def two():
        with b_lock:
            with a_lock:
                pass
"""


def test_lock_discipline_seeded_violation_and_cycle(tmp_path):
    write_tree(tmp_path, {"pkg/m.py": LOCK_VIOLATION,
                          "pkg/order.py": LOCK_ORDER})
    res = run_check(fixture_cfg(tmp_path), rules=["lock-discipline"])
    got = keys(res)
    assert "lock-discipline::pkg/m.py::Router.drain:ended" in got
    assert not any("seal" in k for k in got)
    assert any(k.startswith("lock-discipline::pkg/order.py::lock-order:")
               for k in got)


def test_lock_discipline_clean_with_lock_held_annotation(tmp_path):
    write_tree(tmp_path, {"pkg/m.py": LOCK_CLEAN})
    res = run_check(fixture_cfg(tmp_path), rules=["lock-discipline"])
    assert res["findings"] == []


# --------------------------------------------------- rule 3: durability

DURABILITY_VIOLATION = """
    import os


    def save_no_fsync(path, data):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)       # no fsync between write and rename


    def save_bare(path, data):
        with open(path, "wb") as f:  # bytes straight to the final path
            f.write(data)
"""

DURABILITY_CLEAN = """
    import os


    def save(path, data):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


    def append_log(path, line):
        with open(path, "a", buffering=1) as f:   # append-only: exempt
            f.write(line)
"""

# The port checkpointer's shape: files fsynced inside a tmp directory,
# the directory renamed, then its parent fsynced through a helper.
DIRECTORY_FORM = """
    import json
    import os


    def _fsync_dir(path):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


    def write_step(directory, step, blob, meta):
        tmp = os.path.join(directory, f".tmp-{step}")
        os.makedirs(tmp)
        with open(os.path.join(tmp, "state.pt"), "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())                                # FSYNC1
        with open(os.path.join(tmp, "data.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())                                # FSYNC2
        os.rename(tmp, os.path.join(directory, str(step)))      # RENAME
        _fsync_dir(directory)                                   # PARENT
"""


def _durability(tmp_path, source):
    write_tree(tmp_path, {"pkg/store.py": source})
    cfg = fixture_cfg(tmp_path, durability_files=("pkg/store.py",))
    return keys(run_check(cfg, rules=["durability-protocol"]))


def test_durability_seeded_violations(tmp_path):
    got = _durability(tmp_path, DURABILITY_VIOLATION)
    assert any("rename-without-fsync" in k and "save_no_fsync" in k
               for k in got)
    assert any("bare-final-write" in k and "save_bare" in k for k in got)


def test_durability_clean(tmp_path):
    assert _durability(tmp_path, DURABILITY_CLEAN) == set()


def test_durability_directory_form_is_durable(tmp_path):
    assert _durability(tmp_path, DIRECTORY_FORM) == set()


@pytest.mark.parametrize("cut,want", [
    ("FSYNC2", "write_step:dir-file-without-fsync:"
               "os.path.join(tmp, 'data.json')"),
    ("PARENT", "write_step:dir-rename-without-parent-fsync:tmp"),
    # Without the rename each file is written to its final name.
    ("RENAME", "write_step:bare-final-write:os.path.join(tmp, 'state.pt')"),
])
def test_durability_directory_form_seeded(tmp_path, cut, want):
    source = "\n".join(ln for ln in DIRECTORY_FORM.splitlines()
                       if not ln.endswith(f"# {cut}"))
    got = _durability(tmp_path, source)
    assert "durability-protocol::pkg/store.py::" + want in got
    assert len(got) == (2 if cut == "RENAME" else 1)


# ------------------------------------------------- rules 4-6

EVENTS_PY = """
    EVENT_FIELDS = {
        "step": {"step": int, "metrics": dict},
        "note": {"source": str},
        "burn": {"rate": (int, float)},
    }
"""


def test_event_schema_seeded_and_clean(tmp_path):
    write_tree(tmp_path, {
        "pkg/events.py": EVENTS_PY,
        "pkg/m.py": """
            def go(tele, fields):
                tele.emit("stepp", step=1, metrics={})     # unknown
                tele.emit("step", step=1)                  # missing
                tele.emit("step", step="one", metrics={})  # wrong type
                tele.emit("burn", rate=2)                  # int ok
                tele.emit("step", **fields)                # spread: skip
                tele.emit("note", source="test", extra=True)
        """,
    })
    res = run_check(fixture_cfg(tmp_path), rules=["event-schema"])
    assert keys(res) == {
        "event-schema::pkg/m.py::emit:stepp:unknown-event",
        "event-schema::pkg/m.py::emit:step:missing:metrics",
        "event-schema::pkg/m.py::emit:step:type:step"}


def test_obs_doc_drift_seeded_and_allowed(tmp_path):
    write_tree(tmp_path, {
        "pkg/events.py": EVENTS_PY,
        "pkg/m.py": """
            def instruments(reg):
                reg.counter("undocumented_thing_total").inc()
                reg.counter("cache_hits_total").inc()
                reg.counter("cache_misses_total").inc()
        """,
        "docs.md": """
            ## Event schema

            | `step` | `step`, `metrics` |
            | `note` | `source` |
            | `ghost_event` | gone |

            ## Metric names

            `cache_{hits,misses}_total`, `ghost_metric_total` and
            `fused_kernel_path_total`.
        """,
    })
    cfg = fixture_cfg(tmp_path, docs_allow=("fused_kernel_path_total",))
    got = keys(run_check(cfg, rules=["obs-doc-drift"]))
    assert {k.split("::")[-1] for k in got} == {
        "event-undocumented:burn", "event-ghost:ghost_event",
        "metric-undocumented:undocumented_thing_total",
        "metric-ghost:ghost_metric_total"}


def test_dead_export_seeded_and_clean(tmp_path):
    write_tree(tmp_path, {
        "pkg/__init__.py": """
            from pkg.mod import used_fn, dead_fn

            __all__ = ["used_fn", "dead_fn"]
        """,
        "pkg/mod.py": "def used_fn():\n    return 1\n\n\n"
                      "def dead_fn():\n    return 2\n",
        "pkg/caller.py": "from pkg.mod import used_fn\nused_fn()\n",
    })
    got = keys(run_check(fixture_cfg(tmp_path), rules=["dead-export"]))
    assert got == {"dead-export::pkg/__init__.py::export:dead_fn"}


# ---------------------------------------------- parse gate and baseline

def test_syntax_error_is_a_finding_not_a_skip(tmp_path):
    write_tree(tmp_path, {"pkg/broken.py": "def broken(:\n"})
    res = run_check(fixture_cfg(tmp_path), rules=["graph-purity"])
    assert any(f.rule == "parse" for f in res["findings"])


def test_write_baseline_refuses_to_suppress_syntax_errors(tmp_path):
    write_port_tree(tmp_path, {
        "proteinbert_tpu_torch/broken.py": "def broken(:\n"})
    baseline = str(tmp_path / "b.json")
    assert runner.main(["--root", str(tmp_path), "--baseline", baseline,
                        "--write-baseline"]) == 2
    assert not os.path.exists(baseline)


def test_baseline_round_trip_staleness_and_reasons(tmp_path):
    write_tree(tmp_path, {"pkg/m.py": LOCK_VIOLATION})
    res = run_check(fixture_cfg(tmp_path), rules=["lock-discipline"])
    assert res["findings"]
    path = str(tmp_path / "baseline.json")
    save_baseline(path, {f.key: "accepted: fixture debt"
                         for f in res["findings"]})
    loaded = load_baseline(path)
    new, suppressed, stale = split_by_baseline(res["findings"], loaded)
    assert new == [] and len(suppressed) == len(res["findings"])
    assert stale == []
    loaded["lock-discipline::pkg/gone.py::X.y:z"] = "paid down"
    _, _, stale = split_by_baseline(res["findings"], loaded)
    assert stale == ["lock-discipline::pkg/gone.py::X.y:z"]
    (tmp_path / "bad.json").write_text(json.dumps(
        {"v": 1, "suppressions": [{"key": "a::b::c", "reason": "  "}]}))
    with pytest.raises(BaselineError):
        load_baseline(str(tmp_path / "bad.json"))


def test_report_dict_json_schema():
    rep = report_dict([], [], [], {}, ["graph-purity"])
    assert rep["v"] == 1 and rep["kind"] == "pbt_check_report"
    assert rep["ok"] is True
    assert rep["counts"] == {"new": 0, "baselined": 0,
                             "stale_baseline": 0,
                             "check_findings_total": 0}
    json.dumps(rep)


def test_injected_violation_gate(tmp_path, capsys):
    """Exit 1 on a tree with an injected violation; --write-baseline; then
    exit 0 with the finding baselined."""
    write_port_tree(tmp_path, {
        "proteinbert_tpu_torch/bad.py": LOCK_VIOLATION})
    root = ["--root", str(tmp_path)]
    assert runner.main(root + ["--json"]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] is False and set(rep["rules"]) == SIX_RULES
    assert {f["rule"] for f in rep["findings"]} == {"lock-discipline"}
    baseline = str(tmp_path / "b.json")
    assert runner.main(root + ["--baseline", baseline,
                               "--write-baseline"]) == 0
    assert runner.main(root + ["--baseline", baseline, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert rep["counts"]["new"] == 0 and rep["counts"]["baselined"] > 0


# ---------------------------------------------- copies of the JAX rules

@pytest.mark.parametrize("module", [
    "findings.py", "locks.py", "schema_rule.py", "exports_rule.py",
    "docs_rule.py"])
def test_copies_differ_from_jax_only_in_docstrings_and_imports(module):
    want = (ROOT / "proteinbert_tpu/analysis" / module).read_text()
    got = (ROOT / "proteinbert_tpu_torch/analysis" / module).read_text()
    assert _body(got) == _body(want)

    def imports(src):
        ast = __import__("ast")
        return sorted(ast.unparse(n) for n in ast.walk(ast.parse(src))
                      if isinstance(n, (ast.Import, ast.ImportFrom)))
    assert imports(got) == sorted(
        s.replace("proteinbert_tpu.", "proteinbert_tpu_torch.")
        for s in imports(want))


def test_analysis_imports_nothing_of_torch_or_the_port():
    ast = __import__("ast")
    for path in (ROOT / "proteinbert_tpu_torch/analysis").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("torch", "jax", "numpy",
                                   "proteinbert_tpu"), (path, name)
                if top == "proteinbert_tpu_torch" and not name.startswith(
                        "proteinbert_tpu_torch.analysis"):
                    # The one lazy import: the --events-jsonl note.
                    assert name == "proteinbert_tpu_torch.obs.events", (
                        path, name)


# ------------------------------------------------- the port's own tree

@pytest.fixture(scope="module")
def port_gate(tmp_path_factory):
    """The analyzer over the port's tree in a subprocess where torch and
    jax cannot import, through a stub parent package (the root
    `__init__` imports torch); the exit code and the JSON report."""
    d = tmp_path_factory.mktemp("poison")
    for name in ("torch", "jax"):
        (d / name).mkdir()
        (d / name / "__init__.py").write_text(
            f'raise ImportError("{name} must not be imported by check")\n')
    (d / "gate.py").write_text(textwrap.dedent(f"""
        import os, sys, types
        repo = {str(ROOT)!r}
        stub = types.ModuleType("proteinbert_tpu_torch")
        stub.__path__ = [os.path.join(repo, "proteinbert_tpu_torch")]
        sys.modules["proteinbert_tpu_torch"] = stub
        sys.path.insert(1, repo)
        from proteinbert_tpu_torch.analysis.runner import main
        sys.exit(main(["--json"], repo_root=repo))
    """))
    env = dict(os.environ, PYTHONPATH=str(d))
    proc = subprocess.run([sys.executable, str(d / "gate.py")],
                          capture_output=True, text=True, cwd=d, env=env,
                          timeout=120)
    return proc


def test_port_tree_gate_torch_free(port_gate):
    """The port's tree passes its own gate: exit 0, no new finding,
    nothing baselined (the one entry, `reshard_wire_bytes`, went stale
    when the port's reshard registered the gauge, and was deleted),
    nothing stale, the six rules — with torch and jax unimportable."""
    assert port_gate.returncode == 0, port_gate.stdout + port_gate.stderr
    rep = json.loads(port_gate.stdout)
    assert rep["ok"] is True and rep["findings"] == []
    assert rep["errors"] == [] and rep["stale_baseline"] == []
    assert rep["counts"]["baselined"] == 0 and rep["baselined"] == []
    assert set(rep["rules"]) == SIX_RULES


def test_jax_and_port_analyzers_agree_on_the_port_tree(port_gate):
    """The JAX analyzer pointed at the port's tree and the port's own
    give the same lock, schema, export and doc findings."""
    port = json.loads(port_gate.stdout)
    got = {f["key"] for f in port["findings"] + port["baselined"]
           if f["rule"] in SHARED_RULES}
    cfg = CheckConfig(str(ROOT))
    jcfg = JaxCheckConfig(
        root=str(ROOT), scan_roots=cfg.scan_roots,
        durability_files=cfg.durability_files, events_py=cfg.events_py,
        docs_md=cfg.docs_md, reference_roots=cfg.reference_roots)
    res = jax_run_check(jcfg, rules=SHARED_RULES)
    want = {f.key for f in res["findings"]}
    assert res["errors"] == []
    assert want - got == ALLOWED_IN_PORT
    assert got == want - ALLOWED_IN_PORT
