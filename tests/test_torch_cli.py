"""The port's command line (`python -m proteinbert_tpu_torch`) against the
JAX package's (`python -m proteinbert_tpu`), on the CPU: `--device cpu`
for the port, the `tiny` preset (float32) and 2 training steps.

Tolerances: 1e-5 on representations and probabilities, the fp32
tolerance of tests/test_torch_inference.py (the same float32 arithmetic,
summed in another order); predict-go's TSV prints 4 decimals, so its
probabilities are held to 1e-4 after parsing. Weight files are compared
bit for bit. Verbs run in process wherever no signal or exit code of a
process is under test; the subprocesses get OMP_NUM_THREADS=1 and a
timeout each."""

import dataclasses
import json
import logging
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch
from jax import devices as jax_devices

from proteinbert_tpu import configs as jconfigs
from proteinbert_tpu.cli.main import build_parser as jax_parser
from proteinbert_tpu.cli.main import main as jmain
from proteinbert_tpu.configs import load_config as jax_load_config
from proteinbert_tpu.configs import save_config as jax_save_config
from proteinbert_tpu.parallel import make_mesh as j_make_mesh
from proteinbert_tpu_torch.cli.main import NO_CARD, REFUSED_FLAGS
from proteinbert_tpu_torch.cli.main import build_parser as port_parser
from proteinbert_tpu_torch.cli.main import main as pmain
from proteinbert_tpu_torch.configs import (
    PRESETS, config_to_dict, get_preset, load_config, save_config,
)
from tests.test_torch_obs import _body

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
TSV_TOL = 1e-4
SEQS = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWY" * 3, "GG",
        "MKT?YIAK?RQIS", "W" * 40]
# JAX verbs the port does not have yet.
NOT_YET = set()
# Options of a JAX verb the port refuses (REFUSED_FLAGS) instead of taking.
REMOVED = {"serve": {"--compile-cache-dir"},
           "fleet": {"--compile-cache-dir"}}
SUBPROCESS_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The in-process verbs run on one intra-op thread, as the
    subprocesses do (OMP_NUM_THREADS=1): the suite's workers share the
    cores, and a tiny model gains nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def loggers_restored():
    """Each CLI's `main` gives its package logger a stdout handler and
    stops it propagating (`utils/logging.start_log`); the next test files
    of this worker get the loggers back as they were, so their `caplog`
    still sees the packages' records."""
    names = ("proteinbert_tpu", "proteinbert_tpu_torch")
    saved = {n: (list(logging.getLogger(n).handlers),
                 logging.getLogger(n).propagate, logging.getLogger(n).level)
             for n in names}
    yield
    for name, (handlers, propagate, level) in saved.items():
        logger = logging.getLogger(name)
        logger.handlers[:] = handlers
        logger.propagate = propagate
        logger.setLevel(level)


def port(*argv) -> int:
    return pmain(["--device", "cpu", *map(str, argv)])


def jax(*argv) -> int:
    return jmain([*map(str, argv)])


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    env.pop("PBT_SELF_DESTRUCT_SECS", None)
    return env


def _spawn(argv, log):
    return subprocess.Popen(
        [sys.executable, "-m", "proteinbert_tpu_torch", "--device", "cpu",
         *map(str, argv)], cwd=ROOT, env=_env(),
        stdout=log, stderr=subprocess.STDOUT)


def _wait_for(path, proc, timeout=SUBPROCESS_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not (os.path.exists(path) and open(path).read().strip()):
        assert proc.poll() is None, f"process exited {proc.returncode}"
        assert time.monotonic() < deadline, f"{path} never appeared"
        time.sleep(0.1)
    return open(path).read()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """ptrain: a port pretrain run (2 steps); jrun: a JAX pretrain run (2
    steps); jax.npz: its export-weights; prun: the port's import-weights
    of that NPZ; each run with its events stream. A `serve` and a `fleet`
    over ptrain boot in their own processes meanwhile (`procs`; idle once
    up); their tests, first in this file, drive them and end them."""
    d = tmp_path_factory.mktemp("cli")
    r = types.SimpleNamespace(
        d=d, jrun=d / "jrun", npz=d / "jax.npz", prun=d / "prun",
        ptrain=d / "ptrain", jev=d / "jev.jsonl", pev=d / "pev.jsonl",
        procs={})
    logs = []
    try:
        assert port("pretrain", "--preset", "tiny", "--max-steps", 2,
                    "--checkpoint-dir", r.ptrain, "--set",
                    "train.log_every=1", "--events-jsonl", r.pev) == 0
        for name, argv in (
                ("serve", ["serve", "--pretrained", r.ptrain, "--port", 0,
                           "--port-file", d / "serve.port",
                           "--events-jsonl", d / "serve.jsonl"]),
                ("fleet", ["fleet", "--pretrained", r.ptrain,
                           "--replicas", 2, "--port", 0, "--port-file",
                           d / "fleet.port", "--boot-timeout-s",
                           SUBPROCESS_TIMEOUT])):
            logs.append(open(d / f"{name}.log", "wb"))
            r.procs[name] = _spawn(argv, logs[-1])
        assert jax("pretrain", "--preset", "tiny", "--max-steps", 2,
                   "--checkpoint-dir", r.jrun, "--set", "train.log_every=1",
                   "--events-jsonl", r.jev) == 0
        assert jax("export-weights", "--pretrained", r.jrun,
                   "--output", r.npz) == 0
        assert port("import-weights", "--weights", r.npz, "--output",
                    r.prun, "--step", 2) == 0
        yield r
    finally:
        # SIGTERM first: a fleet drains and stops its replicas itself.
        for proc in r.procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in r.procs.values():
            try:
                proc.wait(timeout=SUBPROCESS_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=SUBPROCESS_TIMEOUT)
        for log in logs:
            log.close()


# ---------------------------------------------------------- subprocesses

def test_pretrain_sigterm_exits_75_and_resumes_at_the_next_step(tmp_path):
    """SIGTERM after a logged step: exit 75 with the step saved; the same
    command with a --max-steps two past it (in process) continues from
    the next step, not from 0."""
    ck, metrics = tmp_path / "ck", tmp_path / "m.jsonl"
    argv = ["pretrain", "--preset", "tiny", "--checkpoint-dir", ck,
            "--metrics-jsonl", metrics, "--set", "train.log_every=1",
            "--events-jsonl", tmp_path / "ev.jsonl"]
    with open(tmp_path / "1.log", "wb") as log:
        proc = _spawn(argv + ["--max-steps", 100000], log)
        try:
            _wait_for(metrics, proc)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=SUBPROCESS_TIMEOUT) == 75
        finally:
            proc.kill()
    saved = max(int(n) for n in os.listdir(ck) if n.isdigit())
    first = [json.loads(s)["step"] for s in open(metrics)]
    assert first == list(range(1, saved + 1))
    assert port(*argv, "--max-steps", saved + 2) == 0
    steps = [json.loads(s)["step"] for s in open(metrics)]
    assert steps == list(range(1, saved + 3))
    events = [json.loads(s) for s in open(tmp_path / "ev.jsonl")]
    assert [e["step"] for e in events if e["event"] == "requeue"] == [saved]
    assert [e["outcome"] for e in events if e["event"] == "run_end"] == [
        "preempted", "completed"]


def test_serve_answers_and_drains_on_sigterm(runs):
    proc, d = runs.procs["serve"], runs.d
    url = f"http://127.0.0.1:{_wait_for(d / 'serve.port', proc).strip()}"
    got = _post(url + "/v1/embed", {"seq": SEQS[0]})
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=SUBPROCESS_TIMEOUT) == 0
    out = d / "serve_want.npz"
    assert port("embed", "--pretrained", runs.ptrain, "--output", out,
                SEQS[0]) == 0
    np.testing.assert_allclose(np.asarray(got["global"], np.float32),
                               np.load(out)["global"][0], rtol=TOL, atol=TOL)
    last = json.loads((d / "serve.jsonl").read_text().splitlines()[-1])
    assert last["event"] == "serve_end" and last["outcome"] == "drained"


def test_serve_mesh_in_process_answers(runs, tmp_path, monkeypatch):
    """`serve --mesh` over a one-device mesh, in process: the JAX log
    line, one answer equal to `embed`'s, the mesh in `serve_start`, and
    SIGTERM (sent once answered) drains it with exit 0."""
    port_file, events = tmp_path / "serve.port", tmp_path / "serve.jsonl"
    answers = []

    def client():
        deadline = time.monotonic() + SUBPROCESS_TIMEOUT
        while not (port_file.exists() and port_file.read_text().strip()):
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        else:
            url = f"http://127.0.0.1:{port_file.read_text().strip()}"
            answers.append(_post(url + "/v1/embed", {"seq": SEQS[0]}))
        os.kill(os.getpid(), signal.SIGTERM)

    lines = []
    monkeypatch.setattr(sys.modules["proteinbert_tpu_torch.cli.main"], "log",
                        lines.append)
    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    assert port("serve", "--pretrained", runs.ptrain, "--mesh",
                "--pretrained-set", "mesh.data=1", "--port", 0,
                "--port-file", port_file, "--events-jsonl", events) == 0
    thread.join(SUBPROCESS_TIMEOUT)
    assert ("serving with batch-dim sharding over {'data': 1, 'fsdp': 1, "
            "'model': 1, 'seq': 1} (1 devices)") in lines
    (got,) = answers
    out = tmp_path / "want.npz"
    assert port("embed", "--pretrained", runs.ptrain, "--output", out,
                SEQS[0]) == 0
    np.testing.assert_allclose(np.asarray(got["global"], np.float32),
                               np.load(out)["global"][0], rtol=TOL, atol=TOL)
    records = [json.loads(line) for line in events.read_text().splitlines()]
    (start,) = [r for r in records if r["event"] == "serve_start"]
    assert start["config"]["mesh"] == {"data": 1, "fsdp": 1, "model": 1,
                                       "seq": 1}
    assert records[-1]["event"] == "serve_end"
    assert records[-1]["outcome"] == "drained"


def test_fleet_routes_and_rollout_reads_it(runs, capsys):
    """`fleet` spawned two `serve` replicas over ptrain; 5 routed
    requests, `rollout status` against its router, SIGTERM → exit 0 with
    every accepted request sealed."""
    proc, d = runs.procs["fleet"], runs.d
    url = f"http://127.0.0.1:{_wait_for(d / 'fleet.port', proc).strip()}"
    answers = [_post(url + "/v1/embed", {"seq": s}) for s in SEQS]
    capsys.readouterr()
    assert pmain(["rollout", "status", "--url", url, "--json"]) == 0
    status = json.loads(capsys.readouterr().out)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=SUBPROCESS_TIMEOUT) == 0
    assert all(np.isfinite(a["global"]).all() for a in answers)
    assert status["rollout"] is None and len(status["fingerprints"]) == 2
    assert "fleet drained: 5 accepted, 5 sealed" in (
        d / "fleet.log").read_text()


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_npz(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------- weights both ways

def test_jax_weights_come_across_bit_for_bit(runs):
    out = runs.d / "port_of_jax.npz"
    assert port("export-weights", "--pretrained", runs.prun,
                "--output", out) == 0
    _same_npz(_npz(runs.npz), _npz(out))
    from proteinbert_tpu_torch.weights import load_npz, params_to_flat

    _same_npz(_npz(runs.npz), params_to_flat(
        load_npz(runs.npz, get_preset("tiny").model, "cpu")))


def _run_verb(main, verb, run, out, extra=()):
    args = [verb, "--pretrained", run, "--output", out, *extra, *SEQS]
    if main is pmain:
        return port(*args)
    return jax(*args)


@pytest.mark.parametrize("verb", ["embed", "predict-go", "predict-residues"])
def test_verbs_on_jax_weights_match_jax(runs, verb):
    """JAX pretrain → JAX export-weights → port import-weights → the
    port's verb, against the JAX verb on the JAX run directory."""
    ext = ".npz" if verb == "embed" else ".tsv"
    extra = {"embed": ["--per-residue", "--batch-size", 2],
             "predict-go": ["--top-k", 5]}.get(verb, [])
    want, got = runs.d / f"j_{verb}{ext}", runs.d / f"p_{verb}{ext}"
    assert _run_verb(jmain, verb, runs.jrun, want, extra) == 0
    assert _run_verb(pmain, verb, runs.prun, got, extra) == 0
    if verb == "embed":
        w, g = np.load(want), np.load(got)
        assert sorted(w.files) == sorted(g.files)
        for k in w.files:
            assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape, k
            if k == "ids" or k == "tokens":
                np.testing.assert_array_equal(w[k], g[k])
            else:
                np.testing.assert_allclose(w[k], g[k], rtol=TOL, atol=TOL)
        return
    w = [line.split("\t") for line in want.read_text().splitlines()]
    g = [line.split("\t") for line in got.read_text().splitlines()]
    assert len(w) == len(g) > 0
    for a, b in zip(w, g):
        if verb == "predict-residues":
            assert a == b
        else:
            assert a[:4] == b[:4]
            assert abs(float(a[4]) - float(b[4])) <= TSV_TOL


def test_port_weights_go_back_to_jax(runs):
    """Port pretrain → port export-weights → JAX import-weights → JAX
    embed equals the port's embed."""
    npz, jrun = runs.d / "port.npz", runs.d / "jrun_of_port"
    assert port("export-weights", "--pretrained", runs.ptrain,
                "--output", npz) == 0
    assert jax("import-weights", "--weights", npz, "--output", jrun,
               "--preset", "tiny") == 0
    want, got = runs.d / "jb.npz", runs.d / "pb.npz"
    assert _run_verb(jmain, "embed", jrun, want) == 0
    assert _run_verb(pmain, "embed", runs.ptrain, got) == 0
    w, g = np.load(want), np.load(got)
    for k in ("global", "local_mean"):
        np.testing.assert_allclose(w[k], g[k], rtol=TOL, atol=TOL)


# ------------------------------------------------------------ one schema

@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_run_config_schema(tmp_path, preset, writer):
    """Each package's load_config reads the other's config.json to an
    equal config."""
    from proteinbert_tpu.configs import config_to_dict as jax_to_dict
    from proteinbert_tpu.configs import get_preset as jax_preset

    path = str(tmp_path / "config.json")
    if writer == "jax":
        jcfg = jax_preset(preset)
        jax_save_config(jcfg, path)
        assert config_to_dict(load_config(path)) == jax_to_dict(jcfg)
    else:
        cfg = get_preset(preset)
        save_config(cfg, path)
        assert jax_to_dict(jax_load_config(path)) == config_to_dict(cfg)


def test_run_dirs_config_json_read_alike(runs):
    from proteinbert_tpu.configs import config_to_dict as jax_to_dict

    for run in (runs.jrun, runs.prun, runs.ptrain):
        path = str(run / "config.json")
        assert config_to_dict(load_config(path)) == jax_to_dict(
            jax_load_config(path))


@pytest.mark.parametrize("stream", ["jev", "pev"])
def test_diagnose_json_same_in_both(runs, capsys, stream):
    path = getattr(runs, stream)
    capsys.readouterr()
    assert jax("diagnose", path, "--json") == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert pmain(["diagnose", str(path), "--json"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want


# ---------------------------------------------------------- convert-torch

def test_convert_torch_same_npz_as_jax(tmp_path):
    """One reference state dict through the port's convert-torch +
    export-weights and through the JAX package's conversion
    (`interop.load_reference_checkpoint` + `export.flatten_params`, what
    its convert-torch + export-weights write, without the orbax round
    trip): every converted leaf bit for bit. The attention projections,
    which the reference never saves, keep each package's own fresh init
    (interop.py docstring #2): same keys and shapes."""
    import jax as jax_lib

    from proteinbert_tpu import export as jexport
    from proteinbert_tpu import interop as jinterop
    from proteinbert_tpu.cli.main import apply_overrides as jax_overrides
    from proteinbert_tpu.configs import get_preset as jax_preset
    from tests.test_interop import _reference_state_dict

    cfg = get_preset("tiny").model
    sets = ["model.local_dim=32", "model.global_dim=64", "model.key_dim=16",
            "model.num_annotations=128"]
    assert (cfg.num_heads, cfg.num_blocks) == (4, 2)
    ckpt = tmp_path / "ref.pt"
    torch.save({"model_state_dict": _reference_state_dict(),
                "current_batch_iteration": 7}, ckpt)
    run = tmp_path / "prun"
    assert port("convert-torch", "--torch-ckpt", ckpt, "--output", run,
                "--preset", "tiny", *(f"--set={s}" for s in sets)) == 0
    assert port("export-weights", "--pretrained", run, "--output",
                tmp_path / "p.npz") == 0
    jcfg = jax_overrides(jax_preset("tiny"), sets)
    jparams, step = jinterop.load_reference_checkpoint(
        str(ckpt), jcfg.model, init_key=jax_lib.random.PRNGKey(0))
    assert step == 7
    w, g = jexport.flatten_params(jparams), _npz(tmp_path / "p.npz")
    assert sorted(w) == sorted(g)
    fresh = [k for k in w if "/attention/" in k]
    assert len(fresh) == 3 * cfg.num_blocks
    for k in w:
        assert w[k].shape == g[k].shape and g[k].dtype == np.float32, k
        if k not in fresh:
            np.testing.assert_array_equal(w[k], g[k], err_msg=k)
    assert load_config(str(tmp_path / "prun" / "config.json")) \
        .model.local_dim == 32
    assert sorted(os.listdir(tmp_path / "prun")) == ["7", "config.json"]


def test_logging_is_the_jax_module_on_the_port_logger():
    """The port's module is the JAX one on the port's logger name, up to
    docstrings (compared by syntax tree, as the obs copies are)."""
    want = (ROOT / "proteinbert_tpu/utils/logging.py").read_text()
    got = (ROOT / "proteinbert_tpu_torch/utils/logging.py").read_text()
    assert _body(got.replace("proteinbert_tpu_torch", "proteinbert_tpu")) \
        == _body(want)


# ---------------------------------------------------------------- parsers

def _verbs(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, __import__("argparse")._SubParsersAction))
    return sub.choices


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_port_verbs_are_jax_verbs_less_the_unported():
    assert set(_verbs(port_parser())) == set(_verbs(jax_parser())) - NOT_YET
    assert _options(port_parser()) - _options(jax_parser()) == {"--device"}
    assert _options(jax_parser()) - _options(port_parser()) == {"--platform"}


@pytest.mark.parametrize("verb", sorted(set(_verbs(port_parser()))))
def test_parser_options_match_jax(verb):
    jsub, psub = _verbs(jax_parser())[verb], _verbs(port_parser())[verb]
    assert _options(jsub) - REMOVED.get(verb, set()) == _options(psub)
    # Defaults and positionals too.
    jd = {a.dest: a.default for a in jsub._actions}
    pd = {a.dest: a.default for a in psub._actions}
    for dest in pd:
        assert pd[dest] == jd[dest], dest


def test_help_lists_the_verbs(capsys, monkeypatch):
    """`python -m proteinbert_tpu_torch --help`, through `__main__`."""
    import runpy

    monkeypatch.setattr(sys, "argv", ["proteinbert_tpu_torch", "--help"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("proteinbert_tpu_torch", run_name="__main__")
    assert done.value.code == 0
    out = capsys.readouterr().out
    for verb in _verbs(port_parser()):
        assert verb in out


# --------------------------------------------------------------- refusals

def _bad_npz(runs):
    flat = _npz(runs.npz)
    path = runs.d / "bad.npz"
    np.savez(path, **{k: v for k, v in flat.items()
                      if not k.startswith("blocks/1/attention")})
    return path


@pytest.mark.parametrize("case", [
    "orbax", "mesh", "mesh-long", "geometry", "malformed", "platform",
    "multihost", "serve-mesh", "serve-cache", "fleet-cache", "no-card",
    "mesh-large", "reshard", "seq-fsdp"])
def test_refusals(runs, case, tmp_path, monkeypatch):
    out = str(tmp_path / "o")
    if case == "orbax":
        argv = ["--device", "cpu", "embed", "--pretrained", str(runs.jrun),
                "--output", out + ".npz", "MKT"]
        match = "not a port run directory.*export-weights.*import-weights"
    elif case in ("mesh", "mesh-long", "mesh-large"):
        # One process: a mesh of several devices is refused with the JAX
        # message and the way to launch it.
        preset = {"mesh": "base", "mesh-long": "long",
                  "mesh-large": "large"}[case]
        argv = ["--device", "cpu", "pretrain", "--preset", preset,
                "--max-steps", "1", "--checkpoint-dir", out]
        match = {"mesh": "wants 16 devices, have 1: launch 16 processes.*"
                         "--multihost.*--set mesh.data=1",
                 "mesh-long": "--set mesh.data=1 --set mesh.seq=1",
                 "mesh-large": "wants 256 devices, have 1: launch 256 "
                               "processes.*--multihost.*--set mesh.data=1 "
                               "--set mesh.model=1"}[case]
    elif case == "multihost":
        # Asked for and not findable: the JAX error, not N lone runs.
        for name in ("COORDINATOR_ADDRESS", "RANK", "WORLD_SIZE",
                     "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(name, raising=False)
        argv = ["--device", "cpu", "pretrain", "--multihost", "--preset",
                "tiny", "--checkpoint-dir", out]
        match = "multi-host initialization was requested but failed"
    elif case == "reshard":
        # A target mesh that does not parse: the JAX verb's text.
        argv = ["reshard", "--src", "a", "--output", out, "--target-mesh",
                "0x2"]
        with pytest.raises(SystemExit) as jax_exit:
            jmain(argv)
        assert str(jax_exit.value).startswith("--target-mesh: mesh axis")
        match = __import__("re").escape(str(jax_exit.value))
        argv = ["--device", "cpu", *argv]
    elif case == "seq-fsdp":
        # One process: the JAX mesh-size message, and the way to launch.
        with pytest.raises(ValueError) as jax_error:
            j_make_mesh(jconfigs.MeshConfig(seq=2, fsdp=2),
                        jax_devices()[:1])
        argv = ["--device", "cpu", "pretrain", "--preset", "tiny",
                "--set", "mesh.seq=2", "--set", "mesh.fsdp=2",
                "--checkpoint-dir", out]
        match = (__import__("re").escape(str(jax_error.value))
                 + ": launch 4 processes.*--multihost.*"
                 "--set mesh.fsdp=1 --set mesh.seq=1")
    elif case in ("geometry", "malformed"):
        weights = runs.npz if case == "geometry" else _bad_npz(runs)
        sets = ["--set=model.local_dim=64"] if case == "geometry" else []
        argv = ["import-weights", "--weights", str(weights), "--output",
                out, "--preset", "tiny", *sets]
        with pytest.raises(SystemExit) as jax_exit:
            jmain(argv)
        # The JAX CLI's text (the malformed case: up to its reason).
        match = str(jax_exit.value)
        if case == "malformed":
            match = match.split(": ", 1)[0] + ": "
        match = __import__("re").escape(match)
        argv = ["--device", "cpu", *argv]
    elif case == "serve-mesh":
        # `serve --mesh` on the base preset (mesh data=16) and the CPU
        # (one device): the JAX mesh-size message, before any trunk loads.
        with pytest.raises(ValueError) as jax_error:
            j_make_mesh(jconfigs.get_preset("base").mesh, jax_devices()[:1])
        argv = ["--device", "cpu", "serve", "--pretrained", out, "--preset",
                "base", "--mesh"]
        match = __import__("re").escape(str(jax_error.value))
    elif case == "no-card":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: --device cuda is valid")
        argv = ["embed", "--pretrained", str(runs.prun), "--output",
                out + ".npz", "MKT"]
        match = __import__("re").escape(NO_CARD)
    else:
        flag, argv = {
            "platform": ("--platform", ["--platform", "cpu", "smoke"]),
            "serve-cache": ("--compile-cache-dir", [
                "serve", "--pretrained", "x", "--compile-cache-dir=c"]),
            "fleet-cache": ("--compile-cache-dir", [
                "fleet", "--pretrained", "x", "--compile-cache-dir", "c"]),
        }[case]
        match = __import__("re").escape(REFUSED_FLAGS[flag])
    with pytest.raises(SystemExit, match=match):
        pmain(argv)
    assert not os.path.exists(out)


# ----------------------------------------------------- the other verbs

def test_reshard_in_process_as_the_jax_verb(runs, capsys):
    """`reshard --target-mesh 1` of each package's pretrain run: exit 0,
    one JSON summary with the JAX verb's keys, kind and parity, the
    target mesh in each output's config.json alike; the port's step
    directory a byte copy of its source's, and its `reshard` event
    valid."""
    from proteinbert_tpu_torch.obs import read_events

    out, events = runs.d / "p_resharded", runs.d / "reshard.jsonl"
    summaries = []
    for run, src, dst in ((jax, runs.jrun, runs.d / "j_resharded"),
                          (port, runs.ptrain, out)):
        capsys.readouterr()
        argv = ["reshard", "--src", src, "--output", dst, "--target-mesh",
                "1"]
        if run is port:
            argv += ["--events-jsonl", events]
        assert run(*argv) == 0
        line = [t for t in capsys.readouterr().out.splitlines()
                if t.startswith("{")][-1]
        summaries.append(json.loads(line))
    want, got = summaries
    assert set(got) == set(want)
    for k in ("step", "source_mesh", "target_mesh", "zero_update",
              "schedule", "parity"):
        assert got[k] == want[k], k
    assert got["schedule"] == "identity" and got["parity"] is True
    assert json.loads((runs.d / "j_resharded" / "config.json").read_text())[
        "mesh"] == json.loads((out / "config.json").read_text())["mesh"]
    step = str(got["step"])
    assert (out / step / "state.pt").read_bytes() == (
        runs.ptrain / step / "state.pt").read_bytes()
    (ev,) = [e for e in read_events(str(events), strict=True)
             if e["event"] == "reshard"]
    assert ev["wire_bytes"]["total"] == 0 and ev["step"] == got["step"]


def test_smoke_with_a_profile_dir(tmp_path):
    assert port("smoke", "--max-steps", 2, "--set", "train.log_every=1",
                "--history-json", tmp_path / "h.json",
                "--profile-dir", tmp_path / "prof") == 0
    history = json.loads((tmp_path / "h.json").read_text())
    assert [h["step"] for h in history] == [1, 2]
    (trace,) = os.listdir(tmp_path / "prof")
    events = json.loads((tmp_path / "prof" / trace).read_text())
    assert events["traceEvents"]


def test_hdf5_corpus_through_pretrain_evaluate_and_predict_go(tmp_path,
                                                             capsys):
    """`--data` in the reference schema: num_annotations taken from the
    file, the held-out eval on bucketed batches, `evaluate --data`, and
    predict-go's GO ids from `included_annotations`."""
    from tests.test_torch_h5_data import A, write_corpus

    h5 = write_corpus(str(tmp_path / "c.h5"), 512, seed=3)
    run, hist = tmp_path / "run", tmp_path / "h.json"
    assert port("pretrain", "--preset", "tiny", "--data", h5,
                "--max-steps", 2, "--eval-frac", 0.05, "--checkpoint-dir",
                run, "--history-json", hist, "--set", "train.eval_every=2",
                "--set", "data.buckets=[32,64,128]") == 0
    assert load_config(str(run / "config.json")).model.num_annotations == A
    assert [h["step"] for h in json.loads(hist.read_text())
            if "eval_loss" in h] == [2]
    capsys.readouterr()
    assert port("evaluate", "--pretrained", run, "--data", h5,
                "--max-batches", 2) == 0
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert result["rows"] == 16 and np.isfinite(result["loss"])
    assert port("predict-go", "--pretrained", run, "--data", h5,
                "--top-k", 3, "--output", tmp_path / "go.tsv", "MKT") == 0
    rows = [r.split("\t") for r in (tmp_path / "go.tsv").read_text()
            .splitlines()]
    assert len(rows) == 3
    assert all(r[2] == f"GO:{int(r[1]):07d}" for r in rows)


def test_evaluate_is_reproducible(runs, capsys):
    results = []
    for _ in range(2):
        capsys.readouterr()
        assert port("evaluate", "--pretrained", runs.ptrain,
                    "--max-batches", 2) == 0
        results.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert results[0] == results[1]
    assert results[0]["step"] == 2 and results[0]["batches"] == 2
    assert results[0]["rows"] == 16 and np.isfinite(results[0]["loss"])


def test_evaluate_matches_jax(runs, capsys):
    """The port's `evaluate` on the imported JAX run against the JAX
    `evaluate` on the JAX run: corruption set to the identity, 128
    synthetic rows in batches of 30 (a tail batch of 8). Every key,
    the pooled `global_auroc` / `global_p_at_k` and their `*_batch_mean`
    included, agrees to 1e-5."""
    sets = [f"--pretrained-set=data.{k}" for k in (
        "batch_size=30", "token_randomize_prob=0.0",
        "annotation_corrupt_prob=1.0", "annotation_drop_prob=0.0",
        "annotation_add_prob=0.0")]
    results = []
    for verb, run in ((jax, runs.jrun), (port, runs.prun)):
        capsys.readouterr()
        assert verb("evaluate", "--pretrained", run, *sets) == 0
        results.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    want, got = results
    assert sorted(got) == sorted(want)
    assert {"global_auroc", "global_auroc_batch_mean",
            "global_p_at_k_batch_mean"} <= set(got)
    assert (got["batches"], got["rows"]) == (want["batches"], want["rows"]) \
        == (5, 128)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_finetune_registers_a_head_eval_heads_scores_it(runs, tmp_path,
                                                         capsys):
    reg = tmp_path / "reg"
    assert port("finetune", "--preset", "tiny", "--pretrained", runs.prun,
                "--epochs", 1, "--num-outputs", 4, "--freeze-trunk",
                "--checkpoint-dir", tmp_path / "ft",
                "--register-head", reg, "--head-name", "toy") == 0
    capsys.readouterr()
    assert port("eval-heads", "--registry", reg, "--pretrained", runs.prun,
                "--batch-size", 8, "--events-jsonl",
                tmp_path / "he.jsonl") == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert len(lines) == 1 and lines[0]["kind"] == "token_classification"
    assert np.isfinite(lines[0]["score"])
    events = [json.loads(s) for s in open(tmp_path / "he.jsonl")]
    assert [e["event"] for e in events] == ["head_eval"]


def test_map_index_and_their_verify(runs, tmp_path, capsys):
    store, index = tmp_path / "store", tmp_path / "index"
    seqs = [s.replace("?", "A") for s in SEQS] * 3
    assert port("map", "--pretrained", runs.prun, "--store", store,
                "--num-shards", 2, "--block-size", 3, "--rows-per-batch", 2,
                "--events-jsonl", tmp_path / "map.jsonl", *seqs) == 0
    capsys.readouterr()
    assert pmain(["map", "--store", str(store), "--verify"]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["ok"] and report["complete"]
    assert report["embedded"] == len(seqs)
    assert pmain(["index", "--store", str(store), "--index", str(index),
                  "--centroids", "2", "--block-size", "4", "--json"]) == 0
    stats = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert stats["outcome"] == "completed" and stats["vectors"] == len(seqs)
    assert pmain(["index", "--index", str(index), "--verify"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["ok"]
    # The JAX package's verifiers read the port's store and index.
    assert jax("map", "--store", store, "--verify") == 0
    assert jax("index", "--index", index, "--verify") == 0


# ----------------------------------------------------------------- check

def _check_tree(root, bad: bool):
    """A tree both packages' `check` defaults read: the port's layout
    (tests/test_torch_analysis.write_port_tree) and the JAX package's
    schema beside it; with `bad`, the same lock violation in each."""
    from tests.test_torch_analysis import (
        LOCK_VIOLATION, write_port_tree, write_tree,
    )

    write_port_tree(root, {})
    write_tree(root, {"proteinbert_tpu/obs/events.py": "EVENT_FIELDS = {}\n"})
    if bad:
        write_tree(root, {"proteinbert_tpu/bad.py": LOCK_VIOLATION,
                          "proteinbert_tpu_torch/bad.py": LOCK_VIOLATION})


def _both_checks(capsys, *argv):
    """(exit code, stdout) of the JAX verb and of the port's, the JAX
    report's paths and rule name mapped to the port's, its timing
    dropped."""
    out = []
    for run, rename in ((jmain, True), (pmain, False)):
        rc = run(["check", *map(str, argv)])
        text = capsys.readouterr().out
        if rename:
            text = text.replace("proteinbert_tpu/", "proteinbert_tpu_torch/")
            text = text.replace("jit-purity", "graph-purity")
            text = text.replace("tools/check_baseline.json",
                                "proteinbert_tpu_torch/analysis/"
                                "check_baseline.json")
        if text.startswith("{"):
            text = json.loads(text)
            text.pop("seconds", None)
        out.append((rc, text))
    return out


@pytest.mark.parametrize("case", ["clean", "findings", "rule"])
def test_check_exits_and_reports_as_the_jax_verb(tmp_path, capsys, case):
    _check_tree(tmp_path, bad=case != "clean")
    argv = ["--root", tmp_path, "--json"]
    if case == "rule":
        argv += ["--rule", "lock-discipline"]
    jax_out, port_out = _both_checks(capsys, *argv)
    assert port_out == jax_out
    rc, report = port_out
    assert rc == (0 if case == "clean" else 1)
    assert report["ok"] is (case == "clean")
    if case == "rule":
        assert report["rules"] == ["lock-discipline"]
    else:
        assert len(report["rules"]) == 6 and "graph-purity" in report["rules"]
    if case != "clean":
        assert {f["path"] for f in report["findings"]} == {
            "proteinbert_tpu_torch/bad.py"}


def test_check_write_baseline_then_clean(tmp_path, capsys):
    _check_tree(tmp_path, bad=True)
    files = {}
    for run, name in ((jmain, "jax"), (pmain, "port")):
        baseline = tmp_path / f"{name}.json"
        assert run(["check", "--root", str(tmp_path), "--baseline",
                    str(baseline), "--write-baseline"]) == 0
        files[name] = json.loads(baseline.read_text())
        assert run(["check", "--root", str(tmp_path), "--baseline",
                    str(baseline), "--json"]) == 0
        report = json.loads(capsys.readouterr().out.split("\n", 1)[1])
        assert report["counts"]["new"] == 0
        assert report["counts"]["baselined"] > 0
    assert json.dumps(files["jax"]).replace(
        "proteinbert_tpu/", "proteinbert_tpu_torch/") == json.dumps(
            files["port"])


@pytest.mark.parametrize("case", ["no-reason", "unknown-rule"])
def test_check_config_errors_exit_2(tmp_path, capsys, case):
    _check_tree(tmp_path, bad=True)
    if case == "no-reason":
        baseline = tmp_path / "b.json"
        baseline.write_text(json.dumps({"v": 1, "suppressions": [
            {"key": "lock-discipline::x.py::A.b:c", "reason": ""}]}))
        argv = ["--root", tmp_path, "--baseline", baseline]
    else:
        argv = ["--root", tmp_path, "--rule", "no-such-rule"]
    (jrc, _), (prc, _) = _both_checks(capsys, *argv)
    assert jrc == prc == 2


def test_check_events_jsonl_note_is_strict_valid(tmp_path, capsys):
    from proteinbert_tpu_torch.obs import read_events

    _check_tree(tmp_path, bad=True)
    events = tmp_path / "check.jsonl"
    assert pmain(["check", "--root", str(tmp_path), "--events-jsonl",
                  str(events)]) == 1
    (note,) = read_events(str(events), strict=True)
    assert note["event"] == "note" and note["kind"] == "check_capture"
    assert note["check_findings_total"] > 0
    assert note["check_baselined_total"] == 0


def test_check_default_root_is_the_repo_holding_the_port(capsys):
    """No --root: the verb analyzes this checkout (one cheap rule)."""
    assert port("check", "--rule", "durability-protocol", "--json") == 0
    report = json.loads(capsys.readouterr().out)
    assert report["rules"] == ["durability-protocol"] and report["ok"]
