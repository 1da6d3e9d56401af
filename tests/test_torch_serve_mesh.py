"""Serving over a mesh on the CPU: the port's dispatchers and `Server`
with `mesh=serve_mesh(MeshConfig(data=2), devices=["cpu", "cpu"])` (two
lanes, each with its own copy of the trunk) beside the JAX dispatchers on
`mesh_for_devices(2)` of the suite's virtual CPU devices, on the same
seeded weights (carried through the flat export layout) and tokens; the
mesh-aware batch-class ladder and its refusals with the JAX messages;
`serve_mesh`'s device count and data-major replica order against JAX's
`make_mesh`; a flip racing live batches never tears a batch between arms
across the lanes; `stats()["mesh"]`; and the subpackages' public names
against the JAX package's.

Tolerances: against JAX rtol = atol = 1e-5 (float32 trunks, the JAX
test's tolerance for a sharded batch, tests/test_serve_ragged.py); the
mesh port against the port without a mesh 1e-6 (the same arithmetic on
fewer rows a call)."""

import importlib
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from proteinbert_tpu.configs import (
    DataConfig as JData, MeshConfig as JMesh, ModelConfig as JModel,
    PretrainConfig as JCfg, TaskConfig as JTask,
)
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.heads.registry import (
    HeadRegistry as JRegistry, trunk_fingerprint as jfingerprint,
)
from proteinbert_tpu.models import finetune as jft
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.parallel import make_mesh as j_make_mesh
from proteinbert_tpu.parallel import mesh_for_devices
from proteinbert_tpu.serve import dispatch as jdispatch
from proteinbert_tpu_torch.configs import (
    DataConfig, MeshConfig, ModelConfig, PretrainConfig,
)
from proteinbert_tpu_torch.heads import HeadRegistry
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.parallel import mesh as tmesh
from proteinbert_tpu_torch.parallel.mesh import serve_mesh
from proteinbert_tpu_torch.serve import (
    BucketDispatcher, RaggedDispatcher, Server,
)
from proteinbert_tpu_torch.serve.dispatch import default_batch_classes
from proteinbert_tpu_torch.weights import params_from_flat

torch.set_num_threads(1)

TOL = 1e-5
SELF_TOL = 1e-6
MODEL = dict(local_dim=32, global_dim=64, key_dim=16, num_heads=4,
             num_blocks=2, num_annotations=64, dtype="float32")
BUCKETS = (32, 64)
S = 4
SEQS = ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWYACDEF", "GGA",
        "WYACDEFGHIKLMNPQ"]
CASES = ["embed", "predict_task", "int8"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX cfg, port cfg, JAX params, port params, JAX head, port head):
    one seeded trunk in both packages and one sequence-classification
    head saved by the JAX registry and loaded by both."""
    jcfg = JCfg(model=JModel(**MODEL),
                data=JData(seq_len=64, batch_size=4, buckets=BUCKETS))
    tcfg = PretrainConfig(model=ModelConfig(**MODEL),
                          data=DataConfig(seq_len=64, batch_size=4,
                                          buckets=BUCKETS))
    jparams = jmodel.init(jax.random.PRNGKey(3), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    root = str(tmp_path_factory.mktemp("heads"))
    fp = jfingerprint(jparams)
    task = JTask(kind="sequence_classification", num_outputs=3)
    hp = jft.head_init(jax.random.PRNGKey(4), jcfg.model, task)
    hid = JRegistry(root).save(jax.tree.map(np.asarray, hp), task, fp,
                               name="cls")
    return (jcfg, tcfg, jparams, tparams,
            JRegistry(root).load(hid, trunk_fp=fp),
            HeadRegistry(root).load(hid, trunk_fp=fp))


def _lanes():
    return serve_mesh(MeshConfig(data=2), devices=["cpu", "cpu"])


def _clone(tree):
    """A params tree in tensors of its own (a flip writes into the tree
    a dispatcher serves)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _tokens(cfg, seqs, L=32):
    """(len(seqs), L) bucket rows: <sos> residues <eos> <pad>..."""
    from proteinbert_tpu_torch import inference

    return inference._tokenize_masked(seqs, cfg.data.seq_len,
                                      "count")[:, :L]


def _packed(cfg, seed=0):
    """One packed (2, 64) batch: segments at bucket spans, per-segment
    annotations, and its riders."""
    rng = np.random.default_rng(seed)
    L = cfg.data.seq_len
    tokens = np.zeros((2, L), np.int32)
    seg = np.zeros((2, L), np.int32)
    ann = np.zeros((2, S, cfg.model.num_annotations), np.float32)
    riders = []
    for r, spans in enumerate([[(10, 32), (20, 32)], [(25, 32), (3, 32)]]):
        pos = 0
        for s, (n, span) in enumerate(spans):
            tokens[r, pos] = 1
            tokens[r, pos + 1:pos + 1 + n] = rng.integers(4, 26, n)
            tokens[r, pos + 1 + n] = 2
            seg[r, pos:pos + span] = s + 1
            ann[r, s] = rng.random(cfg.model.num_annotations) < 0.05
            riders.append((r, s, pos, span))
            pos += span
    return tokens, seg, ann, riders


def _run(disp, mode, case, cfg, head):
    """One batch of `case` through a dispatcher of either package →
    host outputs as a flat list of arrays."""
    kind = "predict_task" if case == "predict_task" else "embed"
    if mode == "bucketed":
        tokens = _tokens(cfg, SEQS)
        ann = np.zeros((len(SEQS), cfg.model.num_annotations), np.float32)
        ann[1, :3] = 1.0
        heads = [head] * len(SEQS) if kind == "predict_task" else None
        out = disp.run(kind, tokens, ann, heads=heads)
    else:
        tokens, seg, ann, riders = _packed(cfg)
        heads = [head] * len(riders) if kind == "predict_task" else None
        out = disp.run_packed(kind, tokens, seg, ann, riders, heads=heads)
    if isinstance(out, dict):
        return [np.asarray(out[k]) for k in sorted(out)]
    if isinstance(out, list):
        flat = []
        for o in out:
            flat += ([np.asarray(o[k]) for k in sorted(o)]
                     if isinstance(o, dict) else [np.asarray(o)])
        return flat
    return [np.asarray(out)]


def _dispatcher(module, mode, case, cfg, params, head, **kw):
    quant = "int8" if case == "int8" else "fp32"
    if mode == "bucketed":
        disp = module.BucketDispatcher(params, cfg, buckets=BUCKETS,
                                       max_batch=4, quant=quant, **kw)
    else:
        disp = module.RaggedDispatcher(params, cfg, buckets=BUCKETS,
                                       rows_per_batch=2, max_segments=S,
                                       quant=quant, **kw)
    if case == "predict_task":
        disp.add_head(head)
    return disp


def _close(want, got, tol):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(w, g, rtol=tol, atol=tol)


# ---------------------------------------------------------------- mesh

def test_serve_mesh_refuses_a_count_with_the_jax_message():
    with pytest.raises(ValueError) as jax_error:
        j_make_mesh(JMesh(data=16), jax.devices()[:1])
    with pytest.raises(ValueError) as port_error:
        serve_mesh(MeshConfig(data=16), devices=["cpu"])
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("axes", [dict(data=2, fsdp=2),
                                  dict(data=2, model=2)])
def test_serve_mesh_replicas_in_the_jax_order(axes, monkeypatch):
    """Named devices d0..d3 (resolution stubbed: one CPU has no
    indices): the grid, its shape dict and the replica devices — (d, f,
    model 0, seq 0) in joint-axis order — are JAX's on devices 0..3."""
    jmesh = j_make_mesh(JMesh(**axes), jax.devices()[:4])
    monkeypatch.setattr(tmesh, "resolve_device", lambda d: d)
    mesh = serve_mesh(MeshConfig(**axes),
                      devices=[f"d{i}" for i in range(4)])
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.size == jmesh.size
    ids = [d.id for d in jax.devices()[:4]]
    want = [f"d{ids.index(jmesh.devices[d, f, 0, 0].id)}"
            for d in range(jmesh.shape["data"])
            for f in range(jmesh.shape["fsdp"])]
    assert mesh.replica_devices == want
    assert mesh.data_extent == len(want)


@pytest.mark.parametrize("max_batch,multiple,want", [
    (8, 1, (1, 2, 4, 8)), (12, 1, (1, 2, 4, 8, 12)), (1, 1, (1,)),
    (16, 4, (4, 8, 16)), (8, 8, (8,)), (12, 2, (2, 4, 8, 12)),
    (8, 3, "not divisible")])
def test_default_batch_classes_as_jax(max_batch, multiple, want):
    if isinstance(want, str):
        with pytest.raises(ValueError) as jax_error:
            jdispatch.default_batch_classes(max_batch, multiple=multiple)
        with pytest.raises(ValueError, match=want) as port_error:
            default_batch_classes(max_batch, multiple=multiple)
        assert str(port_error.value) == str(jax_error.value)
        return
    assert default_batch_classes(max_batch, multiple=multiple) == want
    assert jdispatch.default_batch_classes(max_batch,
                                           multiple=multiple) == want


@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_indivisible_classes_or_rows_refused_as_jax(weights, mode):
    jcfg, tcfg, jparams, tparams, _, _ = weights
    kw = (dict(batch_classes=(1, 2, 4), max_batch=4) if mode == "bucketed"
          else dict(rows_per_batch=3))
    jcls = (jdispatch.BucketDispatcher if mode == "bucketed"
            else jdispatch.RaggedDispatcher)
    tcls = BucketDispatcher if mode == "bucketed" else RaggedDispatcher
    with pytest.raises(ValueError) as jax_error:
        jcls(jparams, jcfg, buckets=BUCKETS, mesh=mesh_for_devices(2), **kw)
    with pytest.raises(ValueError, match="not divisible") as port_error:
        tcls(tparams, tcfg, buckets=BUCKETS, mesh=_lanes(), **kw)
    assert str(port_error.value) == str(jax_error.value)


def test_mesh_ladder_and_lanes(weights):
    _, tcfg, _, tparams, _, _ = weights
    disp = BucketDispatcher(tparams, tcfg, buckets=BUCKETS, max_batch=4,
                            device="cpu", mesh=_lanes())
    assert disp.batch_classes == (2, 4)
    assert [r["device"] for r in disp.lane_report()] == ["cpu", "cpu"]
    # Each lane serves a tree of its own; the first is the one given.
    a, b = (lane.serving["embedding"]["embedding"] for lane in disp._lanes)
    assert a is tparams["embedding"]["embedding"]
    assert b.data_ptr() != a.data_ptr() and torch.equal(a, b)


# ------------------------------------------------------------- parity

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_mesh_dispatchers_match_jax_on_a_mesh(weights, mode, case):
    jcfg, tcfg, jparams, tparams, jhead, thead = weights
    jdisp = _dispatcher(jdispatch, mode, case, jcfg, jparams, jhead,
                        mesh=mesh_for_devices(2))
    tdisp = _dispatcher(importlib.import_module(
        "proteinbert_tpu_torch.serve.dispatch"), mode, case, tcfg, tparams,
        thead, mesh=_lanes())
    _close(_run(jdisp, mode, case, jcfg, jhead),
           _run(tdisp, mode, case, tcfg, thead), TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_mesh_matches_the_port_without_a_mesh(weights, mode, case):
    _, tcfg, _, tparams, _, thead = weights
    module = importlib.import_module("proteinbert_tpu_torch.serve.dispatch")
    one = _dispatcher(module, mode, case, tcfg, tparams, thead,
                      device="cpu")
    two = _dispatcher(module, mode, case, tcfg, tparams, thead,
                      mesh=_lanes())
    _close(_run(one, mode, case, tcfg, thead),
           _run(two, mode, case, tcfg, thead), SELF_TOL)


# --------------------------------------------------------------- flip

@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_a_flip_never_tears_a_batch_across_lanes(weights, mode):
    """Batches run on two lanes while another thread flips and rolls
    back: every batch's rows come all from the resident trunk or all from
    the candidate, on both lanes, and the sequence of arms a lane saw is
    the batch order's."""
    _, tcfg, _, tparams, _, _ = weights
    cand = tmodel.init(tcfg.model, torch.Generator().manual_seed(9),
                       device="cpu")
    module = importlib.import_module("proteinbert_tpu_torch.serve.dispatch")
    refs = {}
    for arm, params in (("old", tparams), ("new", cand)):
        refs[arm] = _run(_dispatcher(module, mode, "embed", tcfg, params,
                                     None, device="cpu"),
                         mode, "embed", tcfg, None)
    disp = _dispatcher(module, mode, "embed", tcfg, _clone(tparams), None,
                       mesh=_lanes())
    disp.load_candidate(cand)
    stop = threading.Event()
    flips = []

    def flipper():
        while not stop.is_set():
            (disp.rollback if len(flips) % 2 else disp.flip)()
            flips.append(len(flips))

    seen = set()
    thread = threading.Thread(target=flipper)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # threads interleave more often
    thread.start()
    try:
        for _ in range(40):
            got = _run(disp, mode, "embed", tcfg, None)
            arms = [arm for arm in ("old", "new") if all(
                np.allclose(g, w, rtol=SELF_TOL, atol=SELF_TOL)
                for g, w in zip(got, refs[arm]))]
            assert len(arms) == 1, "a batch mixes the two trunks"
            seen.add(arms[0])
    finally:
        stop.set()
        thread.join(60)
        sys.setswitchinterval(switch)
    assert not thread.is_alive()
    assert flips
    assert "old" in seen


# ------------------------------------------------------------- server

def test_server_on_a_mesh_answers_and_reports_it(weights):
    _, tcfg, _, tparams, _, _ = weights
    jmesh = mesh_for_devices(2)
    with Server(tparams, tcfg, device="cpu", buckets=BUCKETS, max_batch=4,
                max_wait_s=0.005, mesh=_lanes()) as srv:
        got = [srv.submit("embed", s) for s in SEQS]
        got = [f.result(60) for f in got]
        stats = srv.stats()
    assert stats["mesh"] == dict(jmesh.shape)
    assert stats["executables"] == 0 and stats["graphs"] == 0
    with Server(tparams, tcfg, device="cpu", buckets=BUCKETS,
                max_batch=4) as plain:
        assert plain.stats()["mesh"] is None
        for seq, g in zip(SEQS, got):
            # Answered alone (a batch of one row) against a lane's slice
            # of a batch: another row count a product, so the JAX bound.
            want = plain.embed(seq, timeout=60)
            for k in want:
                np.testing.assert_allclose(g[k], want[k], rtol=TOL,
                                           atol=TOL)


# ------------------------------------------------------------ exports

NOT_PORTED = {name: set(importlib.import_module(
    f"proteinbert_tpu_torch.{name}").NOT_PORTED) for name in ("ops",
                                                              "kernels")}


@pytest.mark.parametrize("package", ["serve", "data", "ops", "models",
                                     "kernels"])
def test_subpackage_exports_are_the_jax_names(package):
    """Each subpackage's `__all__` is the JAX package's, less the names
    the port's `__init__` says have no counterpart, plus the port's own
    names where its `__init__` lists them apart (`PORT_ONLY`, names JAX's
    `__all__` does not have); every name resolves from the subpackage."""
    jpkg = importlib.import_module(f"proteinbert_tpu.{package}")
    tpkg = importlib.import_module(f"proteinbert_tpu_torch.{package}")
    missing = NOT_PORTED.get(package, set())
    own = set(getattr(tpkg, "PORT_ONLY", ()))
    assert set(tpkg.__all__) - own == set(jpkg.__all__) - missing
    assert missing <= set(jpkg.__all__)
    assert own <= set(tpkg.__all__) and not own & set(jpkg.__all__)
    for name in tpkg.__all__:
        assert getattr(tpkg, name) is not None, name
