"""The port's dense pretraining (`proteinbert_tpu_torch.train`) against the
JAX package on the CPU, with the same weights (carried through the flat
export layout) and the same numpy-made inputs.

Tolerances, float32 throughout: the loss 1e-6 on the same logits (the
same formulas, other library kernels); the optimizer chain 1e-6 relative
over 30 steps (the same float32 operations in optax's order; the bias
corrections' powers may differ by one ulp); a tiny train step's loss 1e-5
and grads 1e-4 against `jax.grad` of `proteinbert.apply` + `pretrain_loss`
(the same float32 arithmetic in another summation order, through two
blocks); a 10-step trajectory within 1% per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu import configs as jconfigs
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.train import loss as jloss
from proteinbert_tpu.train import schedule as jsched
from proteinbert_tpu.train.train_state import (
    gradient_update as j_gradient_update,
)
from proteinbert_tpu_torch import configs as tconfigs
from proteinbert_tpu_torch.data.dataset import (
    InMemoryPretrainingDataset, make_pretrain_iterator,
)
from proteinbert_tpu_torch.data.synthetic import make_random_proteins
from proteinbert_tpu_torch.train import loss as tloss
from proteinbert_tpu_torch.train import schedule as tsched
from proteinbert_tpu_torch.train import train_state as tts
from proteinbert_tpu_torch.train.metrics import (
    StepTimer, forward_flops, train_flops,
)
from proteinbert_tpu_torch.train.trainer import pretrain
from proteinbert_tpu_torch.weights import params_from_flat, params_to_flat

torch.set_num_threads(1)

MODEL = dict(local_dim=32, global_dim=64, key_dim=16, num_heads=4,
             num_blocks=2, num_annotations=32, dtype="float32")


def _cfgs(**opt):
    """The same PretrainConfig in both packages (the port's config module
    is a copy of the JAX one)."""
    kw = dict(
        model=dict(MODEL),
        data=dict(seq_len=32, batch_size=4),
        optimizer=dict(learning_rate=1e-2, warmup_steps=3,
                       schedule="warmup_cosine", total_steps=10, **opt),
        train=dict(max_steps=10, log_every=1),
    )

    def build(mod):
        return mod.PretrainConfig(
            model=mod.ModelConfig(**kw["model"]),
            data=mod.DataConfig(**kw["data"]),
            optimizer=mod.OptimizerConfig(**kw["optimizer"]),
            train=mod.TrainConfig(**kw["train"]))

    return build(jconfigs), build(tconfigs)


def _corrupted(rng, B, L, A):
    """A corrupted (X, Y, W) made with numpy: specials at both ends, a pad
    tail, ~10% of residues replaced, half the annotation rows hidden."""
    tokens = rng.integers(4, 26, (B, L)).astype(np.int32)
    tokens[:, 0] = 1
    for b in range(B):
        n = int(rng.integers(L // 2, L))
        tokens[b, n - 1] = 2
        tokens[b, n:] = 0
    ann = (rng.random((B, A)) < 0.2).astype(np.float32)
    ann[0] = 0.0                               # a protein with no positive
    x_local = np.where((rng.random((B, L)) < 0.1) & (tokens >= 4),
                       rng.integers(4, 26, (B, L)), tokens).astype(np.int32)
    x_global = ann * (rng.random((B, 1)) < 0.5)
    w_local = (tokens != 0).astype(np.float32)
    w_global = np.broadcast_to(
        (ann.sum(-1, keepdims=True) > 0).astype(np.float32), ann.shape).copy()
    return ({"local": x_local, "global": x_global},
            {"local": tokens, "global": ann},
            {"local": w_local, "global": w_global})


def _jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tx(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _jax_loss(params, X, Y, W, cfg):
    ll, gl = jmodel.apply(params, X["local"], X["global"], cfg.model,
                          W["local"] > 0)
    return jloss.pretrain_loss(ll, gl, Y, W)


_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_loss, has_aux=True),
                              static_argnums=4)


def _tree_like(params, leaves):
    it = iter(leaves)

    def put(t):
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        if isinstance(t, list):
            return [put(v) for v in t]
        return next(it)

    return put(params)


@pytest.fixture(scope="module")
def same_params():
    jcfg, tcfg = _cfgs()
    jparams = jmodel.init(jax.random.PRNGKey(3), jcfg.model)
    return jparams, params_from_flat(flatten_params(jparams), tcfg.model,
                                     device="cpu")


# ---------------------------------------------------------------- loss

def test_pretrain_loss_and_ranking_match_jax():
    rng = np.random.default_rng(0)
    B, L, V, A = 3, 16, 26, 40
    ll = rng.standard_normal((B, L, V)).astype(np.float32) * 3
    gl = rng.standard_normal((B, A)).astype(np.float32) * 3
    _, Y, W = _corrupted(rng, B, L, A)
    jt, jm = jloss.pretrain_loss(jnp.asarray(ll), jnp.asarray(gl), _jx(Y),
                                 _jx(W))
    tt, tm = tloss.pretrain_loss(torch.from_numpy(ll), torch.from_numpy(gl),
                                 _tx(Y), _tx(W))
    assert abs(float(jt) - float(tt)) <= 1e-6
    for k in jm:
        assert abs(float(jm[k]) - float(tm[k])) <= 1e-6, k
    jr = jloss.global_ranking_metrics(jnp.asarray(gl), jnp.asarray(Y["global"]),
                                      jnp.asarray(W["global"]))
    tr = tloss.global_ranking_metrics(torch.from_numpy(gl),
                                      torch.from_numpy(Y["global"]),
                                      torch.from_numpy(W["global"]))
    for k in jr:
        assert abs(float(jr[k]) - float(tr[k])) <= 1e-6, k


# ----------------------------------------------------------- optimizer

@pytest.mark.parametrize("schedule", ["warmup_cosine", "warmup_plateau",
                                      "constant"])
def test_schedule_matches_optax(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=7, schedule=schedule,
              total_steps=25)
    js = jsched.make_schedule(jconfigs.OptimizerConfig(**kw))
    ts = tsched.make_schedule(tconfigs.OptimizerConfig(**kw))
    assert float(ts(0)) == 0.0
    for c in range(0, 40):
        np.testing.assert_allclose(float(ts(c)), float(js(c)), rtol=1e-6,
                                   atol=1e-12)


def test_optimizer_chain_matches_optax_over_30_steps():
    """Warmup (step 1's LR is 0), a clip that triggers, a plateau cut
    followed by its cooldown, and AdamW's decoupled decay."""
    kw = dict(learning_rate=1e-2, warmup_steps=4, schedule="warmup_plateau",
              plateau_window=2, plateau_patience=2, plateau_cooldown=2,
              plateau_factor=0.5, grad_clip_norm=1.0, weight_decay=0.01)
    jtx = jsched.make_optimizer(jconfigs.OptimizerConfig(**kw))
    ttx = tsched.make_optimizer(tconfigs.OptimizerConfig(**kw))
    rng = np.random.default_rng(7)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jst, tst = jtx.init(jp), ttx.init(tp)
    jupdate = jax.jit(lambda p, g, s, v: j_gradient_update(jtx, p, g, s, v,
                                                           True))
    clipped, scales = 0, []
    for step in range(30):
        scale = 5.0 if step % 3 == 0 else 0.05
        g = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
             for k, v in p0.items()}
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                           for x in g.values()))
        clipped += norm >= kw["grad_clip_norm"]
        # Improving for 8 steps, then flat: the plateau must cut.
        value = np.float32(max(1.0, 3.0 - 0.25 * step))
        jp, jst = jupdate(jp, {k: jnp.asarray(v) for k, v in g.items()},
                          jst, jnp.asarray(value))
        tp, tst = tts.gradient_update(
            ttx, tp, [torch.from_numpy(g[k].copy()) for k in tp], tst,
            torch.tensor(value), True)
        if step == 0:
            for k in p0:
                np.testing.assert_array_equal(tp[k].numpy(), p0[k])
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
        assert float(tst.plateau["scale"]) == float(jst[-1].scale)
        assert int(tst.plateau["cooldown_count"]) == int(
            jst[-1].cooldown_count)
        scales.append(float(tst.plateau["scale"]))
    assert clipped >= 5
    assert min(scales) < 1.0 and scales[-1] < 1.0


# ---------------------------------------------------------- train step

def test_train_step_loss_and_grads_match_jax(same_params):
    jparams, tparams = same_params
    jcfg, tcfg = _cfgs()
    X, Y, W = _corrupted(np.random.default_rng(1), 4, 32, 32)
    (jl, _), jg = _jax_value_and_grad(jparams, _jx(X), _jx(Y), _jx(W), jcfg)
    tg, tm = tts.loss_and_grads(tparams, _tx(X), _tx(Y), _tx(W), tcfg)
    assert abs(float(jl) - float(tm["loss"])) <= 1e-5
    want = flatten_params(jg)
    got = params_to_flat(_tree_like(tparams, tg))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_ten_step_trajectory_tracks_jax(same_params):
    jparams, _ = same_params
    jcfg, tcfg = _cfgs()
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    jtx = jsched.make_optimizer(jcfg.optimizer)
    ttx = tsched.make_optimizer(tcfg.optimizer)
    jst, tst = jtx.init(jparams), ttx.init(tparams)
    jupdate = jax.jit(lambda p, g, s: j_gradient_update(jtx, p, g, s))
    rng = np.random.default_rng(2)
    losses = []
    for _ in range(10):
        X, Y, W = _corrupted(rng, 4, 32, 32)
        (jl, _), jg = _jax_value_and_grad(jparams, _jx(X), _jx(Y), _jx(W),
                                          jcfg)
        jparams, jst = jupdate(jparams, jg, jst)
        tg, tm = tts.loss_and_grads(tparams, _tx(X), _tx(Y), _tx(W), tcfg)
        tparams, tst = tts.gradient_update(ttx, tparams, tg, tst)
        losses.append((float(jl), float(tm["loss"])))
    for jl, tl in losses:
        assert abs(tl - jl) <= 0.01 * abs(jl), losses
    assert losses[-1][0] < losses[0][0]  # the trajectory moves


def test_train_step_advances_and_rejects_packed_batches():
    _, tcfg = _cfgs()
    state = tts.create_train_state(torch.Generator().manual_seed(0), tcfg,
                                   device="cpu")
    rng = np.random.default_rng(3)
    _, Y, _ = _corrupted(rng, 4, 32, 32)
    batch = {"tokens": Y["local"], "annotations": Y["global"]}
    before = [t.clone() for t in tsched.tree_leaves(state.params)]
    state, m = tts.train_step(state, batch, tcfg)
    assert state.step == 1 and float(m["lr"]) == 0.0  # warmup's first LR
    assert all(torch.equal(a, b) for a, b in
               zip(before, tsched.tree_leaves(state.params)))
    state, m = tts.train_step(state, batch, tcfg)
    assert state.step == 2 and np.isfinite(float(m["loss"]))
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, tsched.tree_leaves(state.params)))
    # A packed batch (segment_ids, per-segment annotations) trains too: two
    # proteins a row, the second row one protein and a pad tail.
    tokens = np.zeros((2, 32), np.int32)
    seg = np.zeros((2, 32), np.int32)
    tokens[:, :12], seg[:, :12] = Y["local"][:2, :12], 1
    tokens[:, 0], tokens[:, 11] = 1, 2
    tokens[0, 12:30], seg[0, 12:30] = Y["local"][2, :18], 2
    tokens[0, 12], tokens[0, 29] = 1, 2
    ann = np.zeros((2, 8, 32), np.float32)
    ann[:, :2] = Y["global"][:4].reshape(2, 2, 32)
    packed = {"tokens": tokens, "segment_ids": seg, "annotations": ann}
    before = [t.clone() for t in tsched.tree_leaves(state.params)]
    state, m = tts.train_step(state, packed, tcfg)
    assert state.step == 3 and np.isfinite(float(m["loss"]))
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, tsched.tree_leaves(state.params)))


# --------------------------------------------------------- entry point

def _smoke_cfg():
    cfg = tconfigs.PretrainConfig(
        model=tconfigs.ModelConfig(local_dim=16, global_dim=32, key_dim=8,
                                   num_heads=4, num_blocks=2,
                                   num_annotations=32, dtype="float32"),
        data=tconfigs.DataConfig(seq_len=32, batch_size=8),
        optimizer=tconfigs.OptimizerConfig(
            learning_rate=1e-3, warmup_steps=10, schedule="warmup_cosine",
            total_steps=60),
        train=tconfigs.TrainConfig(max_steps=60, log_every=10,
                                   eval_every=30))
    rng = np.random.default_rng(0)
    seqs, ann = make_random_proteins(64, rng, num_annotations=32, max_len=40)
    ds = InMemoryPretrainingDataset(seqs, ann, cfg.data.seq_len)
    return cfg, ds


def test_pretrain_decreases_loss_on_cpu(monkeypatch):
    """The JAX tiny smoke (tests/test_train.py) on the port: synthetic
    proteins, 60 steps, the logged loss falls."""
    import proteinbert_tpu_torch.train.trainer as trainer_mod

    timers = []

    class SpyTimer(StepTimer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            timers.append(self)

    monkeypatch.setattr(trainer_mod, "StepTimer", SpyTimer)
    cfg, ds = _smoke_cfg()
    seen = []
    out = pretrain(cfg, make_pretrain_iterator(ds, 8, seed=0),
                   eval_batches=lambda: make_pretrain_iterator(
                       ds, 8, seed=1, num_epochs=1),
                   log_fn=lambda step, m: seen.append(step), device="cpu")
    train = [h for h in out["history"] if "loss" in h]
    evals = [h for h in out["history"] if "eval_loss" in h]
    assert len(train) == 6 and [h["step"] for h in evals] == [30, 60]
    first, last = train[0]["loss"], train[-1]["loss"]
    assert np.isfinite(first) and last < first
    assert out["state"].step == 60
    assert 0.0 <= evals[-1]["eval_global_auroc"] <= 1.0
    assert seen == [10, 20, 30, 30, 40, 50, 60, 60]
    perf = out["perf"]
    # 60 steps less the timer's 2 warm-up steps were timed.
    assert len(timers) == 1 and timers[0]._steps_timed == 58
    assert perf["step_ms"] == pytest.approx(1000.0 / perf["steps_per_sec"])
    assert perf["residues_per_sec_per_chip"] == pytest.approx(
        perf["steps_per_sec"] * 8 * 32)   # B·L positions a step
    assert "window_steps_per_sec" in train[-1]   # the log's window rate
    assert "mfu" not in perf and "window_mfu" not in perf  # no CPU peak


def test_pretrain_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    cfg, ds = _smoke_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain(cfg, make_pretrain_iterator(ds, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tts.create_train_state(torch.Generator(), cfg)


def test_flops_match_jax_and_timer_reports_no_cpu_mfu():
    from proteinbert_tpu.train.metrics import forward_flops as jff

    for name in ("tiny", "base", "large"):
        jm = jconfigs.get_preset(name).model
        tm = tconfigs.get_preset(name).model
        assert forward_flops(tm, 8, 1024) == jff(jm, 8, 1024)
    large = tconfigs.get_preset("large").model
    # 12 blocks at B=8, L=1024: ~4.3 TFLOP forward, 3x for a train step.
    assert train_flops(large, 8, 1024) == 3 * forward_flops(large, 8, 1024)
    timer = StepTimer(large, 8, 1024, torch.device("cpu"))
    assert timer.peak is None
