"""The port's PACKED pretraining against the JAX package on the CPU: the
packed iterator, the packed corruption and weights, the per-segment loss,
the packed train and eval steps, and `pretrain` over packed rows, with the
same weights (carried through the flat export layout) and the same
numpy-made inputs.

Tolerances, float32 throughout: iterator batches and loss weights exact
(the same numpy code and integer arithmetic); the per-segment loss 1e-6
on the same logits (the same formulas, other library kernels); a tiny
packed train step's loss 1e-5 and grads 1e-4 against `jax.grad` of the
JAX packed loss (the same float32 arithmetic in another summation order,
through two blocks); a 10-step trajectory within 1% per step; eval
metrics 1e-5; a protein's per-segment loss terms against the same
protein run alone 1e-5 (two programs of other shapes, so other summation
orders). Corruption draws from a `torch.Generator`, which cannot
reproduce threefry bits, so its rates are held by statistics.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu import configs as jconfigs
from proteinbert_tpu.data import corruption as jcorr
from proteinbert_tpu.data import dataset as jds
from proteinbert_tpu.data import packing as jpack
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.train import loss as jloss
from proteinbert_tpu.train import schedule as jsched
from proteinbert_tpu.train import train_state as jts
from proteinbert_tpu_torch import configs as tconfigs
from proteinbert_tpu_torch.data import corruption as tcorr
from proteinbert_tpu_torch.data import dataset as tds
from proteinbert_tpu_torch.data import packing as tpack
from proteinbert_tpu_torch.data.synthetic import make_random_proteins
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.train import loss as tloss
from proteinbert_tpu_torch.train import schedule as tsched
from proteinbert_tpu_torch.train import train_state as tts
from proteinbert_tpu_torch.train.trainer import pretrain
from proteinbert_tpu_torch.weights import params_from_flat, params_to_flat

MODEL = dict(local_dim=32, global_dim=64, key_dim=16, num_heads=4,
             num_blocks=2, num_annotations=32, dtype="float32")
SEQ_LEN, B, S = 48, 4, 4


def _cfgs(**data):
    """The same PretrainConfig in both packages."""
    kw = dict(
        model=dict(MODEL),
        data=dict(seq_len=SEQ_LEN, batch_size=B, packing=True,
                  pack_max_segments=S, **data),
        optimizer=dict(learning_rate=1e-2, warmup_steps=3,
                       schedule="warmup_cosine", total_steps=10),
        train=dict(max_steps=10, log_every=1),
    )

    def build(mod):
        return mod.PretrainConfig(
            model=mod.ModelConfig(**kw["model"]),
            data=mod.DataConfig(**kw["data"]),
            optimizer=mod.OptimizerConfig(**kw["optimizer"]),
            train=mod.TrainConfig(**kw["train"]))

    return build(jconfigs), build(tconfigs)


def _datasets(n=60, seed=0, max_len=30, crop_seed=None, seq_len=SEQ_LEN):
    seqs, ann = make_random_proteins(n, np.random.default_rng(seed),
                                     MODEL["num_annotations"], max_len,
                                     density=0.1)
    return (jds.InMemoryPretrainingDataset(seqs, ann, seq_len,
                                           crop_seed=crop_seed),
            tds.InMemoryPretrainingDataset(seqs, ann, seq_len,
                                           crop_seed=crop_seed))


def _same_batches(j_it, t_it, n=None):
    """The next n batches (all of them when n is None) of both iterators,
    key for key and bit for bit; returns how many were compared."""
    count = 0
    while n is None or count < n:
        a, b = next(j_it, None), next(t_it, None)
        assert (a is None) == (b is None)
        if a is None:
            break
        assert set(a) == set(b) == {"tokens", "segment_ids", "annotations"}
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        count += 1
    return count


# ------------------------------------------------------------ iterator

@pytest.mark.parametrize("case", ["crops_and_epochs", "skip_batches",
                                  "two_hosts", "subset"])
def test_packed_iterator_matches_jax(case):
    """The same dataset and seed give the JAX iterator's batches: crop
    windows (`crop_seed`) across epoch boundaries, `skip_batches` as
    planner bookkeeping, each host's slice of a two-host global batch, and
    a train/eval split's Subset (its row lengths and block order)."""
    jd, td = _datasets(crop_seed=11 if case == "crops_and_epochs" else None,
                       max_len=70 if case == "crops_and_epochs" else 30)
    kw = dict(seed=3, max_segments=S)
    if case == "crops_and_epochs":
        # Proteins up to 72 tokens against L=48 (a cropped one fills its
        # row alone); 10 batches an epoch, so 24 cross two boundaries.
        assert _same_batches(jpack.make_packed_iterator(jd, B, **kw),
                             tpack.make_packed_iterator(td, B, **kw), 24) == 24
    elif case == "skip_batches":
        full = tpack.make_packed_iterator(td, B, **kw)
        for _ in range(5):
            next(full)
        skipped = tpack.make_packed_iterator(td, B, skip_batches=5, **kw)
        assert _same_batches(full, skipped, 4) == 4
        assert _same_batches(
            jpack.make_packed_iterator(jd, B, skip_batches=5, **kw),
            tpack.make_packed_iterator(td, B, skip_batches=5, **kw), 4) == 4
    elif case == "two_hosts":
        for host in (0, 1):
            assert _same_batches(
                jpack.make_packed_iterator(jd, B, process_index=host,
                                           process_count=2, **kw),
                tpack.make_packed_iterator(td, B, process_index=host,
                                           process_count=2, **kw), 6) == 6
    else:
        (j_tr, _), (t_tr, _) = (mod.train_eval_split(d, 0.25, seed=4)
                                for mod, d in ((jds, jd), (tds, td)))
        np.testing.assert_array_equal(j_tr.row_lengths(), t_tr.row_lengths())
        assert j_tr.shuffle_block == t_tr.shuffle_block
        assert _same_batches(jpack.make_packed_iterator(j_tr, B, **kw),
                             tpack.make_packed_iterator(t_tr, B, **kw), 5) == 5


def test_packed_iterator_bounded_flush_matches_jax(caplog):
    """`num_epochs` bounds the run: the planner is flushed, every full
    batch is emitted as the JAX iterator emits it, and the sub-batch
    remainder is dropped with a warning."""
    jd, td = _datasets(n=57)
    n = _same_batches(
        jpack.make_packed_iterator(jd, B, seed=5, num_epochs=2,
                                   max_segments=S),
        tpack.make_packed_iterator(td, B, seed=5, num_epochs=2,
                                   max_segments=S))
    assert n >= 4
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        batches = list(tpack.make_packed_iterator(td, B, seed=5, num_epochs=2,
                                                  max_segments=S))
    seen = sum(int((np.unique(r) > 0).sum()) for b in batches
               for r in b["segment_ids"])
    dropped = [r.args[0] for r in caplog.records
               if r.name == tpack.__name__
               and "pending sequences" in r.getMessage()]
    # Every protein of both epochs is emitted once or counted as dropped.
    assert len(batches) == n and len(dropped) == 1 and dropped[0] > 0
    assert seen + dropped[0] == 2 * len(td)


# ---------------------------------------------------- corruption, weights

def _packed_batch(seed=0, n=40):
    _, td = _datasets(n=n, seed=seed)
    return next(tpack.make_packed_iterator(td, B, seed=seed, max_segments=S))


def test_packed_weights_equal_jax():
    batch = _packed_batch()
    batch["annotations"][0, 0] = 0.0   # a present segment with no positive
    want = jcorr.packed_weights(*(jnp.asarray(batch[k]) for k in
                                  ("tokens", "segment_ids", "annotations")))
    got = tcorr.packed_weights(*(torch.from_numpy(batch[k]) for k in
                                 ("tokens", "segment_ids", "annotations")))
    for k in ("local", "global"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # Empty segment slots and the segment with no positive weigh 0.
    assert (got["global"][0, 0] == 0).all()
    present = (batch["segment_ids"][..., None] == np.arange(1, S + 1)).any(1)
    assert (got["global"].numpy().sum(-1)[~present] == 0).all()


def test_corrupt_packed_batch_protects_specials_and_draws_per_segment():
    rng = np.random.default_rng(6)
    R, L, Sm, A = 64, 128, 8, 64
    tokens = rng.integers(4, 26, (R, L)).astype(np.int32)
    seg = np.zeros((R, L), np.int32)
    for r in range(R):
        pos = 0
        for sid in range(1, Sm + 1):
            n = int(rng.integers(6, 16))
            tokens[r, pos], tokens[r, pos + n - 1] = 1, 2    # <sos> .. <eos>
            seg[r, pos:pos + n] = sid
            pos += n
        tokens[r, pos:], seg[r, pos:] = 0, 0                 # pad tail
    ann = (rng.random((R, Sm, A)) < 0.3).astype(np.float32)
    X, Y, W = tcorr.corrupt_packed_batch(
        torch.Generator().manual_seed(0), torch.from_numpy(tokens),
        torch.from_numpy(seg), torch.from_numpy(ann))
    x = X["local"].numpy()
    special = tokens < 4
    np.testing.assert_array_equal(x[special], tokens[special])
    rate = (x != tokens)[~special].mean()
    assert abs(rate - 0.05 * 21 / 22) < 0.004, rate
    # One keep/hide draw per (row, segment): 512 draws at p = 0.5.
    g = X["global"].numpy()
    has = (ann > 0).any(-1)
    kept = ~(g == 0).all(-1)
    assert abs(kept[has].mean() - 0.5) < 0.07
    pos = ann[kept] > 0
    assert abs(((g[kept] == 0) & pos).sum() / pos.sum() - 0.25) < 0.03
    np.testing.assert_array_equal(Y["global"].numpy(), ann)
    jw = jcorr.packed_weights(jnp.asarray(tokens), jnp.asarray(seg),
                              jnp.asarray(ann))
    for k in ("local", "global"):
        np.testing.assert_array_equal(W[k].numpy(), np.asarray(jw[k]))


# ---------------------------------------------------------------- loss

def _packed_corrupted(rng, seed=0):
    """A packed batch from the iterator, corrupted with numpy: ~10% of the
    residues replaced, about half the segments' annotations hidden; W the
    packed weights."""
    batch = _packed_batch(seed)
    tokens, seg, ann = (batch[k] for k in
                        ("tokens", "segment_ids", "annotations"))
    x_local = np.where((rng.random(tokens.shape) < 0.1) & (tokens >= 4),
                       rng.integers(4, 26, tokens.shape), tokens
                       ).astype(np.int32)
    x_global = ann * (rng.random(ann.shape[:-1] + (1,)) < 0.5)
    W = jcorr.packed_weights(jnp.asarray(tokens), jnp.asarray(seg),
                             jnp.asarray(ann))
    return ({"local": x_local, "global": x_global.astype(np.float32)},
            {"local": tokens, "global": ann},
            {k: np.array(v) for k, v in W.items()}, seg)


def _jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tx(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_packed_losses_match_jax():
    rng = np.random.default_rng(0)
    _, Y, W, seg = _packed_corrupted(rng)
    R, L = seg.shape
    ll = rng.standard_normal((R, L, 26)).astype(np.float32) * 3
    gl = rng.standard_normal((R, S, MODEL["num_annotations"])).astype(
        np.float32) * 3
    js = jloss.packed_segment_losses(jnp.asarray(ll), jnp.asarray(gl),
                                     _jx(Y), _jx(W), jnp.asarray(seg))
    ts_ = tloss.packed_segment_losses(torch.from_numpy(ll),
                                      torch.from_numpy(gl), _tx(Y), _tx(W),
                                      torch.from_numpy(seg))
    assert set(js) <= set(ts_)
    for k in js:
        np.testing.assert_allclose(ts_[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    jt, jm = jloss.packed_pretrain_loss(jnp.asarray(ll), jnp.asarray(gl),
                                        _jx(Y), _jx(W), jnp.asarray(seg))
    tt, tm = tloss.packed_pretrain_loss(torch.from_numpy(ll),
                                        torch.from_numpy(gl), _tx(Y), _tx(W),
                                        torch.from_numpy(seg))
    assert abs(float(jt) - float(tt)) <= 1e-6
    for k in jm:
        assert abs(float(jm[k]) - float(tm[k])) <= 1e-6, k


# ---------------------------------------------------------- train step

def _jax_packed_loss(params, X, Y, W, seg, cfg):
    ll, gl = jmodel.apply(params, X["local"], X["global"], cfg.model,
                          segment_ids=seg)
    return jloss.packed_pretrain_loss(ll, gl, Y, W, seg)


_jax_value_and_grad = jax.jit(
    jax.value_and_grad(_jax_packed_loss, has_aux=True), static_argnums=5)


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


def test_packed_loss_and_grads_match_jax(same_params):
    jparams, tparams = same_params
    jcfg, tcfg = _cfgs()
    X, Y, W, seg = _packed_corrupted(np.random.default_rng(1))
    (jl, _), jg = _jax_value_and_grad(jparams, _jx(X), _jx(Y), _jx(W),
                                      jnp.asarray(seg), jcfg)
    tg, tm = tts.loss_and_grads(tparams, _tx(X), _tx(Y), _tx(W), tcfg,
                                torch.from_numpy(seg))
    assert abs(float(jl) - float(tm["loss"])) <= 1e-5
    want = flatten_params(jg)
    got = params_to_flat(_tree_like(tparams, tg))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_packed_ten_step_trajectory_tracks_jax(same_params):
    jparams, _ = same_params
    jcfg, tcfg = _cfgs()
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    jtx = jsched.make_optimizer(jcfg.optimizer)
    ttx = tsched.make_optimizer(tcfg.optimizer)
    jst, tst = jtx.init(jparams), ttx.init(tparams)
    jupdate = jax.jit(lambda p, g, s: jts.gradient_update(jtx, p, g, s))
    rng = np.random.default_rng(2)
    losses = []
    for step in range(10):
        X, Y, W, seg = _packed_corrupted(rng, seed=step)
        (jl, _), jg = _jax_value_and_grad(jparams, _jx(X), _jx(Y), _jx(W),
                                          jnp.asarray(seg), jcfg)
        jparams, jst = jupdate(jparams, jg, jst)
        tg, tm = tts.loss_and_grads(tparams, _tx(X), _tx(Y), _tx(W), tcfg,
                                    torch.from_numpy(seg))
        tparams, tst = tts.gradient_update(ttx, tparams, tg, tst)
        losses.append((float(jl), float(tm["loss"])))
    for jl, tl in losses:
        assert abs(tl - jl) <= 0.01 * abs(jl), losses
    assert losses[-1][0] < losses[0][0]  # the trajectory moves


def test_packed_eval_step_matches_jax(same_params):
    """With corruption set to the identity (keep every annotation vector,
    replace, drop and add nothing) both eval steps score the same inputs:
    the per-segment loss metrics and the ranking metrics over the
    flattened (B·S, A) equal the JAX eval step's."""
    jparams, tparams = same_params
    ident = dict(token_randomize_prob=0.0, annotation_corrupt_prob=1.0,
                 annotation_drop_prob=0.0, annotation_add_prob=0.0)
    jcfg, tcfg = _cfgs(**ident)
    batch = _packed_batch(seed=4)
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                            opt_state=None, key=jax.random.PRNGKey(0))
    want = jts.eval_step(jstate, _jx(batch), jax.random.PRNGKey(1), jcfg)
    tstate = tts.TrainState(0, tparams, None,
                            torch.Generator().manual_seed(0))
    got = tts.eval_step(tstate, batch, torch.Generator().manual_seed(1),
                        tcfg)
    keys = [k for k in want if k != "ranking_stats"]
    assert set(keys) <= set(got)
    assert {"global_auroc", "loss"} <= set(keys)
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_packed_vs_solo_per_segment_parity():
    """Each packed protein's local logits and per-segment loss terms equal
    the same protein run alone as an unpacked row of its own length (no
    pad, so the unmasked convs read the same zeros outside the protein the
    masked ones do), through the dense path: the JAX
    `test_packed_vs_solo_per_sequence_parity` on the port."""
    _, tcfg = _cfgs()
    params = tmodel.init(tcfg.model, torch.Generator().manual_seed(7),
                         device="cpu")
    batch = _tx(_packed_batch(seed=2))
    seg = batch["segment_ids"]
    Y = {"local": batch["tokens"], "global": batch["annotations"]}
    W = tcorr.packed_weights(Y["local"], seg, Y["global"])
    with torch.no_grad():
        ll, gl = tmodel.apply(params, Y["local"], Y["global"], tcfg.model,
                              segment_ids=seg)
        per_seg = tloss.packed_segment_losses(ll, gl, Y, W, seg)
        n = 0
        for r in range(seg.shape[0]):
            for s in range(1, S + 1):
                mask = seg[r] == s
                if not mask.any():
                    continue
                n += 1
                toks = Y["local"][r][mask][None]
                ann = Y["global"][r, s - 1][None]
                ll1, gl1 = tmodel.apply(params, toks, ann, tcfg.model)
                _, m1 = tloss.pretrain_loss(
                    ll1, gl1, {"local": toks, "global": ann},
                    tcorr.pretrain_weights(toks, ann))
                np.testing.assert_allclose(ll[r][mask].numpy(),
                                           ll1[0].numpy(), atol=1e-5,
                                           rtol=1e-5)
                np.testing.assert_allclose(gl[r, s - 1].numpy(),
                                           gl1[0].numpy(), atol=1e-5,
                                           rtol=1e-5)
                for k, k1 in (("local", "local_loss"),
                              ("global", "global_loss")):
                    assert abs(float(per_seg[k][r, s - 1])
                               - float(m1[k1])) <= 1e-5, (r, s, k)
    assert n >= 2 * seg.shape[0]


# ------------------------------------------------------------ pretrain

def test_pretrain_on_packed_rows_decreases_loss_on_cpu():
    """`pretrain` over `make_packed_iterator`: synthetic proteins about
    three to a row, 60 steps, the logged loss falls; a packed eval runs."""
    cfg = tconfigs.PretrainConfig(
        model=tconfigs.ModelConfig(local_dim=16, global_dim=32, key_dim=8,
                                   num_heads=4, num_blocks=2,
                                   num_annotations=32, dtype="float32"),
        data=tconfigs.DataConfig(seq_len=64, batch_size=8, packing=True,
                                 pack_max_segments=8),
        optimizer=tconfigs.OptimizerConfig(
            learning_rate=1e-3, warmup_steps=10, schedule="warmup_cosine",
            total_steps=60),
        train=tconfigs.TrainConfig(max_steps=60, log_every=10,
                                   eval_every=30))
    seqs, ann = make_random_proteins(96, np.random.default_rng(0),
                                     num_annotations=32, max_len=40)
    ds = tds.InMemoryPretrainingDataset(seqs, ann, cfg.data.seq_len)
    first = next(tpack.make_packed_iterator(ds, 8, seed=0))
    assert first["segment_ids"].max(1).mean() >= 2   # packed, not one a row
    out = pretrain(cfg, tpack.make_packed_iterator(ds, 8, seed=0),
                   eval_batches=lambda: tpack.make_packed_iterator(
                       ds, 8, seed=1, num_epochs=1),
                   device="cpu")
    train = [h for h in out["history"] if "loss" in h]
    evals = [h for h in out["history"] if "eval_loss" in h]
    assert len(train) == 6 and [h["step"] for h in evals] == [30, 60]
    assert np.isfinite(train[0]["loss"]) and train[-1]["loss"] < train[0][
        "loss"]
    assert 0.0 <= evals[-1]["eval_global_auroc"] <= 1.0
    assert out["state"].step == 60
