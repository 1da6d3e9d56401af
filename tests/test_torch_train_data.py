"""The port's pretraining data path (`proteinbert_tpu_torch.data`) against
the JAX package on the CPU: tokenization, synthetic proteins, the batch
iterator (crop windows, shards, skip_batches) and the train/eval split
must give the JAX package's ids and rows exactly. Corruption draws from a
`torch.Generator`, which cannot reproduce threefry bits, so it is held to
the JAX semantics by statistics (rates within a few standard errors at
these sizes) and the loss weights exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.data import corruption as jcorr
from proteinbert_tpu.data import dataset as jds
from proteinbert_tpu.data import synthetic as jsyn
from proteinbert_tpu.data import transforms as jtr
from proteinbert_tpu_torch.data import corruption as tcorr
from proteinbert_tpu_torch.data import dataset as tds
from proteinbert_tpu_torch.data import synthetic as tsyn
from proteinbert_tpu_torch.data import transforms as ttr

torch.set_num_threads(1)


def _proteins(n=40, seed=0, max_len=90):
    return tsyn.make_random_proteins(n, np.random.default_rng(seed), 16,
                                     max_len)


def test_synthetic_proteins_match_jax():
    got = tsyn.make_random_proteins(12, np.random.default_rng(5), 24, 60)
    want = jsyn.make_random_proteins(12, np.random.default_rng(5), 24, 60)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("crop_seed", [None, 1234])
def test_tokenize_batch_matches_jax(crop_seed):
    seqs, _ = _proteins()
    seqs += ["ACDXZ" * 30, "", "mkt"]   # long, empty, lower-case, unknown
    rows = np.arange(100, 100 + len(seqs))
    want = jtr.tokenize_batch(seqs, 48, crop_seed, rows)
    got = ttr.tokenize_batch(seqs, 48, crop_seed, rows)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for i in (0, len(seqs) - 3):
        np.testing.assert_array_equal(
            ttr.tokenize(seqs[i], 48, crop_seed, int(rows[i])),
            jtr.tokenize(seqs[i], 48, crop_seed, int(rows[i])))
    assert ttr.epoch_crop_seed(7, 3) == jtr.epoch_crop_seed(7, 3)
    assert ttr.random_crop("ACDEFGHIKL", 4, 9, 2) == jtr.random_crop(
        "ACDEFGHIKL", 4, 9, 2)


def test_pretrain_iterator_matches_jax_with_crops_and_skips():
    seqs, ann = _proteins(n=50, max_len=120)
    tds_ = tds.InMemoryPretrainingDataset(seqs, ann, 64, crop_seed=11)
    jds_ = jds.InMemoryPretrainingDataset(seqs, ann, 64, crop_seed=11)
    for skip in (0, 5):
        t_it = tds.make_pretrain_iterator(tds_, 8, seed=3, skip_batches=skip)
        j_it = jds.make_pretrain_iterator(jds_, 8, seed=3, skip_batches=skip)
        for _ in range(14):   # crosses two epoch boundaries (6 batches each)
            a, b = next(t_it), next(j_it)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["annotations"],
                                          b["annotations"])
    # Skipping equals draining, and per-host shards are the JAX ones.
    full = tds.make_pretrain_iterator(tds_, 8, seed=3)
    for _ in range(5):
        next(full)
    np.testing.assert_array_equal(
        next(full)["tokens"],
        next(tds.make_pretrain_iterator(tds_, 8, seed=3,
                                        skip_batches=5))["tokens"])
    a = next(tds.make_pretrain_iterator(tds_, 8, seed=3, process_index=1,
                                        process_count=2))
    b = next(jds.make_pretrain_iterator(jds_, 8, seed=3, process_index=1,
                                        process_count=2))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError, match="cannot fill"):
        next(tds.make_pretrain_iterator(tds_, 64))


def test_train_eval_split_matches_jax():
    seqs, ann = _proteins()
    t_tr, t_ev = tds.train_eval_split(
        tds.InMemoryPretrainingDataset(seqs, ann, 32), 0.2, seed=4)
    j_tr, j_ev = jds.train_eval_split(
        jds.InMemoryPretrainingDataset(seqs, ann, 32), 0.2, seed=4)
    assert len(t_tr) == len(j_tr) and len(t_ev) == len(j_ev)
    np.testing.assert_array_equal(t_ev.get_batch(np.arange(len(t_ev)))[
        "tokens"], j_ev.get_batch(np.arange(len(j_ev)))["tokens"])
    a = next(tds.make_pretrain_iterator(t_tr, 4, seed=1))
    b = next(jds.make_pretrain_iterator(j_tr, 4, seed=1))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def _clean_batch(rng, B=512, L=128, A=64):
    tokens = rng.integers(4, 26, (B, L)).astype(np.int32)
    tokens[:, 0] = 1
    tokens[:, L // 2] = 3                  # an <unk> mid-row
    tokens[:, -20] = 2
    tokens[:, -19:] = 0                    # pad tail
    ann = (rng.random((B, A)) < 0.3).astype(np.float32)
    ann[:8] = 0.0                          # proteins with no positive
    return tokens, ann


def test_corruption_rates_and_weights():
    tokens, ann = _clean_batch(np.random.default_rng(6))
    gen = torch.Generator().manual_seed(0)
    X, Y, W = tcorr.corrupt_batch(gen, torch.from_numpy(tokens),
                                  torch.from_numpy(ann))
    x = X["local"].numpy()
    assert X["local"].dtype == torch.int32
    special = tokens < 4
    np.testing.assert_array_equal(x[special], tokens[special])
    replaced = x != tokens
    # Replacement draws may hit the same residue: the observed change
    # rate is 0.05 · 21/22.
    rate = replaced[~special].mean()
    assert abs(rate - 0.05 * 21 / 22) < 0.003, rate
    assert x[~special].min() >= 4 and x[~special].max() <= 25
    g = X["global"].numpy()
    hidden = (g == 0).all(-1) & (ann > 0).any(-1)
    assert abs(hidden.mean() / (ann > 0).any(-1).mean() - 0.5) < 0.07
    kept = ~(g == 0).all(-1)
    pos = ann[kept] > 0
    dropped = (g[kept] == 0) & pos
    assert abs(dropped.sum() / pos.sum() - 0.25) < 0.02
    assert set(np.unique(g)) <= {0.0, 1.0}
    # Y is the clean batch; W is the JAX weights exactly.
    np.testing.assert_array_equal(Y["local"].numpy(), tokens)
    jw = jcorr.pretrain_weights(jnp.asarray(tokens), jnp.asarray(ann))
    for k in ("local", "global"):
        np.testing.assert_array_equal(W[k].numpy(), np.asarray(jw[k]))


def test_corruption_is_seeded_and_add_prob_flips_negatives():
    tokens, ann = _clean_batch(np.random.default_rng(7), B=256, A=512)
    a = tcorr.corrupt_batch(torch.Generator().manual_seed(1),
                            torch.from_numpy(tokens), torch.from_numpy(ann))
    b = tcorr.corrupt_batch(torch.Generator().manual_seed(1),
                            torch.from_numpy(tokens), torch.from_numpy(ann))
    assert torch.equal(a[0]["local"], b[0]["local"])
    assert torch.equal(a[0]["global"], b[0]["global"])
    g = tcorr.corrupt_annotations(torch.Generator().manual_seed(2),
                                  torch.zeros(4000, 64), 1.0, 0.25, 0.01)
    assert abs(g.mean().item() - 0.01) < 0.002
