"""The slice as a whole on the CPU: the port's `inference` entry points
against the JAX package's on the same tiny-preset weights (float32).
Tolerance 1e-5 on representations and probabilities (the same float32
arithmetic, summed in another order)."""

import jax
import numpy as np
import pytest
import torch

from proteinbert_tpu import inference as jinf
from proteinbert_tpu.configs import get_preset as jax_preset
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu_torch import inference as tinf
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.weights import params_from_flat

torch.set_num_threads(1)

TOL = 1e-5
SEQS = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWY" * 3, "GG",
        "MKT?YIAK?RQIS", "W" * 40]
BUCKETS = (32, 64, 128)


@pytest.fixture(scope="module")
def trunk():
    jcfg, tcfg = jax_preset("tiny"), get_preset("tiny")
    jparams = jmodel.init(jax.random.PRNGKey(11), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close(want, got):
    np.testing.assert_allclose(want, got, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("per_residue", [False, True])
def test_embed(trunk, per_residue):
    jcfg, tcfg, jparams, tparams = trunk
    want = jinf.embed(jparams, jcfg, SEQS, batch_size=4,
                      per_residue=per_residue)
    got = tinf.embed(tparams, tcfg, SEQS, batch_size=4,
                     per_residue=per_residue, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        _close(want[k], got[k])


def test_embed_bucketed(trunk):
    jcfg, tcfg, jparams, tparams = trunk
    want = jinf.embed(jparams, jcfg, SEQS, batch_size=2, bucketed=True,
                      buckets=BUCKETS)
    got = tinf.embed(tparams, tcfg, SEQS, batch_size=2, bucketed=True,
                     buckets=BUCKETS, device="cpu")
    for k in want:
        _close(want[k], got[k])


def test_predict_go_and_top_k(trunk):
    jcfg, tcfg, jparams, tparams = trunk
    want = jinf.predict_go(jparams, jcfg, SEQS, batch_size=4)
    got = tinf.predict_go(tparams, tcfg, SEQS, batch_size=4, device="cpu")
    assert got.shape == (len(SEQS), tcfg.model.num_annotations)
    _close(want, got)
    top = tinf.predict_go(tparams, tcfg, SEQS[:1], top_k=3, device="cpu")
    assert [j for j, _ in top[0]] == list(np.argsort(-got[0])[:3])


@pytest.mark.parametrize("bucketed", [False, True])
def test_predict_residues(trunk, bucketed):
    jcfg, tcfg, jparams, tparams = trunk
    kw = dict(batch_size=4, bucketed=bucketed, buckets=BUCKETS)
    want_seqs, want = jinf.predict_residues(jparams, jcfg, SEQS, **kw)
    got_seqs, got = tinf.predict_residues(tparams, tcfg, SEQS, device="cpu",
                                          **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(want, got)
    assert got_seqs == want_seqs
    assert "?" not in got_seqs[3] and got_seqs[3][:3] == "MKT"


def test_overflow_and_mask_rules(trunk):
    _, tcfg, _, tparams = trunk
    window = tcfg.data.seq_len - 2
    with pytest.raises(tinf.SequenceTooLongError):
        tinf.embed(tparams, tcfg, ["A" * (window + 1)], on_overflow="error",
                   device="cpu")
    before = tinf.TRUNCATED_TOTAL[0]
    out = tinf.embed(tparams, tcfg, ["A" * (window + 5)],
                     on_overflow="count", device="cpu")
    assert tinf.TRUNCATED_TOTAL[0] == before + 1
    assert np.isfinite(out["global"]).all()
    with pytest.raises(ValueError, match="beyond position"):
        tinf.predict_residues(tparams, tcfg, ["A" * window + "?"],
                              device="cpu")
    with pytest.raises(ValueError, match="per_residue"):
        tinf.embed(tparams, tcfg, SEQS, per_residue=True, bucketed=True,
                   device="cpu")
