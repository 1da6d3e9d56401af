"""The port's trunk (`proteinbert_tpu_torch.models.proteinbert`) against the
JAX model with the same weights (carried through the flat export layout),
in float32 on the CPU: the tiny preset on the JAX XLA path, and a C=128,
G=128, 2-block config with `use_pallas=True` on the JAX side, so the JAX
trunk runs its Pallas kernels in interpret mode. Each batch holds an
all-pad row. Tolerances: 1e-5 on the trunk (same float32 arithmetic,
another summation order); 1e-4 on the logits, whose head products sum
over the whole trunk width on top of the trunk's error."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.configs import get_preset as jax_preset
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.weights import params_from_flat

TRUNK_TOL = 1e-5
LOGIT_TOL = 1e-4

WIDE = dict(local_dim=128, global_dim=128, key_dim=32, num_heads=4,
            num_blocks=2, num_annotations=64, dtype="float32")


def _configs(kind):
    jcfg, tcfg = jax_preset("tiny").model, get_preset("tiny").model
    if kind == "c128_pallas":
        jcfg = dataclasses.replace(jcfg, use_pallas=True, **WIDE)
        tcfg = dataclasses.replace(tcfg, use_pallas=True, **WIDE)
    return jcfg, tcfg


def _inputs(cfg, L, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 26, (3, L)).astype(np.int32)
    tokens[:, 0] = 1
    tokens[1, L // 3:] = 0    # padded tail
    tokens[2, :] = 0          # all-pad row
    ann = (rng.random((3, cfg.num_annotations)) < 0.05).astype(np.float32)
    return tokens, ann


@pytest.fixture(scope="module", params=["tiny", "c128_pallas"])
def pair(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jmodel.init(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_flat(flatten_params(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _pallas_dispatches():
    """Trace-time counts of JAX dispatches that took a Pallas kernel."""
    from proteinbert_tpu.kernels.attention import ATTN_PATH_TOTAL
    from proteinbert_tpu.kernels.fused_block import PATH_TOTAL
    from proteinbert_tpu.kernels.one_pass import ONEPASS_PATH_TOTAL

    return sum(n for total in (PATH_TOTAL, ATTN_PATH_TOTAL,
                               ONEPASS_PATH_TOTAL)
               for (path, _), n in total.items() if path == "pallas")


def test_encode_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tokens, ann = _inputs(tcfg, 64, 0)
    before = _pallas_dispatches()
    jl, jg = jmodel.encode(jparams, jnp.asarray(tokens), jnp.asarray(ann),
                           jcfg)
    assert (_pallas_dispatches() > before) == jcfg.use_pallas
    tl, tg = tmodel.encode(tparams, torch.from_numpy(tokens),
                           torch.from_numpy(ann), tcfg)
    assert torch.isfinite(tl).all() and torch.isfinite(tg).all()
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=TRUNK_TOL,
                               atol=TRUNK_TOL)
    np.testing.assert_allclose(np.asarray(jg), tg.numpy(), rtol=TRUNK_TOL,
                               atol=TRUNK_TOL)


def test_apply_logits_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tokens, ann = _inputs(tcfg, 32, 1)
    jlog = jmodel.apply(jparams, jnp.asarray(tokens), jnp.asarray(ann), jcfg)
    tlog = tmodel.apply(tparams, torch.from_numpy(tokens),
                        torch.from_numpy(ann), tcfg)
    for j, t in zip(jlog, tlog):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(np.asarray(j), t.numpy(),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_encode_trunk_defaults(pair):
    jcfg, tcfg, jparams, tparams = pair
    tokens, _ = _inputs(tcfg, 32, 2)
    want = jmodel.encode_trunk(jparams, jnp.asarray(tokens), jcfg)
    got = tmodel.encode_trunk(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_array_equal(np.asarray(want["pad_mask"]),
                                  got["pad_mask"].numpy())
    np.testing.assert_allclose(np.asarray(want["global"]),
                               got["global"].numpy(), rtol=TRUNK_TOL,
                               atol=TRUNK_TOL)


def test_init_is_seeded_and_lecun_scaled():
    cfg = get_preset("tiny").model
    a = tmodel.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = tmodel.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = tmodel.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    wk = a["blocks"][0]["narrow_conv"]["kernel"]
    assert torch.equal(wk, b["blocks"][0]["narrow_conv"]["kernel"])
    assert not torch.equal(wk, c["blocks"][0]["narrow_conv"]["kernel"])
    # lecun_normal: variance 1/fan_in, truncated at 2 of its sigmas.
    fan_in = cfg.narrow_kernel * cfg.local_dim
    assert abs(wk.var().item() * fan_in - 1.0) < 0.1
    assert wk.abs().max().item() <= 2 * np.sqrt(1 / fan_in) / .8796 + 1e-6


def test_activation_dtype_follows_the_config():
    cfg = dataclasses.replace(get_preset("tiny").model, dtype="bfloat16")
    params = tmodel.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tokens, ann = _inputs(cfg, 16, 3)
    local, glob = tmodel.encode(params, torch.from_numpy(tokens),
                                torch.from_numpy(ann), cfg)
    assert local.dtype == glob.dtype == torch.bfloat16
    assert torch.isfinite(local.float()).all()
    with pytest.raises(ValueError, match="dtype"):
        tmodel.activation_dtype(dataclasses.replace(cfg, dtype="float7"))
