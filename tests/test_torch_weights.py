"""Weights carried from the JAX package into the port and back: the flat
layout of `proteinbert_tpu.export.flatten_params` round-trips bit-exactly,
and a `pbt export` NPZ loads straight into the port."""

import jax
import numpy as np
import pytest
import torch

from proteinbert_tpu.configs import get_preset as jax_preset
from proteinbert_tpu.export import export_params, flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.weights import (
    expected_shapes, load_npz, params_from_flat, params_to_flat,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flat():
    cfg = jax_preset("tiny").model
    return flatten_params(jmodel.init(jax.random.PRNGKey(3), cfg))


def test_round_trip_is_bit_exact(flat):
    cfg = get_preset("tiny").model
    params = params_from_flat(flat, cfg, device="cpu")
    back = params_to_flat(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_layout_matches_the_config(flat):
    cfg = get_preset("tiny").model
    assert {k: v.shape for k, v in flat.items()} == expected_shapes(cfg)
    params = params_from_flat(flat, cfg, device="cpu")
    assert len(params["blocks"]) == cfg.num_blocks
    assert tuple(params["blocks"][1]["attention"]["wk"].shape) == (
        cfg.num_heads, cfg.local_dim, cfg.key_dim)


def test_reads_an_export_npz(flat, tmp_path):
    cfg = get_preset("tiny").model
    jcfg = jax_preset("tiny").model
    path = tmp_path / "trunk.npz"
    export_params(jmodel.init(jax.random.PRNGKey(3), jcfg), str(path))
    params = load_npz(str(path), cfg, device="cpu")
    back = params_to_flat(params)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_mismatched_checkpoints_are_refused(flat):
    cfg = get_preset("tiny").model
    missing = dict(flat)
    missing.pop("blocks/1/local_ln2/scale")
    with pytest.raises(ValueError, match="missing"):
        params_from_flat(missing, cfg, device="cpu")
    extra = dict(flat, **{"blocks/2/local_ln2/scale": flat[
        "blocks/1/local_ln2/scale"]})
    with pytest.raises(ValueError, match="unexpected"):
        params_from_flat(extra, cfg, device="cpu")
    wrong = dict(flat)
    wrong["blocks/0/attention/wq"] = flat["blocks/0/attention/wq"][:, :, :1]
    with pytest.raises(ValueError, match="shape"):
        params_from_flat(wrong, cfg, device="cpu")
