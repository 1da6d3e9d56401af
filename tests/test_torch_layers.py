"""The port's layers (proteinbert_tpu_torch.ops) against the JAX package's
(proteinbert_tpu.ops) on the same numpy-seeded inputs, in float32.
Tolerance 1e-5: the same float32 arithmetic, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.ops import attention as jattn
from proteinbert_tpu.ops import layers as jlayers
from proteinbert_tpu_torch.ops import attention as tattn
from proteinbert_tpu_torch.ops import layers as tlayers

TOL = 1e-5


def _pair(tree):
    """numpy tree → (jax tree, torch tree)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close(jx, tx):
    np.testing.assert_allclose(np.asarray(jx), tx.numpy(), rtol=TOL,
                               atol=TOL)


def test_dense():
    rng = np.random.default_rng(0)
    p = {"kernel": rng.standard_normal((48, 32)).astype(np.float32) / 7,
         "bias": rng.standard_normal(32).astype(np.float32)}
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    jp, tp = _pair(p)
    _close(jlayers.dense_apply(jp, jnp.asarray(x)),
           tlayers.dense_apply(tp, torch.from_numpy(x)))


def test_layer_norm():
    rng = np.random.default_rng(1)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    x = (3 + 2 * rng.standard_normal((4, 7, 64))).astype(np.float32)
    jp, tp = _pair(p)
    _close(jlayers.layer_norm_apply(jp, jnp.asarray(x)),
           tlayers.layer_norm_apply(tp, torch.from_numpy(x)))


@pytest.mark.parametrize("dilation", [1, 5])
def test_conv1d_same_dilated(dilation):
    rng = np.random.default_rng(2 + dilation)
    p = {"kernel": rng.standard_normal((9, 32, 32)).astype(np.float32) / 17,
         "bias": rng.standard_normal(32).astype(np.float32)}
    x = rng.standard_normal((2, 40, 32)).astype(np.float32)
    jp, tp = _pair(p)
    _close(jlayers.conv1d_apply(jp, jnp.asarray(x), dilation),
           tlayers.conv1d_apply(tp, torch.from_numpy(x), dilation))


def test_embedding():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((26, 16)).astype(np.float32)
    ids = rng.integers(0, 26, (3, 11)).astype(np.int32)
    _close(jlayers.embedding_apply({"embedding": jnp.asarray(table)},
                                   jnp.asarray(ids)),
           tlayers.embedding_apply({"embedding": torch.from_numpy(table)},
                                   torch.from_numpy(ids)))


def test_gelu_is_the_tanh_form():
    import jax

    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(jax.nn.gelu(jnp.asarray(x)), tlayers.gelu(torch.from_numpy(x)))


def test_global_attention_with_padding():
    rng = np.random.default_rng(4)
    B, L, C, G, H, k = 3, 24, 32, 64, 4, 8
    p = {"wq": rng.standard_normal((H, G, k)).astype(np.float32) / 8,
         "wk": rng.standard_normal((H, C, k)).astype(np.float32) / 6,
         "wv": rng.standard_normal((H, C, G // H)).astype(np.float32) / 6}
    local = rng.standard_normal((B, L, C)).astype(np.float32)
    glob = rng.standard_normal((B, G)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, L // 2:] = False   # half-padded row
    mask[2] = False            # all-pad row: uniform softmax, not NaN
    jp, tp = _pair(p)
    want = jattn.global_attention_apply(jp, jnp.asarray(local),
                                        jnp.asarray(glob), jnp.asarray(mask))
    got = tattn.global_attention_apply(tp, torch.from_numpy(local),
                                       torch.from_numpy(glob),
                                       torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    _close(want, got)
