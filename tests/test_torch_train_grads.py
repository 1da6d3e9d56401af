"""Gradients of the port's kernel wrappers on the CPU against the JAX
package's custom VJPs, on the same numpy-seeded inputs.

Every wrapper is a `torch.autograd.Function` (`kernels/autograd.py`) whose
forward here is the plain version (CPU tensors) and whose backward
recomputes that plain version — the code path the card runs after its
kernel. The JAX side differentiates through `jax.custom_vjp` with the
Pallas forward in interpret mode. Tolerances: float32 1e-4 (the same
gradient by another summation order, accumulated over a row of taps);
#2 in bfloat16 at C=1024 rtol 0.05 / atol 0.1, the JAX package's own
tiled-gradient tolerance (tests/test_kernels.py), because the two
recomputes round the conv outputs at different points in bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.kernels import attention as jattn
from proteinbert_tpu.kernels import fused_block as jfused
from proteinbert_tpu.kernels import one_pass as jone
from proteinbert_tpu_torch.kernels import attention as tattn
from proteinbert_tpu_torch.kernels import fused_block as tfused
from proteinbert_tpu_torch.kernels import one_pass as tone
from proteinbert_tpu_torch.kernels.autograd import _split, recompute_vjp

TOL = 1e-4


def _track_params(rng, C):
    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def vec(base=0.0):
        return (base + 0.1 * rng.standard_normal(C)).astype(np.float32)

    return {"narrow_conv": {"kernel": w((9, C, C), 9 * C), "bias": vec()},
            "wide_conv": {"kernel": w((9, C, C), 9 * C), "bias": vec()},
            "local_ln1": {"scale": vec(1.0), "bias": vec()},
            "local_dense": {"kernel": w((C, C), C), "bias": vec()},
            "local_ln2": {"scale": vec(1.0), "bias": vec()}}


def _attn_params(rng, C, G, H, K):
    return {"wq": (rng.standard_normal((H, G, K)) / np.sqrt(G)).astype(
                np.float32),
            "wk": (rng.standard_normal((H, C, K)) / np.sqrt(C)).astype(
                np.float32),
            "wv": (rng.standard_normal((H, C, G // H)) / np.sqrt(C)).astype(
                np.float32)}


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _torch_sorted(tree):
    """numpy tree → torch tree with dict keys in sorted order, the order
    `jax.tree.leaves` walks."""
    if isinstance(tree, dict):
        return {k: _torch_sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(_torch_sorted(v) for v in tree)
    return torch.from_numpy(np.asarray(tree))


def _leaf_tensors(tree):
    """numpy tree → torch tree whose leaves require grad, and the leaves
    in `jax.tree.leaves` order."""
    leaves, fill = _split(_torch_sorted(tree))
    ts = [t.requires_grad_(True) for t in leaves]
    return fill(ts), ts


def _check(jgrads, tgrads, rtol=TOL, atol=TOL):
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(tgrads)
    for j, t in zip(jl, tgrads):
        assert t is not None
        np.testing.assert_allclose(np.asarray(j, np.float32),
                                   t.float().numpy(), rtol=rtol, atol=atol)


def _segments(B, L):
    seg = np.zeros((B, L), np.int32)
    seg[0, :20], seg[0, 20:45], seg[0, 48:60] = 1, 2, 3
    seg[1, :10], seg[1, 10:30], seg[1, 30:36], seg[1, 36:64] = 1, 2, 6, 4
    return seg


def test_recompute_vjp_saves_inputs_and_skips_ids():
    """The Function's contract: the forward it is given runs once, the
    backward differentiates the plain version, ints/ids get no grad."""
    calls = []

    def run(p, x, ids, scale):
        calls.append("run")
        return (p["w"] * x * scale)[ids]

    def plain(p, x, ids, scale):
        calls.append("plain")
        return (p["w"] * x * scale)[ids]

    w = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    x = torch.tensor([4.0, 5.0, 6.0], requires_grad=True)
    ids = torch.tensor([0, 2])
    out = recompute_vjp(run, plain, {"w": w}, x, ids, 2.0)
    assert calls == ["run"]
    out.sum().backward()
    assert calls == ["run", "plain"]
    assert torch.equal(w.grad, torch.tensor([8.0, 0.0, 12.0]))
    assert torch.equal(x.grad, torch.tensor([2.0, 0.0, 6.0]))


def test_local_track_grads_match_jax_vjp():
    rng = np.random.default_rng(0)
    C, B, L = 128, 2, 64
    p = _track_params(rng, C)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    bc = rng.standard_normal((B, C)).astype(np.float32)
    r = rng.standard_normal((B, L, C)).astype(np.float32)

    def jf(pp, xx, bb):
        return (jfused.fused_local_track(pp, xx, bb, 1, 5, True) * r).sum()

    jg = jax.grad(jf, argnums=(0, 1, 2))(_jax(p), jnp.asarray(x),
                                          jnp.asarray(bc))
    (tp, tx, tb), leaves = _leaf_tensors((p, x, bc))
    (tfused.fused_local_track(tp, tx, tb, 1, 5)
     * torch.from_numpy(r)).sum().backward()
    _check(jg, [t.grad for t in leaves])


def test_segment_track_grads_match_jax_vjp():
    rng = np.random.default_rng(1)
    C, B, L, S = 128, 2, 64, 4
    p = _track_params(rng, C)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    bs = rng.standard_normal((B, S, C)).astype(np.float32)
    seg = _segments(B, L)
    r = rng.standard_normal((B, L, C)).astype(np.float32)

    def jf(pp, xx, bb):
        return (jfused.fused_local_track_segments(
            pp, xx, bb, jnp.asarray(seg), 1, 5, True) * r).sum()

    jg = jax.grad(jf, argnums=(0, 1, 2))(_jax(p), jnp.asarray(x),
                                          jnp.asarray(bs))
    (tp, tx, tb), leaves = _leaf_tensors((p, x, bs))
    (tfused.fused_local_track_segments(tp, tx, tb, torch.from_numpy(seg),
                                       1, 5) * torch.from_numpy(r)
     ).sum().backward()
    _check(jg, [t.grad for t in leaves])


@pytest.mark.parametrize("entry", ["dense", "packed"])
def test_attention_grads_match_jax_vjp(entry):
    rng = np.random.default_rng(2)
    C, G, H, K, B, L = 128, 128, 4, 32, 3, 64
    p = _attn_params(rng, C, G, H, K)
    local = rng.standard_normal((B, L, C)).astype(np.float32)
    if entry == "dense":
        glob = rng.standard_normal((B, G)).astype(np.float32)
        mask = np.ones((B, L), bool)
        mask[1, L // 2:] = False
        mask[2] = False
        r = rng.standard_normal((B, G)).astype(np.float32)

        def jrun(pp, ll, gg):
            return jattn.fused_global_attention(pp, ll, gg, jnp.asarray(mask),
                                                interpret=True)

        def trun(pp, ll, gg):
            return tattn.fused_global_attention(pp, ll, gg,
                                                torch.from_numpy(mask))
    else:
        S = 3
        glob = rng.standard_normal((B, S, G)).astype(np.float32)
        seg = rng.integers(0, 3, (B, L)).astype(np.int32)  # segment 3 empty
        real = rng.random((B, L)) < 0.9
        r = rng.standard_normal((B, S, G)).astype(np.float32)

        def jrun(pp, ll, gg):
            return jattn.fused_packed_attention(
                pp, ll, gg, jnp.asarray(seg), jnp.asarray(real),
                interpret=True)

        def trun(pp, ll, gg):
            return tattn.fused_packed_attention(
                pp, ll, gg, torch.from_numpy(seg), torch.from_numpy(real))

    jg = jax.grad(lambda pp, ll, gg: (jrun(pp, ll, gg) * r).sum(),
                  argnums=(0, 1, 2))(_jax(p), jnp.asarray(local),
                                     jnp.asarray(glob))
    (tp, tl, tg), leaves = _leaf_tensors((p, local, glob))
    (trun(tp, tl, tg) * torch.from_numpy(r)).sum().backward()
    _check(jg, [t.grad for t in leaves])


@pytest.mark.parametrize("entry", ["dense", "packed"])
def test_onepass_grads_match_jax_vjp(entry):
    """#6 at the reference model's head shape (C=128, G=512, H=4, k=64,
    v=128), where the one-pass rule admits it on both sides."""
    rng = np.random.default_rng(3)
    C, G, H, K, B, L, S = 128, 512, 4, 64, 2, 64, 4
    tp_np = _track_params(rng, C)
    ap_np = _attn_params(rng, C, G, H, K)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    if entry == "dense":
        bc = rng.standard_normal((B, C)).astype(np.float32)
        glob = rng.standard_normal((B, G)).astype(np.float32)
        mask = np.ones((B, L), bool)
        mask[1, 40:] = False
        rl = rng.standard_normal((B, L, C)).astype(np.float32)
        ra = rng.standard_normal((B, G)).astype(np.float32)

        def jrun(tp, ap, xx, bb, gg):
            return jone.fused_onepass_dense(tp, ap, xx, bb, gg,
                                            jnp.asarray(mask), 1, 5, True)

        def trun(tp, ap, xx, bb, gg):
            return tone.fused_onepass_dense(tp, ap, xx, bb, gg,
                                            torch.from_numpy(mask), 1, 5)
    else:
        bc = rng.standard_normal((B, S, C)).astype(np.float32)
        glob = rng.standard_normal((B, S, G)).astype(np.float32)
        seg = _segments(B, L)
        real = rng.random((B, L)) < 0.9
        rl = rng.standard_normal((B, L, C)).astype(np.float32)
        ra = rng.standard_normal((B, S, G)).astype(np.float32)

        def jrun(tp, ap, xx, bb, gg):
            return jone.fused_onepass_segments(
                tp, ap, xx, bb, gg, jnp.asarray(seg), jnp.asarray(real),
                1, 5, True)

        def trun(tp, ap, xx, bb, gg):
            return tone.fused_onepass_segments(
                tp, ap, xx, bb, gg, torch.from_numpy(seg),
                torch.from_numpy(real), 1, 5)

    def jf(*args):
        local, attn = jrun(*args)
        return (local * rl).sum() + (attn * ra).sum()

    jg = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(
        _jax(tp_np), _jax(ap_np), jnp.asarray(x), jnp.asarray(bc),
        jnp.asarray(glob))
    args, leaves = _leaf_tensors((tp_np, ap_np, x, bc, glob))
    local, attn = trun(*args)
    ((local * torch.from_numpy(rl)).sum()
     + (attn * torch.from_numpy(ra)).sum()).backward()
    _check(jg, [t.grad for t in leaves])


def test_tiled_track_bf16_grads_match_jax_vjp():
    """#2's width: C=1024, bfloat16 activations, float32 params; the JAX
    forward runs `_fused_kernel_tiled` in interpret mode."""
    rng = np.random.default_rng(4)
    C, L = 1024, 64
    p = _track_params(rng, C)
    x = rng.standard_normal((1, L, C)).astype(np.float32)
    bc = rng.standard_normal((1, C)).astype(np.float32)

    def jf(pp, xx, bb):
        return (jfused.fused_local_track(pp, xx, bb, 1, 5, True)
                .astype(jnp.float32).sum())

    jg = jax.grad(jf, argnums=(0, 1, 2))(
        _jax(p), jnp.asarray(x, jnp.bfloat16), jnp.asarray(bc, jnp.bfloat16))
    tp, pleaves = _leaf_tensors(p)
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    tb = torch.from_numpy(bc).bfloat16().requires_grad_(True)
    out = tfused.fused_local_track(tp, tx, tb, 1, 5)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    _check(jg, [t.grad for t in pleaves] + [tx.grad, tb.grad],
           rtol=0.05, atol=0.1)


def test_tiled_segment_track_grads_match_jax_vjp():
    """#4's width: C=640, packed rows, float32. The JAX package answers
    float32 through XLA at this width and its custom VJP recomputes the
    segment reference; the port's backward recomputes #3's plain
    version, which is #4's too."""
    rng = np.random.default_rng(5)
    C, B, L, S = 640, 2, 64, 4
    p = _track_params(rng, C)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    bs = rng.standard_normal((B, S, C)).astype(np.float32)
    seg = _segments(B, L)
    r = rng.standard_normal((B, L, C)).astype(np.float32)

    def jf(pp, xx, bb):
        return (jfused.fused_local_track_segments(
            pp, xx, bb, jnp.asarray(seg), 1, 5, True) * r).sum()

    jg = jax.grad(jf, argnums=(0, 1, 2))(_jax(p), jnp.asarray(x),
                                          jnp.asarray(bs))
    (tp, tx, tb), leaves = _leaf_tensors((p, x, bs))
    (tfused.fused_local_track_segments(tp, tx, tb, torch.from_numpy(seg),
                                       1, 5) * torch.from_numpy(r)
     ).sum().backward()
    _check(jg, [t.grad for t in leaves])
