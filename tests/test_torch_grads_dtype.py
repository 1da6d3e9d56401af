"""The kernels' backward at the activation dtype: the gradients of the
port's five differentiable kernel wrappers (`fused_local_track`,
`fused_local_track_segments`, `fused_attention`, `fused_onepass`,
`fused_local_track_valid`) on the CPU against `jax.grad` of the JAX XLA
references their JAX custom VJPs differentiate, in float32 and bfloat16,
on the same numpy-seeded inputs.

The backward recomputes the port of that JAX reference
(`*_grad_reference`, `kernels/autograd.recompute_vjp`), whose convs,
products and sums run in the activation dtype with float32 LayerNorm
statistics — not the kernel-rounding plain version, which widens every
operand to float32. Tolerances:
- float32 gradients 1e-4 elementwise, as tests/test_torch_train_grads.py
  (the same gradient by another summation order);
- bfloat16 gradients 3e-2 per leaf in relative norm, ||Δ|| / ||g_jax||:
  about eight bfloat16 ulps (2^-8 = 3.9e-3). The two frameworks round the
  backward's own ops at different points (conv transposes, tanh', the
  chain rule of GELU), which the port cannot follow op by op; 1.3% was
  the largest seen;
- the backward references' bfloat16 FORWARD against the JAX references':
  mean |Δ| <= 1e-3 on unit-scale outputs (a bfloat16 ulp at 1 is 7.8e-3).
  This is what tells the activation-dtype reference from the float32
  one: the kernel-rounding plain version is 3.5e-3 away on the same
  local-track inputs.
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
from proteinbert_tpu_torch.kernels.attention import segment_one_hot
from tests.test_torch_train_grads import (
    _attn_params, _jax, _leaf_tensors, _segments, _track_params,
)

torch.set_num_threads(1)

C, B, L, S, G, H, K = 128, 2, 64, 4, 256, 4, 64
HALO = 20


def _case(name, rng):
    """(numpy args; the JAX reference on jnp args; the port's wrapper on
    torch args; the port's backward reference on torch args) — args are
    the params trees, then the activations, then inputs that take no
    gradient."""
    seg = _segments(B, L)
    real = (rng.random((B, L)) < 0.9)
    if name in ("track", "segments", "valid"):
        p = _track_params(rng, C)
        rows = L + 2 * HALO if name == "valid" else L
        x = rng.standard_normal((B, rows, C)).astype(np.float32)
        if name == "segments":
            bs = rng.standard_normal((B, S, C)).astype(np.float32)
            oh = np.asarray(segment_one_hot(torch.from_numpy(seg), S))
            return ((p, x, bs),
                    lambda pp, xx, bb: jfused.local_track_segment_oh_reference(
                        pp, xx, bb, jnp.asarray(oh, xx.dtype), 1, 5),
                    lambda pp, xx, bb: tfused.fused_local_track_segments(
                        pp, xx, bb, torch.from_numpy(seg), 1, 5),
                    lambda pp, xx, bb:
                        tfused.local_track_segment_oh_grad_reference(
                            pp, xx, bb, torch.from_numpy(oh), 1, 5))
        bc = rng.standard_normal((B, C)).astype(np.float32)
        if name == "valid":
            return ((p, x, bc),
                    lambda pp, xx, bb: jfused.local_track_valid_reference(
                        pp, xx, bb, 1, 5),
                    lambda pp, xx, bb: tfused.fused_local_track_valid(
                        pp, xx, bb, 1, 5),
                    lambda pp, xx, bb: tfused.local_track_valid_grad_reference(
                        pp, xx, bb, 1, 5))
        return ((p, x, bc),
                lambda pp, xx, bb: jfused.local_track_reference(
                    pp, xx, bb, 1, 5),
                lambda pp, xx, bb: tfused.fused_local_track(pp, xx, bb, 1, 5),
                lambda pp, xx, bb: tfused.local_track_grad_reference(
                    pp, xx, bb, 1, 5))
    ap = _attn_params(rng, C, G, H, K)
    oh = np.asarray(segment_one_hot(torch.from_numpy(seg), S)) * real[..., None]
    glob = rng.standard_normal((B, S, G)).astype(np.float32)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    if name == "attention":
        return ((ap, x, glob),
                lambda pp, xx, gg: jattn.attention_oh_reference(
                    pp, xx, gg, jnp.asarray(oh, xx.dtype), True),
                lambda pp, xx, gg: tattn.fused_attention(
                    pp, xx, gg, torch.from_numpy(oh), True),
                lambda pp, xx, gg: tattn.attention_oh_grad_reference(
                    pp, xx, gg, torch.from_numpy(oh), True))
    tp = _track_params(rng, C)
    bs = rng.standard_normal((B, S, C)).astype(np.float32)
    oh_seg = np.asarray(segment_one_hot(torch.from_numpy(seg), S))
    r = real[..., None].astype(np.float32)
    return ((tp, ap, x, bs, glob),
            lambda t, a, xx, bb, gg: jone.onepass_oh_reference(
                t, a, xx, bb, gg, jnp.asarray(oh_seg, xx.dtype),
                jnp.asarray(r), 1, 5, True, True),
            lambda t, a, xx, bb, gg: tone.fused_onepass(
                t, a, xx, bb, gg, torch.from_numpy(seg),
                torch.from_numpy(real), 1, 5, True),
            lambda t, a, xx, bb, gg: tone.onepass_oh_grad_reference(
                t, a, xx, bb, gg, torch.from_numpy(oh_seg),
                torch.from_numpy(r), 1, 5, True, True))


NAMES = ["track", "segments", "attention", "onepass", "valid"]
SEEDS = dict(zip(NAMES, range(10, 15)))


def _split_args(args):
    """params trees first, activations after."""
    n = 2 if len(args) == 5 else 1
    return args[:n], args[n:]


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_grads_match_jax_reference(name, dtype):
    rng = np.random.default_rng(SEEDS[name])
    args, jref, twrap, tref = _case(name, rng)
    params, acts = _split_args(args)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    # The cotangent, one float32 array per output.
    probe = _outputs(jref(*[_jax(p) for p in params],
                          *[jnp.asarray(a, jdt) for a in acts]))
    rs = [rng.standard_normal(o.shape).astype(np.float32) for o in probe]

    def jloss(*a):
        out = _outputs(jref(*a))
        return sum((o.astype(jnp.float32) * r).sum() for o, r in zip(out, rs))

    jg = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *[_jax(p) for p in params], *[jnp.asarray(a, jdt) for a in acts])

    def tgrads(fn):
        tparams, pleaves = _leaf_tensors(tuple(params))
        tacts = [torch.from_numpy(a).to(tdt).requires_grad_(True)
                 for a in acts]
        out = _outputs(fn(*tparams, *tacts))
        assert all(o.dtype == tdt for o in out)
        sum((o.float() * torch.from_numpy(r)).sum()
            for o, r in zip(out, rs)).backward()
        return [t.grad for t in pleaves] + [t.grad for t in tacts]

    tg = tgrads(twrap)
    # The wrapper's backward IS its backward reference's autograd.
    for a, b in zip(tg, tgrads(tref)):
        assert torch.equal(a, b)
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for j, t in zip(jl, tg):
        j, t = np.asarray(j, np.float32), t.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
        else:
            err = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
            assert err <= 3e-2, err


@pytest.mark.parametrize("name", NAMES)
def test_backward_reference_rounds_like_jax(name):
    """In bfloat16 the backward reference's forward is the JAX
    reference's, to about a tenth of an ulp on average."""
    rng = np.random.default_rng(SEEDS[name])
    args, jref, _, tref = _case(name, rng)
    params, acts = _split_args(args)
    want = _outputs(jref(*[_jax(p) for p in params],
                         *[jnp.asarray(a, jnp.bfloat16) for a in acts]))
    tparams, _ = _leaf_tensors(tuple(params))
    with torch.no_grad():
        got = _outputs(tref(*tparams, *[torch.from_numpy(a).bfloat16()
                                        for a in acts]))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        d = np.abs(g.float().numpy() - np.asarray(w, np.float32))
        assert d.mean() <= 1e-3 and d.max() <= 0.05, (d.mean(), d.max())
