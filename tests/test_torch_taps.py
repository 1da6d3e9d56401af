"""Every odd tap count and dilation in the local-track kernels and #6.

The port's plain versions of K1, #3, #2, #4, the prehaloed entries, #6
and the int8 legs against the JAX package's Pallas kernels in interpret
mode, at tap counts and dilations other than the presets' 9/9 and 5:
taps 5/5, 7/7, 11/11 and 5/9, wide dilations 1, 3, 8 and 12, and narrow
dilation 2. The inputs are made with numpy from a seed. Tolerances:
float32 1e-5 (the same arithmetic summed in another order); bf16 at the
channel-tiled widths 0.05, the JAX package's own tiled tolerance (its XLA
and kernel rounding points differ); the int8 legs in bf16 one bf16 step
of the LayerNorm-scaled output, 2^-5. A 2-block model with
narrow_kernel=7, wide_kernel=11 and wide_dilation=8, carried from JAX
through `export.flatten_params` / `weights.params_from_flat`: its forward
(JAX's one-pass kernel in interpret mode) and one float32 train step
against JAX's. Even taps: JAX's kernel raises TypeError, the port's dense
route ValueError. Also the work counts, the scratch layouts and launch
arguments at other taps (meta tensors, launches recorded), and the routes'
refusal of JAX's force-reference switch on a CUDA device. CPU only, small
shapes (L <= 128), one torch thread; the CUDA kernels are held against
these plain versions on the card by chip_smoke.py (`--phase coverage`).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.configs import get_preset as jax_preset
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.kernels import fused_block as jfused
from proteinbert_tpu.kernels import one_pass as jone
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.parallel import quant as jquant
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.kernels import attention as tattn
from proteinbert_tpu_torch.kernels import budget
from proteinbert_tpu_torch.kernels import fused_block as tfused
from proteinbert_tpu_torch.kernels import one_pass as tone
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.parallel import quant as tquant
from proteinbert_tpu_torch.train import train_state as tts
from proteinbert_tpu_torch.weights import params_from_flat, params_to_flat
from tests.test_torch_train import (
    _corrupted, _jax_value_and_grad, _jx, _tree_like, _tx,
)

torch.set_num_threads(1)

TOL = 1e-5
TILED_TOL = 0.05
BF16_TOL = 2 ** -5
C, G, H, K = 128, 256, 4, 32
TILED_C = 640
MODEL = dict(local_dim=C, global_dim=G, key_dim=K, num_heads=H,
             num_blocks=2, narrow_kernel=7, wide_kernel=11,
             wide_dilation=8, dtype="float32", use_pallas=True)


def _track(rng, c, nt, wt):
    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def vec(base=0.0):
        return (base + 0.1 * rng.standard_normal(c)).astype(np.float32)

    return {"narrow_conv": {"kernel": w((nt, c, c), nt * c), "bias": vec()},
            "wide_conv": {"kernel": w((wt, c, c), wt * c), "bias": vec()},
            "local_ln1": {"scale": vec(1.0), "bias": vec()},
            "local_dense": {"kernel": w((c, c), c), "bias": vec()},
            "local_ln2": {"scale": vec(1.0), "bias": vec()}}


def _attn(rng):
    return {"wq": (rng.standard_normal((H, G, K)) / np.sqrt(G)).astype(
                np.float32),
            "wk": (rng.standard_normal((H, C, K)) / np.sqrt(C)).astype(
                np.float32),
            "wv": (rng.standard_normal((H, C, G // H)) / np.sqrt(C)).astype(
                np.float32)}


def _jax(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _jax(v, dtype) for k, v in tree.items()}
    a = jnp.asarray(tree)
    return a if dtype is None else a.astype(dtype)


def _torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.asarray(tree))
    return t if dtype is None else t.to(dtype)


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.float().numpy(), rtol=tol, atol=tol)


def _seg(B, L):
    """Packed rows: boundaries mid-row, a pad gap, an id above S (pad by
    contract), segment 3 empty in row 1, a pad tail; S = 3."""
    seg = np.zeros((B, L), np.int32)
    seg[0, :21], seg[0, 21:45], seg[0, 48:60] = 1, 2, 3
    seg[1, :10], seg[1, 10:33], seg[1, 33:37] = 1, 2, 5
    return seg, 3


# ----------------------------------------------------------- K1, dense

@pytest.mark.parametrize("nt,wt,nd,wd", [(5, 5, 1, 1), (7, 7, 1, 3),
                                         (11, 11, 1, 8), (5, 9, 2, 12)])
def test_dense_track_matches_pallas(nt, wt, nd, wd):
    """K1's plain version (its wrapper on the CPU) against JAX's
    `_fused_kernel` in interpret mode and its XLA reference, float32,
    C=128, L=64."""
    rng = np.random.default_rng(nt * 100 + wt * 10 + wd)
    p = _track(rng, C, nt, wt)
    x = rng.standard_normal((2, 64, C)).astype(np.float32)
    bc = rng.standard_normal((2, C)).astype(np.float32)
    got = tfused.fused_local_track(_torch(p), _torch(x), _torch(bc), nd, wd)
    pallas = jfused.fused_local_track(_jax(p), _jax(x), _jax(bc), nd, wd,
                                      True)
    _close(pallas, got)
    _close(jfused.local_track_reference(_jax(p), _jax(x), _jax(bc), nd, wd),
           got)
    assert tfused.track_route(C, 64, torch.float32, nt, wt, nd,
                              wd) == ("pallas", "dense")


# ------------------------------------------------------- #3, packed rows

@pytest.mark.parametrize("nt,wt,nd,wd", [(7, 7, 1, 8), (5, 9, 2, 3)])
def test_segment_track_matches_pallas(nt, wt, nd, wd):
    """#3's plain version against JAX's `_fused_segment_kernel` in
    interpret mode (counted pallas/packed on both sides), float32."""
    rng = np.random.default_rng(nt + wd)
    p = _track(rng, C, nt, wt)
    seg, S = _seg(2, 64)
    x = rng.standard_normal((2, 64, C)).astype(np.float32)
    bs = rng.standard_normal((2, S, C)).astype(np.float32)
    before = jfused.PATH_TOTAL.get(("pallas", "packed"), 0)
    want = jfused.fused_local_track_segments(_jax(p), _jax(x), _jax(bs),
                                             jnp.asarray(seg), nd, wd, True)
    assert jfused.PATH_TOTAL[("pallas", "packed")] == before + 1
    mine = tfused.PATH_TOTAL.get(("pallas", "packed"), 0)
    got = tfused.fused_local_track_segments(_torch(p), _torch(x), _torch(bs),
                                            _torch(seg), nd, wd)
    assert tfused.PATH_TOTAL[("pallas", "packed")] == mine + 1
    _close(want, got)


# --------------------------------------------- #2 and #4, tiled widths

@pytest.mark.parametrize("packed,taps,wd", [(False, 7, 8), (True, 11, 3)])
def test_tiled_track_matches_pallas(packed, taps, wd):
    """#2 and #4 at C=640 in bfloat16 (their plain versions are K1's and
    #3's) against JAX's channel-tiled kernels in interpret mode."""
    rng = np.random.default_rng(taps)
    p = _track(rng, TILED_C, taps, taps)
    x = rng.standard_normal((2, 64, TILED_C)).astype(np.float32)
    bf = jnp.bfloat16
    if packed:
        seg, S = _seg(2, 64)
        bs = rng.standard_normal((2, S, TILED_C)).astype(np.float32)
        want = jfused.fused_local_track_segments(
            _jax(p), _jax(x, bf), _jax(bs, bf), jnp.asarray(seg), 1, wd,
            True)
        got = tfused.fused_local_track_segments(
            _torch(p), _torch(x, torch.bfloat16), _torch(bs, torch.bfloat16),
            _torch(seg), 1, wd)
    else:
        bc = rng.standard_normal((2, TILED_C)).astype(np.float32)
        want = jfused.fused_local_track(_jax(p), _jax(x, bf), _jax(bc, bf),
                                        1, wd, True)
        got = tfused.fused_local_track(_torch(p), _torch(x, torch.bfloat16),
                                       _torch(bc, torch.bfloat16), 1, wd)
    assert got.dtype == torch.bfloat16
    _close(want.astype(jnp.float32), got, TILED_TOL)


# ------------------------------------------------- the prehaloed entries

@pytest.mark.parametrize("c,taps,wd,dtype", [
    (C, 7, 8, "float32"), (TILED_C, 5, 12, "bfloat16")])
def test_prehaloed_track_matches_pallas(c, taps, wd, dtype):
    """K1's and #2's prehaloed entries on a shard whose 24 halo rows each
    side are real data, against JAX's `fused_local_track_valid` in
    interpret mode."""
    rng = np.random.default_rng(c + taps)
    p = _track(rng, c, taps, taps)
    halo = tfused.track_halo(_torch(p), 1, wd)
    assert halo == jfused.track_halo(_jax(p), 1, wd) == 24
    xh = rng.standard_normal((2, 32 + 2 * halo, c)).astype(np.float32)
    bc = rng.standard_normal((2, c)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfused.fused_local_track_valid(_jax(p), _jax(xh, jd),
                                          _jax(bc, jd), 1, wd, True)
    got = tfused.fused_local_track_valid(_torch(p), _torch(xh, td),
                                         _torch(bc, td), 1, wd)
    assert got.shape == (2, 32, c) and got.dtype == td
    _close(want.astype(jnp.float32), got,
           TOL if dtype == "float32" else TILED_TOL)


# --------------------------------------------------------------- #6

@pytest.mark.parametrize("packed", [False, True])
def test_onepass_matches_pallas(packed):
    """#6 (taps 7/11, wide dilation 12) against JAX's `_onepass_kernel`
    in interpret mode, both entries, float32 (counted pallas on both
    sides)."""
    rng = np.random.default_rng(int(packed))
    track, attn = _track(rng, C, 7, 11), _attn(rng)
    B, L = 2, 64
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    jt, ja, tt, ta = _jax(track), _jax(attn), _torch(track), _torch(attn)
    reason = "packed" if packed else "dense"
    before = jone.ONEPASS_PATH_TOTAL.get(("pallas", reason), 0)
    mine = tone.ONEPASS_PATH_TOTAL.get(("pallas", reason), 0)
    if packed:
        seg, S = _seg(B, L)
        bs = rng.standard_normal((B, S, C)).astype(np.float32)
        gs = rng.standard_normal((B, S, G)).astype(np.float32)
        real = rng.random((B, L)) < 0.9
        wl, wa = jone.fused_onepass_segments(
            jt, ja, _jax(x), _jax(bs), _jax(gs), jnp.asarray(seg),
            jnp.asarray(real), 1, 12, interpret=True)
        gl, ga = tone.fused_onepass_segments(
            tt, ta, _torch(x), _torch(bs), _torch(gs), _torch(seg),
            _torch(real), 1, 12)
    else:
        bc = rng.standard_normal((B, C)).astype(np.float32)
        g = rng.standard_normal((B, G)).astype(np.float32)
        pad = np.ones((B, L), bool)
        pad[1, 40:] = False
        wl, wa = jone.fused_onepass_dense(
            jt, ja, _jax(x), _jax(bc), _jax(g), jnp.asarray(pad), 1, 12,
            interpret=True)
        gl, ga = tone.fused_onepass_dense(
            tt, ta, _torch(x), _torch(bc), _torch(g), _torch(pad), 1, 12)
    assert jone.ONEPASS_PATH_TOTAL[("pallas", reason)] == before + 1
    assert tone.ONEPASS_PATH_TOTAL[("pallas", reason)] == mine + 1
    _close(wl, gl)
    _close(wa, ga)


# ---------------------------------------------------------- int8 legs

@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_int8_legs_match_pallas(dtype, tol):
    """#3's and #6's int8 legs (each package's own `quantize_params`, one
    7/11-tap track for both) at narrow dilation 2, wide dilation 8 (#3) and
    1, 12 (#6), against JAX's int8 legs in interpret mode."""
    rng = np.random.default_rng(17)
    B, L = 2, 64
    seg, S = _seg(B, L)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    bs = rng.standard_normal((B, S, C)).astype(np.float32)
    gs = rng.standard_normal((B, S, G)).astype(np.float32)
    real = rng.random((B, L)) < 0.9
    track, attn = _track(rng, C, 7, 11), _attn(rng)
    jtrack, ttrack = (jquant.quantize_params(_jax(track)),
                      tquant.quantize_params(_torch(track)))
    want = jfused.fused_local_track_segments(
        jtrack, _jax(x, jd), _jax(bs, jd), jnp.asarray(seg), 2, 8, True)
    got = tfused.fused_local_track_segments(
        ttrack, _torch(x, td), _torch(bs, td), _torch(seg), 2, 8)
    _close(want.astype(jnp.float32), got, tol)
    wl, wa = jone.fused_onepass_segments(
        jtrack, jquant.quantize_params(_jax(attn)), _jax(x, jd),
        _jax(bs, jd), _jax(gs, jd), jnp.asarray(seg), jnp.asarray(real), 1,
        12, interpret=True)
    gl, ga = tone.fused_onepass_segments(
        ttrack, tquant.quantize_params(_torch(attn)), _torch(x, td),
        _torch(bs, td), _torch(gs, td), _torch(seg), _torch(real), 1, 12)
    _close(wl.astype(jnp.float32), gl, tol)
    _close(wa.astype(jnp.float32), ga, tol)


# ------------------------------------- the 7 / 11 / d=8 model, 2 blocks

@pytest.fixture(scope="module")
def model_pair():
    jcfg, tcfg = jax_preset("tiny"), get_preset("tiny")
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **MODEL))
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **MODEL))
    jparams = jmodel.init(jax.random.PRNGKey(26), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_model_forward_matches_jax(model_pair):
    """The 2-block model's forward, float32: JAX runs its one-pass kernel
    in interpret mode, the port #6's plain version; logits within 1e-4
    (test_torch_coverage's `tiny` bound), one pallas/dense decision a
    forward in the port's one-pass counter."""
    jcfg, tcfg, jparams, tparams = model_pair
    rng = np.random.default_rng(26)
    tokens = rng.integers(4, 26, (2, 64)).astype(np.int32)
    tokens[:, 0], tokens[1, 40], tokens[1, 41:] = 1, 2, 0
    ann = (rng.random((2, jcfg.model.num_annotations)) < 0.05).astype(
        np.float32)
    jl, jg = jmodel.apply(jparams, jnp.asarray(tokens), jnp.asarray(ann),
                          jcfg.model)
    before = tone.ONEPASS_PATH_TOTAL.get(("pallas", "dense"), 0)
    with torch.inference_mode():
        tl, tg = tmodel.apply(tparams, torch.from_numpy(tokens),
                              torch.from_numpy(ann), tcfg.model)
    assert tone.ONEPASS_PATH_TOTAL[("pallas", "dense")] == before + 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)


def test_model_train_step_matches_jax(model_pair):
    """One float32 train step of the 2-block model: the loss and every
    gradient against JAX's, with test_torch_train's tolerance (loss 1e-5,
    grads 1e-4)."""
    jcfg, tcfg, jparams, tparams = model_pair
    X, Y, W = _corrupted(np.random.default_rng(27), 2, 64,
                         jcfg.model.num_annotations)
    (jl, _), jg = _jax_value_and_grad(jparams, _jx(X), _jx(Y), _jx(W), jcfg)
    tg, tm = tts.loss_and_grads(tparams, _tx(X), _tx(Y), _tx(W), tcfg)
    assert abs(float(jl) - float(tm["loss"])) <= 1e-5
    want = flatten_params(jg)
    got = params_to_flat(_tree_like(tparams, tg))
    assert set(want) == set(got)
    assert want["blocks/1/narrow_conv/kernel"].shape[0] == 7
    assert want["blocks/1/wide_conv/kernel"].shape[0] == 11
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ------------------------------------------------------------ even taps

def test_even_taps_fail_in_jax_and_raise_on_the_dense_route():
    """At taps 8/8 JAX's dense gate admits the shape and its kernel fails
    (TypeError: the tap offsets run past the 2·halo window); the port's
    dense route raises ValueError saying so, before any kernel. The
    segment and one-pass gates refuse even taps: the reference route."""
    rng = np.random.default_rng(8)
    p = _track(rng, C, 8, 8)
    x = rng.standard_normal((2, 64, C)).astype(np.float32)
    bc = rng.standard_normal((2, C)).astype(np.float32)
    assert jfused.pallas_supported(C, 64, "float32", 8, 8, 5)
    with pytest.raises(TypeError):
        jfused.fused_local_track(_jax(p), _jax(x), _jax(bc), 1, 5, True)
    with pytest.raises(ValueError, match="JAX's Pallas kernel fails at "
                                         "even taps too"):
        tfused.track_route(C, 64, torch.float32, 8, 8, 1, 5)
    g = rng.standard_normal((2, G)).astype(np.float32)
    with pytest.raises(ValueError, match="even taps"):
        tone.fused_onepass_dense(_torch(p), _torch(_attn(rng)), _torch(x),
                                 _torch(bc), _torch(g))
    assert tfused.track_route(C, 64, torch.float32, 8, 8, 1, 5,
                              max_segments=3) == ("reference", "segments")
    assert tone.onepass_route(C, G, 64, 1, K, H, G // H, torch.float32, 8,
                              8, 1, 5, False) == ("reference",
                                                  "unsupported_shape")


# ------------------------------------- work counts, scratches, launches

def test_work_counts_take_each_convs_taps():
    """`local_track_flops` and `onepass_flops` count 2·B·L·C²·(nt + wt +
    1) for the track, as JAX's cost estimates do (fused_block.py:779,
    one_pass.py:362); the presets' 9/9 count is unchanged."""
    assert tfused.local_track_flops(8, 512, 512, 7, 11) == \
        2 * 8 * 512 * 512 ** 2 * 19
    assert tfused.local_track_flops(2, 64, 128, 5, 9) == \
        2 * 2 * 64 * 128 ** 2 * 15
    assert tfused.local_track_flops(8, 512, 512) == \
        2 * 8 * 512 * 512 ** 2 * 19
    assert (tone.onepass_flops(8, 512, 128, 512, 8, 4, 64, 7, 11)
            - tone.onepass_flops(8, 512, 128, 512, 8, 4, 64, 5, 5)) == \
        2 * 8 * 512 * 128 ** 2 * 8


@pytest.fixture
def launches(monkeypatch):
    """The local-track kernels' launches recorded (name, arguments)."""
    calls = []
    for k in (tfused.LOCAL_TRACK, tfused.LOCAL_TRACK_SEGMENTS_Q8,
              tfused.LOCAL_TRACK_TILED_VALID, tone.ONEPASS_Q8):
        monkeypatch.setattr(k, "launch", lambda *a, k=k: calls.append(
            (k.name, a)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for mod in (tfused, tone):
        monkeypatch.setattr(mod, "stream_ptr", lambda d: 0)
    return calls


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def _meta_track(c, nt, wt, quant=False):
    """Meta-tensor track weights (bf16, or int8 quant leaves with their
    float32 scales)."""
    def w(*shape):
        if not quant:
            return _meta(*shape, dtype=torch.bfloat16)
        return {"q": _meta(*shape, dtype=torch.int8),
                "scale": _meta(*(shape[:-2] + shape[-1:]))}

    p = {name: {k: _meta(c) for k in ("bias", "scale")}
         for name in tfused.TRACK_PARAMS}
    p["narrow_conv"]["kernel"] = w(nt, c, c)
    p["wide_conv"]["kernel"] = w(wt, c, c)
    p["local_dense"]["kernel"] = w(c, c)
    return p


def test_launches_pass_each_convs_taps_and_dilations(launches):
    """K1 and #2's prehaloed entry pass (narrow taps, wide taps, narrow
    dilation, wide dilation) just before the stream, with the arguments
    their C signatures declare; the prehaloed shard's halo is the convs'
    reach, (7 - 1) / 2 · 8 = 24 rows."""
    B, L = 2, 40
    out = tfused._local_track_kernel(_meta_track(512, 5, 9),
                                     _meta(B, L, 512, dtype=torch.bfloat16),
                                     _meta(B, 512), 2, 12)
    assert out.shape == (B, L, 512)
    p = _meta_track(1024, 7, 7)
    halo = tfused.track_halo(p, 1, 8)
    assert halo == 24
    tfused._local_track_valid_kernel(
        p, _meta(B, L + 2 * halo, 1024, dtype=torch.bfloat16),
        _meta(B, 1024), 1, 8)
    (k1, a), (k2, b) = launches
    assert (k1, len(a)) == ("local_track", len(tfused.LOCAL_TRACK.argtypes))
    assert a[-5:-1] == (5, 9, 2, 12) and a[-8:-5] == (B, L, 512)
    assert (k2, len(b)) == ("local_track_tiled_valid",
                            len(tfused.LOCAL_TRACK_TILED_VALID.argtypes))
    assert b[-5:-1] == (7, 7, 1, 8) and b[-8:-5] == (B, L, 1024)


@pytest.mark.parametrize("nt,wt", [(5, 9), (13, 13)])
def test_int8_scratches_take_each_convs_taps(nt, wt, launches):
    """#3's and #6's int8 legs in bf16 carve their dequantized conv
    weights as (nt, C, C) and (wt, C, C) scratches (the C entries'
    `dequant_track_block` and `onepass_scratch` carve the same), and pass
    the taps."""
    c, B, L, S = 256, 2, 40, 3
    layout, _ = tfused.track_scratch_layout(B, L, c, True, nt, wt)
    assert [s for s, _, _ in layout] == [(nt, c, c), (wt, c, c), (c, c),
                                         (B, L, c)]
    tfused._segments_kernel(_meta_track(c, nt, wt, quant=True),
                            _meta(B, L, c, dtype=torch.bfloat16),
                            _meta(B, S, c, dtype=torch.bfloat16),
                            _meta(B, L, dtype=torch.int32), 1, 3)
    (name, a), = launches
    assert name == "local_track_segments_q8"
    assert len(a) == len(tfused.LOCAL_TRACK_SEGMENTS_Q8.argtypes)
    assert a[-5:-1] == (nt, wt, 1, 3)
    layout, _ = tone.onepass_scratch_layout(B, L, c, S, 4, 64, True,
                                            torch.bfloat16, 32, nt, wt)
    assert [s for s, _, _ in layout][:3] == [(nt, c, c), (wt, c, c), (c, c)]


@pytest.mark.parametrize("preset", [True, False])
def test_float32_onepass_shared_memory_follows_the_instantiation(preset):
    """#6's float32 cluster plan has one track tile for every geometry:
    its own TL rows, h, the weight tiles and a double-buffered A tile, no
    halo rows. So at the presets' 9/9 taps, d=5, and at 13/13 taps, d=40,
    the coverage admits the same lengths: the attention's (L,) scores
    bound it, never the taps."""
    a128 = lambda n: -(-n // 128) * 128  # noqa: E731
    for c in (128, 256, 384):
        for seg in (False, True):
            want = (a128(16 * c * 4) + a128(16 * c * 4)
                    + a128(2 * 16 * c * 4) + a128(2 * 16 * 16 * 4)
                    + (a128(16 * 4) if seg else 0))
            assert tone.track_f32_smem(c, seg) == want
    nt, wd = (9, 5) if preset else (13, 40)
    longest = (232448 - 49152 - 8192) // 4
    for L, want in ((longest, None), (longest + 1, "L=")):
        for seg in (False, True):
            why = tone.onepass_coverage(384, 512, L, 8 if seg else 1, 64, 4,
                                        128, torch.float32, nt, nt, 1, wd,
                                        seg)
            assert why is None if want is None else why.startswith(want)


# ------------------------------------------------- force-reference switch

ROUTES = {
    "track": lambda dev: tfused.track_route(
        C, 64, torch.float32, 9, 9, 1, 5, device=dev),
    "attention": lambda dev: tattn.attention_route(
        C, G, 64, 1, K, H, G // H, torch.float32, False, device=dev),
    "onepass": lambda dev: tone.onepass_route(
        C, G, 64, 1, K, H, G // H, torch.float32, 9, 9, 1, 5, False,
        device=dev),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_refuse_force_reference_on_cuda(route, monkeypatch):
    """JAX's PBT_FORCE_REFERENCE_KERNEL is not ported (`kernels.
    NOT_PORTED`): with it set, a route on a CUDA device raises
    RuntimeError instead of pretending to force the reference; on the
    CPU, unset, or set to "0" / "false", the route is the usual one."""
    fn = ROUTES[route]
    want = fn(torch.device("cuda"))
    monkeypatch.setenv("PBT_FORCE_REFERENCE_KERNEL", "1")
    with pytest.raises(RuntimeError, match="PBT_FORCE_REFERENCE_KERNEL"):
        fn(torch.device("cuda"))
    assert fn(torch.device("cpu")) == fn(None) == want
    for off in ("0", "false", " "):
        monkeypatch.setenv("PBT_FORCE_REFERENCE_KERNEL", off)
        assert fn(torch.device("cuda")) == want
    monkeypatch.setenv("PBT_FORCE_REFERENCE_KERNEL", "true")
    with pytest.raises(RuntimeError):
        budget.refuse_forced_reference(route, "cuda:0")


# ------------------------- shapes JAX's gates refuse on the VMEM budget

def test_port_kernels_cover_shapes_jax_refuses_on_vmem():
    """Taps 13/13 at C=512 in bf16: 27·C² bf16 weights (14.2 MB) exceed
    JAX's 13 MiB VMEM budget, so its gates send the dense and packed
    tracks to XLA; K1 and #3 cover the shape, so the port runs them and
    counts pallas (as K2 covers `tiny`'s attention, which JAX's gate
    sends to XLA).
    In one forward of a 1-block bf16 model the port's local-track counter
    reads pallas/dense where JAX's reads reference/unsupported_shape, and
    the one-pass and attention counters agree."""
    bf = torch.bfloat16
    assert not jfused.pallas_supported(512, 512, "bfloat16", 13, 13, 5)
    assert not jfused.pallas_segments_supported(512, 512, 8, "bfloat16",
                                                13, 13, 5, 1)
    assert tfused.track_route(512, 512, bf, 13, 13, 1, 5) == (
        "pallas", "dense")
    assert tfused.track_route(512, 512, bf, 13, 13, 1, 5,
                              max_segments=8) == ("pallas", "packed")
    model = dict(MODEL, local_dim=512, global_dim=512, key_dim=64,
                 num_heads=8, num_blocks=1, narrow_kernel=13,
                 wide_kernel=13, wide_dilation=5, dtype="bfloat16")
    jm = dataclasses.replace(jax_preset("tiny").model, **model)
    tm = dataclasses.replace(get_preset("tiny").model, **model)
    tokens = np.full((1, 16), 5, np.int32)
    tokens[0, 0] = 1
    ann = np.zeros((1, jm.num_annotations), np.float32)
    jcounters = (jfused.PATH_TOTAL, jone.ONEPASS_PATH_TOTAL)
    tcounters = (tfused.PATH_TOTAL, tone.ONEPASS_PATH_TOTAL)
    before = [dict(c) for c in jcounters]
    jparams = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jm))
    jax.eval_shape(lambda p: jmodel.apply(p, jnp.asarray(tokens),
                                          jnp.asarray(ann), jm), jparams)
    want = [{k: n - b.get(k, 0) for k, n in c.items() if n != b.get(k, 0)}
            for b, c in zip(before, jcounters)]
    params = tmodel.init(tm, torch.Generator().manual_seed(0), device="cpu")
    before = [dict(c) for c in tcounters]
    with torch.inference_mode():
        tmodel.apply(params, torch.from_numpy(tokens),
                     torch.from_numpy(ann), tm)
    got = [{k: n - b.get(k, 0) for k, n in c.items() if n != b.get(k, 0)}
           for b, c in zip(before, tcounters)]
    assert want == [{("reference", "unsupported_shape"): 1},
                    {("reference", "unsupported_shape"): 1}]
    assert got == [{("pallas", "dense"): 1},
                   {("reference", "unsupported_shape"): 1}]

