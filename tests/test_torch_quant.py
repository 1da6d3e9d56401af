"""The port's int8 serving arm on the CPU against the JAX package, on the
same numpy-seeded weights: `quantize_params` / `dequantize_params` /
`partial_dequantize_params` / `param_bytes` (bit for bit), the int8 legs
of #3, K2 (dense and packed) and #6 (dense and packed) — whose plain
version is the floating-point leg's on the dequantized weights — against
the JAX Pallas int8 legs in interpret mode at C=128 (G=512, H=4, k=64,
v=128), the dequantize-first routes (K1; #4 at a tiled width) against the
JAX dispatch, and the int8 `Server` / dispatchers against the JAX
quantized entries — on `tiny`, at C=128 and at the channel-tiled C=640
(one block), where both packages dequantize the track weights before the
tiled local track and keep the attention's int8.

Tolerances: float32 1e-5 (same arithmetic, another summation order; the
quantized weights themselves are bit-identical); bfloat16 2^-5 (one bf16
step of the LayerNorm-scaled or attention output, as the fp legs' bf16
tests in tests/test_torch_kernels.py). The `int8_act` arm's fake-quant
rounds the trunk outputs to a grid of amax/127, so its comparison allows
one grid step where a float32 difference of 1e-6 lands an element on the
other side of a rounding boundary. On the card chip_smoke.py holds each
CUDA int8 leg to the fp leg on the dequantized weights, bit for bit.
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
from proteinbert_tpu.kernels import attention as jattn
from proteinbert_tpu.kernels import fused_block as jfused
from proteinbert_tpu.kernels import one_pass as jone
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.parallel import quant as jquant
from proteinbert_tpu_torch import inference as tinf
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.kernels import attention as tattn
from proteinbert_tpu_torch.kernels import fused_block as tfused
from proteinbert_tpu_torch.kernels import one_pass as tone
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.parallel import quant as tquant
from proteinbert_tpu_torch.serve.dispatch import (
    BucketDispatcher, RaggedDispatcher, parity_max,
)
from proteinbert_tpu_torch.serve.server import Server
from proteinbert_tpu_torch.weights import params_from_flat

TOL = 1e-5
BF16_TOL = 2 ** -5
C, G, H, K = 128, 512, 4, 64
B, L, S = 2, 64, 4
BUCKETS = (32, 64, 128)
SEQS = ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWY", "GG",
        "ACDEFGHIKLMNPQRSTVWY" * 3, "WWW" * 30]
WIDE = dict(local_dim=128, global_dim=128, key_dim=32, num_heads=4,
            num_blocks=2, num_annotations=64, dtype="float32",
            use_pallas=True)
# A channel-tiled width (512 < C): both packages dequantize the track
# weights before the tiled local track (JAX: its Pallas dispatch at C=640,
# interpret mode; the port: #2 / #4, their plain versions here) and keep
# the attention weights int8 for K2's int8 leg.
TILED = dict(WIDE, local_dim=640, num_blocks=1)


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _close(want, got, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(want, np.float32), got, rtol=tol,
                               atol=tol)


# ------------------------------------------------------- trunk weights

@pytest.fixture(scope="module", params=["tiny", "c128_pallas",
                                        "c640_pallas"])
def pair(request):
    jcfg, tcfg = jax_preset("tiny"), get_preset("tiny")
    width = {"c128_pallas": WIDE, "c640_pallas": TILED}.get(request.param)
    if width is not None:
        jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **width))
        tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **width))
    jparams = jmodel.init(jax.random.PRNGKey(7), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


def _flat(tree, stacked: bool):
    """{path: leaf} of a params tree, blocks unstacked: a JAX tree's
    stacked block leaves are split along their first axis (a quant leaf's
    scale too, unless it is the shared per-channel scale of a stacked
    vector), a port tree's block list is walked."""
    out = {}

    def walk(node, path, block=None):
        if tquant.is_quant_leaf(node) or jquant._is_quant_leaf(node):
            q, scale = np.asarray(node["q"]), np.asarray(node["scale"])
            if block is not None and stacked:
                # A stacked vector (blocks, C) has one (C,) scale.
                scale = scale[block] if q.ndim >= 3 else scale
                q = q[block]
            out[path] = {"q": q, "scale": scale}
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}", block)
        else:
            a = np.asarray(node)
            out[path] = a[block] if (block is not None and stacked) else a

    for k, v in tree.items():
        if k != "blocks":
            walk(v, k)
        elif stacked:
            n = jax.tree.leaves(v)[0].shape[0]
            for i in range(n):
                walk(v, f"blocks/{i}", i)
        else:
            for i, blk in enumerate(v):
                walk(blk, f"blocks/{i}")
    return out


def _assert_same_tree(jtree, ttree):
    want, got = _flat(jtree, stacked=True), _flat(ttree, stacked=False)
    assert set(want) == set(got)
    for path, w in want.items():
        g = got[path]
        assert isinstance(w, dict) == isinstance(g, dict), path
        pairs = ([(w["q"], g["q"]), (w["scale"], g["scale"])]
                 if isinstance(w, dict) else [(w, g)])
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=path)


def test_quantize_params_is_bit_identical_to_jax(pair):
    """The same weights quantize to the same int8 values and float32
    scales, leaf for leaf, and dequantize to the same float32 values."""
    _, _, jparams, tparams = pair
    tq = tquant.quantize_params(tparams)
    jq = jquant.quantize_params(jparams)
    _assert_same_tree(jq, tq)
    assert tq["blocks"][0]["narrow_conv"]["kernel"]["q"].dtype == torch.int8
    _assert_same_tree(jquant.dequantize_params(jq),
                      tquant.dequantize_params(tq))


def test_partial_dequantize_leaves_the_same_leaves_int8(pair):
    _, _, jparams, tparams = pair
    jp = jquant.partial_dequantize_params(jquant.quantize_params(jparams))
    tp = tquant.partial_dequantize_params(tquant.quantize_params(tparams))
    _assert_same_tree(jp, tp)
    int8 = {p for p, v in _flat(tp, stacked=False).items()
            if isinstance(v, dict)}
    n = len(tparams["blocks"])
    assert int8 == {f"blocks/{i}/{a}/{b}" for i in range(n)
                    for a, b in tquant._INKERNEL_QUANT_KEYS}


def test_param_bytes_match_jax(pair):
    """Resident bytes of the fp32 and the int8 trees equal the JAX
    package's count, and the int8 tree holds about a quarter."""
    _, _, jparams, tparams = pair
    jq, tq = jquant.quantize_params(jparams), tquant.quantize_params(tparams)
    assert tquant.param_bytes(tparams) == jquant.param_bytes(jparams)
    assert tquant.param_bytes(tq) == jquant.param_bytes(jq)
    ratio = tquant.param_bytes(tq) / tquant.param_bytes(tparams)
    assert 0.25 < ratio <= 0.30


def test_cast_block_keeps_quant_leaves(pair):
    _, _, _, tparams = pair
    blk = tquant.partial_dequantize_params(
        tquant.quantize_params(tparams))["blocks"][0]
    cast = tmodel.cast_block(blk, torch.bfloat16)
    for name, key in tquant._INKERNEL_QUANT_KEYS:
        assert cast[name][key] is blk[name][key]
        assert cast[name][key]["q"].dtype == torch.int8
    assert cast["global_dense1"]["kernel"].dtype == torch.bfloat16
    assert cast["local_ln1"]["scale"].dtype == torch.float32


# ------------------------------------------------- kernel int8 legs

def _track_params(rng, c=C):
    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def vec(base=0.0):
        return (base + 0.1 * rng.standard_normal(c)).astype(np.float32)

    return {"narrow_conv": {"kernel": w((9, c, c), 9 * c), "bias": vec()},
            "wide_conv": {"kernel": w((9, c, c), 9 * c), "bias": vec()},
            "local_ln1": {"scale": vec(1.0), "bias": vec()},
            "local_dense": {"kernel": w((c, c), c), "bias": vec()},
            "local_ln2": {"scale": vec(1.0), "bias": vec()}}


def _attn_params(rng):
    return {"wq": (rng.standard_normal((H, G, K)) / np.sqrt(G)).astype(
                np.float32),
            "wk": (rng.standard_normal((H, C, K)) / np.sqrt(C)).astype(
                np.float32),
            "wv": (rng.standard_normal((H, C, G // H)) / np.sqrt(C)).astype(
                np.float32)}


def _seg():
    """Packed rows: boundaries mid-row, a pad gap, an id above S (pad by
    contract), segment 4 empty in row 0, a pad tail."""
    seg = np.zeros((B, L), np.int32)
    seg[0, :20], seg[0, 20:45], seg[0, 48:60] = 1, 2, 3
    seg[1, :10], seg[1, 10:30], seg[1, 30:36], seg[1, 36:64] = 1, 2, 6, 4
    return seg


@pytest.fixture(scope="module")
def qinputs():
    """Quantized weights on both sides (each package's own
    `quantize_params`) and activations."""
    rng = np.random.default_rng(5)
    track, attn = _track_params(rng), _attn_params(rng)
    return {"jtrack": jquant.quantize_params(_jax(track)),
            "ttrack": tquant.quantize_params(_torch(track)),
            "jattn": jquant.quantize_params(_jax(attn)),
            "tattn": tquant.quantize_params(_torch(attn)),
            "x": rng.standard_normal((B, L, C)).astype(np.float32),
            "bseg": rng.standard_normal((B, S, C)).astype(np.float32),
            "gseg": rng.standard_normal((B, S, G)).astype(np.float32),
            "seg": _seg(),
            "real": rng.random((B, L)) < 0.9}


DTYPES = [("float32", TOL), ("bfloat16", BF16_TOL)]


def _acts(qinputs, dtype, *names):
    """Activations in `dtype` on both sides."""
    return ([_jax(qinputs[n]).astype(getattr(jnp, dtype)) for n in names],
            [_torch(qinputs[n]).to(getattr(torch, dtype)) for n in names])


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["float32", "bfloat16"])
def test_segment_track_int8_leg_matches_pallas(qinputs, dtype, tol):
    """#3's int8 leg (fused_block.py:983-998) in interpret mode."""
    (jx, jb), (tx, tb) = _acts(qinputs, dtype, "x", "bseg")
    seg = qinputs["seg"]
    before = jfused.PATH_TOTAL.get(("pallas", "packed"), 0)
    want = jfused.fused_local_track_segments(
        qinputs["jtrack"], jx, jb, jnp.asarray(seg), 1, 5, True)
    assert jfused.PATH_TOTAL[("pallas", "packed")] == before + 1
    got = tfused.fused_local_track_segments(qinputs["ttrack"], tx, tb,
                                            torch.from_numpy(seg), 1, 5)
    assert got.dtype == getattr(torch, dtype)
    _close(want, got, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["float32", "bfloat16"])
def test_dense_attention_int8_leg_matches_pallas(qinputs, dtype, tol):
    """K2's int8 leg (attention.py:262-272) through the dense entry, with a
    half-padded and an all-pad row."""
    (jx, jg), (tx, tg) = _acts(qinputs, dtype, "x", "gseg")
    mask = np.ones((B, L), bool)
    mask[0, L // 2:] = False
    mask[1] = False
    want = jattn.fused_global_attention(qinputs["jattn"], jx, jg[:, 0],
                                        jnp.asarray(mask), interpret=True)
    got = tattn.fused_global_attention(qinputs["tattn"], tx, tg[:, 0],
                                       torch.from_numpy(mask))
    assert torch.isfinite(got.float()).all()
    _close(want, got, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["float32", "bfloat16"])
def test_packed_attention_int8_leg_matches_pallas(qinputs, dtype, tol):
    (jx, jg), (tx, tg) = _acts(qinputs, dtype, "x", "gseg")
    seg, real = qinputs["seg"], qinputs["real"]
    want = jattn.fused_packed_attention(
        qinputs["jattn"], jx, jg, jnp.asarray(seg), jnp.asarray(real),
        interpret=True)
    got = tattn.fused_packed_attention(qinputs["tattn"], tx, tg,
                                       torch.from_numpy(seg),
                                       torch.from_numpy(real))
    _close(want, got, tol)
    # Segment 4 is empty in row 0: exactly +0.0.
    assert (got[0, 3] == 0).all() and not torch.signbit(got[0, 3]).any()


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["float32", "bfloat16"])
def test_onepass_segments_int8_leg_matches_pallas(qinputs, dtype, tol):
    """#6's int8 leg (one_pass.py:236-241) through the packed entry."""
    (jx, jb, jg), (tx, tb, tg) = _acts(qinputs, dtype, "x", "bseg", "gseg")
    seg, real = qinputs["seg"], qinputs["real"]
    before = jone.ONEPASS_PATH_TOTAL.get(("pallas", "packed"), 0)
    wl, wa = jone.fused_onepass_segments(
        qinputs["jtrack"], qinputs["jattn"], jx, jb, jg, jnp.asarray(seg),
        jnp.asarray(real), interpret=True)
    assert jone.ONEPASS_PATH_TOTAL[("pallas", "packed")] == before + 1
    gl, ga = tone.fused_onepass_segments(
        qinputs["ttrack"], qinputs["tattn"], tx, tb, tg,
        torch.from_numpy(seg), torch.from_numpy(real))
    _close(wl, gl, tol)
    _close(wa, ga, tol)
    assert (ga[0, 3] == 0).all() and not torch.signbit(ga[0, 3]).any()


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["float32", "bfloat16"])
def test_onepass_dense_int8_leg_matches_pallas(qinputs, dtype, tol):
    (jx, jb, jg), (tx, tb, tg) = _acts(qinputs, dtype, "x", "bseg", "gseg")
    pad = np.ones((B, L), bool)
    pad[0, L // 3:] = False
    pad[1] = False  # all-pad row: uniform softmax, not NaN
    before = jone.ONEPASS_PATH_TOTAL.get(("pallas", "dense"), 0)
    wl, wa = jone.fused_onepass_dense(
        qinputs["jtrack"], qinputs["jattn"], jx, jb[:, 0], jg[:, 0],
        jnp.asarray(pad), interpret=True)
    assert jone.ONEPASS_PATH_TOTAL[("pallas", "dense")] == before + 1
    gl, ga = tone.fused_onepass_dense(
        qinputs["ttrack"], qinputs["tattn"], tx, tb[:, 0], tg[:, 0],
        torch.from_numpy(pad))
    assert ga.shape == (B, G) and torch.isfinite(ga.float()).all()
    _close(wl, gl, tol)
    _close(wa, ga, tol)


# --------------------------------------------- dequantize-first routes

def test_local_track_dequantizes_first_as_the_jax_composition(qinputs):
    """K1 has no int8 leg: the dense composition dequantizes the track
    weights and runs K1 (JAX one_pass.py:580)."""
    jtp = jfused.dequant_params(qinputs["jtrack"])
    want = jfused.fused_local_track(jtp, _jax(qinputs["x"]),
                                    _jax(qinputs["bseg"])[:, 0], 1, 5, True)
    got = tfused.fused_local_track(qinputs["ttrack"],
                                   _torch(qinputs["x"]),
                                   _torch(qinputs["bseg"])[:, 0], 1, 5)
    _close(want, got)


def test_tiled_width_segments_dequantize_first():
    """#4 has no int8 leg: at C=640 the JAX dispatch dequantizes before
    the channel-tiled path (fused_block.py:421-423); float32, whose answer
    the JAX package gives through XLA at this width."""
    rng = np.random.default_rng(8)
    c = 640
    p = _track_params(rng, c)
    x = rng.standard_normal((1, 32, c)).astype(np.float32)
    bs = rng.standard_normal((1, 2, c)).astype(np.float32)
    seg = np.zeros((1, 32), np.int32)
    seg[0, :12], seg[0, 12:28] = 1, 2
    want = jfused.fused_local_track_segments(
        jquant.quantize_params(_jax(p)), _jax(x), _jax(bs), jnp.asarray(seg),
        1, 5, True)
    got = tfused.fused_local_track_segments(
        tquant.quantize_params(_torch(p)), _torch(x), _torch(bs),
        torch.from_numpy(seg), 1, 5)
    _close(want, got)


# ------------------------------------------------ inference-only legs

def test_int8_legs_refuse_inputs_that_require_grad(qinputs):
    x = _torch(qinputs["x"]).requires_grad_()
    bs, gs = _torch(qinputs["bseg"]), _torch(qinputs["gseg"])
    seg = torch.from_numpy(qinputs["seg"])
    tt, ta = qinputs["ttrack"], qinputs["tattn"]
    calls = [
        lambda: tfused.fused_local_track_segments(tt, x, bs, seg),
        lambda: tattn.fused_packed_attention(ta, x, gs, seg),
        lambda: tattn.fused_global_attention(ta, x, gs[:, 0]),
        lambda: tone.fused_onepass_segments(tt, ta, x, bs, gs, seg),
        lambda: tone.fused_onepass_dense(tt, ta, x, bs[:, 0], gs[:, 0]),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="inference-only"):
            call()
    with torch.no_grad():
        assert calls[0]().shape == (B, L, C)


# --------------------------------- CUDA routing with recorded launches

@pytest.fixture
def recorded(monkeypatch):
    """Launches of every kernel recorded, not run; meta tensors stand in
    for the card's."""
    calls = []
    from proteinbert_tpu_torch.kernels import KERNELS

    for k in KERNELS:
        monkeypatch.setattr(k, "launch", lambda *a, k=k: calls.append(
            (k.name, len(a))))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for mod in (tfused, tattn, tone):
        monkeypatch.setattr(mod, "stream_ptr", lambda d: 0)
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


def _meta_q(*shape):
    return {"q": _meta(*shape, dtype=torch.int8),
            "scale": _meta(*(shape[:-2] + shape[-1:]), dtype=torch.float32)}


def _meta_track(c, quant=True):
    p = {name: {k: _meta(c, dtype=torch.float32) for k in ("bias", "scale")}
         for name in tfused.TRACK_PARAMS}
    w = _meta_q if quant else (lambda *s: _meta(*s, dtype=torch.float32))
    for name in ("narrow_conv", "wide_conv"):
        p[name]["kernel"] = w(9, c, c)
    p["local_dense"]["kernel"] = w(c, c)
    return p


def _meta_attn(c, g, h, v, quant=True):
    w = _meta_q if quant else (lambda *s: _meta(*s, dtype=torch.float32))
    return {"wq": w(h, g, 64), "wk": w(h, c, 64), "wv": w(h, c, v)}


@pytest.mark.parametrize("C,ok", [(512, True), (128, True), (640, False),
                                  (96, False)])
def test_segment_track_int8_kernel_widths(C, ok, recorded):
    """#3's int8 leg covers C in {128, 256, 512}; a tiled width never
    reaches it (the wrapper dequantizes there first), and `_segments_kernel`
    refuses one before any launch."""
    args = (_meta_track(C), _meta(2, 8, C), _meta(2, 3, C),
            _meta(2, 8, dtype=torch.int32), 1, 5)
    if not ok:
        with pytest.raises(ValueError, match=f"C={C}"):
            tfused._segments_kernel(*args)
        assert recorded == []
        return
    out = tfused._segments_kernel(*args)
    assert out.shape == (2, 8, C)
    assert recorded == [("local_track_segments_q8", len(
        tfused.LOCAL_TRACK_SEGMENTS_Q8.argtypes))]


@pytest.mark.parametrize("operand", ["x", "narrow_conv", "wide_conv",
                                     "local_dense"])
def test_segment_track_int8_refuses_what_it_cannot_read(operand, recorded):
    """#3's int8 leg in bf16 at C=512 raises ValueError, before any launch,
    for an x whose base is not 16-byte aligned (its conv pass reads x by
    TMA) or an int8 conv or dense kernel its dequantize pass cannot read in
    16-byte loads; aligned operands launch once."""
    C, B, L = 512, 2, 24
    p = _meta_track(C)
    x = _meta(B, L, C)
    target = x if operand == "x" else p[operand]["kernel"]["q"]
    n = target.numel()
    flat = _meta(n + 16, dtype=target.dtype)

    def call(t):
        q = p if operand == "x" else {
            **p, operand: {**p[operand],
                           "kernel": {**p[operand]["kernel"], "q": t}}}
        return tfused._segments_kernel(
            q, t if operand == "x" else x, _meta(B, 3, C),
            _meta(B, L, dtype=torch.int32), 1, 5)

    with pytest.raises(ValueError, match="16-byte aligned"):
        call(flat[1:n + 1].view(target.shape))
    assert recorded == []
    assert call(flat[16:n + 16].view(target.shape)).shape == (B, L, C)
    assert recorded == [("local_track_segments_q8", len(
        tfused.LOCAL_TRACK_SEGMENTS_Q8.argtypes))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_segment_track_int8_scratches_have_the_c_entry_shapes(
        dtype, monkeypatch, recorded):
    """#3's int8 leg in bf16 carves the dequantized nk, wk (9, C, C) and dk
    (C, C) in bf16, then the float32 (B, L, C) h of its two passes, in the
    order csrc/local_track_segments_q8.cu takes them, from one buffer
    (256-byte aligned parts that do not overlap), and passes the parts'
    addresses; float32 (the CUDA-core plan) passes none."""
    from proteinbert_tpu_torch.kernels import KERNELS

    args = []
    for k in KERNELS:   # record the arguments too
        monkeypatch.setattr(k, "launch", lambda *a, k=k: args.append(a))
    C, B, L, S = 256, 2, 40, 3
    bf16, f32 = torch.bfloat16, torch.float32
    layout, nbytes = tfused.track_scratch_layout(B, L, C, True)
    assert [(shape, dt) for shape, dt, _ in layout] == [
        ((9, C, C), bf16), ((9, C, C), bf16), ((C, C), bf16),
        ((B, L, C), f32)]
    offsets = [off for _, _, off in layout]
    ends = [off + np.prod(shape) * dt.itemsize for shape, dt, off in layout]
    assert all(off % 256 == 0 for off in offsets)
    assert offsets[0] == 0 and ends[:-1] <= offsets[1:] and ends[-1] <= nbytes
    out = tfused._segments_kernel(
        _meta_track(C), _meta(B, L, C, dtype=dtype),
        _meta(B, S, C, dtype=dtype), _meta(B, L, dtype=torch.int32), 1, 5)
    assert out.shape == (B, L, C) and out.dtype == dtype
    (a,) = args
    assert len(a) == len(tfused.LOCAL_TRACK_SEGMENTS_Q8.argtypes)
    # dtype, x, seg, bcast, (nq, ns), nb, (wq, ws), wb, s1, b1, (dq, ds),
    # db, s2, b2, then the scratches nk, wk, dk, h
    ptrs = a[17:21]
    if dtype == torch.float32:
        assert ptrs == (None,) * 4
    else:
        assert [q - ptrs[0] for q in ptrs] == offsets


@pytest.mark.parametrize("name", ["narrow_conv", "wide_conv", "local_dense"])
def test_track_dequantize_plain_version_is_the_fp_legs_weights(qinputs,
                                                               name):
    """The plain version of #3-int8's dequantize pass
    (`track_dequant_reference`, q·scale in float32 cast to bf16, the
    values csrc/local_track_sm90.cuh `dequant_track_kernel` writes) equals,
    bit for bit, the bf16 weights the floating-point leg launches with on
    the dequantized weights: `dequant_params`, then `weight_operands`."""
    leaf = qinputs["ttrack"][name]["kernel"]
    got = tfused.track_dequant_reference(leaf["q"], leaf["scale"])
    (want,) = tfused.weight_operands(
        "t", tfused.dequant_params({"k": leaf})["k"], torch.bfloat16)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == leaf["q"].shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("name", ["wk", "wv"])
def test_attention_dequantize_plain_version_is_the_fp_legs_weights(qinputs,
                                                                   name):
    """The plain version of the attention's dequantize pass (K2-int8's and
    #6-int8's `dequant_kv_kernel`, csrc/attention_sm90.cuh):
    `kv_dequant_reference`, q·scale in float32 cast to bf16, equals, bit for
    bit, the bf16 weights the floating-point leg launches with on the
    dequantized weights: `dequant_params`, then `weight_operands`."""
    leaf = qinputs["tattn"][name]
    got = tattn.kv_dequant_reference(leaf["q"], leaf["scale"])
    (want,) = tattn.weight_operands(
        "t", tfused.dequant_params({"k": leaf})["k"], torch.bfloat16)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == leaf["q"].shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("operand", ["x", "narrow_conv", "local_dense",
                                     "wq", "wk", "wv"])
def test_onepass_int8_refuses_what_it_cannot_read(operand, recorded):
    """#6's int8 leg in bf16 raises ValueError, before any launch, for an x
    whose base is not 16-byte aligned (its conv pass reads x by TMA) or an
    int8 weight its dequantize passes (track, and wk / wv) or its query
    pass (wq) cannot read in 16-byte loads; aligned operands launch once."""
    C, B, L, S = 128, 2, 24, 3
    track, attn = _meta_track(C), _meta_attn(C, 512, 4, 128)
    x = _meta(B, L, C)
    if operand == "x":
        target = x
    elif operand in attn:
        target = attn[operand]["q"]
    else:
        target = track[operand]["kernel"]["q"]
    n = target.numel()
    flat = _meta(n + 16, dtype=target.dtype)

    def call(t):
        tr, at, xx = track, attn, x
        if operand == "x":
            xx = t
        elif operand in attn:
            at = {**attn, operand: {**attn[operand], "q": t}}
        else:
            tr = {**track, operand: {**track[operand],
                                     "kernel": {**track[operand]["kernel"],
                                                "q": t}}}
        return tone._onepass_kernel(
            tr, at, xx, _meta(B, S, C), _meta(B, S, 512),
            _meta(B, L, dtype=torch.int32), _meta(B, L, dtype=torch.bool),
            1, 5, True)

    with pytest.raises(ValueError, match="16-byte aligned"):
        call(flat[1:n + 1].view(target.shape))
    assert recorded == []
    local, out = call(flat[16:n + 16].view(target.shape))
    assert local.shape == (B, L, C) and out.shape == (B, S, 512)
    assert recorded == [("one_pass_q8", len(tone.ONEPASS_Q8.argtypes))]


@pytest.mark.parametrize("G,H,ok", [(512, 8, True), (512, 4, True),
                                    (384, 4, False)])
def test_attention_int8_kernel_value_dims(G, H, ok, recorded):
    """K2's int8 leg covers value_dim 64 and 128."""
    args = (_meta_attn(128, G, H, G // H), _meta(2, 16, 128), _meta(2, 1, G),
            _meta(2, 16, dtype=torch.int32), False)
    if not ok:
        with pytest.raises(ValueError):
            tattn._attention_launch(*args)
        assert recorded == []
        return
    assert tattn._attention_launch(*args).shape == (2, 1, G)
    assert recorded == [("global_attention_q8",
                         len(tattn.ATTENTION_Q8.argtypes))]


@pytest.mark.parametrize("operand", ["x", "wq", "wk", "wv"])
@pytest.mark.parametrize("entry", ["dense", "packed"])
def test_attention_int8_refuses_what_it_cannot_read(entry, operand,
                                                    recorded):
    """K2's int8 leg in bf16 raises ValueError, before any launch, for an x
    whose base is not 16-byte aligned (TMA reads it) or an int8 wq, wk or
    wv that its query or dequantize pass cannot read in vector loads;
    aligned operands launch once."""
    S = 1 if entry == "dense" else 8
    params = _meta_attn(256, 512, 8, 64)
    x = _meta(2, 48, 256)
    target = x if operand == "x" else params[operand]["q"]
    n = target.numel()
    flat = _meta(n + 16, dtype=target.dtype)

    def call(t):
        p = params if operand == "x" else {
            **params, operand: {**params[operand], "q": t}}
        return tattn._attention_launch(
            p, t if operand == "x" else x, _meta(2, S, 512),
            _meta(2, 48, dtype=torch.int32), entry == "packed")

    with pytest.raises(ValueError, match="16-byte aligned"):
        call(flat[1:n + 1].view(target.shape))
    assert recorded == []
    assert call(flat[16:n + 16].view(target.shape)).shape == (2, S, 512)
    assert recorded == [("global_attention_q8",
                         len(tattn.ATTENTION_Q8.argtypes))]


@pytest.mark.parametrize("v", [64, 128])
def test_attention_int8_scratches_have_the_c_entry_shapes(v, monkeypatch,
                                                          recorded):
    """K2's int8 leg in bf16 carves the dequantized wk (H, C, 64) and wv
    (H, C, v) in bf16, then the floating-point leg's q, scores and V, in
    the order csrc/global_attention_q8.cu takes them, from one buffer,
    and passes the parts' addresses."""
    from proteinbert_tpu_torch.kernels import KERNELS

    args = []
    for k in KERNELS:   # record the arguments too
        monkeypatch.setattr(k, "launch", lambda *a, k=k: args.append(a))
    B, L, C, S, H = 2, 48, 256, 8, 512 // v
    bf16, f32 = torch.bfloat16, torch.float32
    layout, _ = tattn.attention_scratch_layout(B, L, C, S, H, v, True)
    assert [(shape, dtype) for shape, dtype, _ in layout] == [
        ((H, C, 64), bf16), ((H, C, v), bf16), ((B, S, H, 64), f32),
        ((B, H, S, L), f32), ((B, L, 512), bf16)]
    tattn._attention_launch(_meta_attn(C, 512, H, v), _meta(B, L, C),
                            _meta(B, S, 512), _meta(B, L, dtype=torch.int32),
                            True)
    (a,) = args
    assert len(a) == len(tattn.ATTENTION_Q8.argtypes)
    # dtype, x, ids, g, (wq, sq), (wk, sk), (wv, sv), then the scratches
    ptrs = a[10:15]
    assert [p - ptrs[0] for p in ptrs] == [off for _, _, off in layout]


@pytest.mark.parametrize("case", ["bf16_c128", "bf16_c512", "fp32_c512",
                                  "mixed"])
def test_onepass_int8_kernel_shapes(case, recorded):
    """#6's int8 leg covers the fp leg's widths (bf16 128/256/512, fp32
    128/256) and wants both weight sets int8."""
    c = 512 if "c512" in case else 128
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    track = _meta_track(c)
    attn = _meta_attn(c, 512, 4, 128, quant=case != "mixed")
    args = (track, attn, _meta(2, 16, c, dtype=dtype),
            _meta(2, 1, c, dtype=dtype), _meta(2, 1, 512, dtype=dtype), None,
            _meta(2, 16, dtype=torch.bool), 1, 5, False)
    if case in ("fp32_c512", "mixed"):
        with pytest.raises(ValueError):
            tone._onepass_kernel(*args)
        assert recorded == []
        return
    local, attn_out = tone._onepass_kernel(*args)
    assert local.shape == (2, 16, c) and attn_out.shape == (2, 1, 512)
    assert recorded == [("one_pass_q8", len(tone.ONEPASS_Q8.argtypes))]


# ---------------------------------------------------- dispatch + server

def _tokens(tcfg, seq):
    L = next(b for b in BUCKETS if b >= len(seq) + 2)
    return tinf._tokenize_masked([seq], tcfg.data.seq_len)[:, :L]


def _jax_entry(fn, jq, tokens, ann, jcfg):
    out = fn(jq, jnp.asarray(tokens), jnp.asarray(ann), jcfg.model)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_int8_server_matches_jax_quant_entry(pair, mode):
    """Every answer of the port's int8 server (either mode) equals the JAX
    `quant_entry` on the same tokens at the request's bucket length."""
    jcfg, tcfg, jparams, tparams = pair
    jq = jquant.quantize_params(jparams)
    kw = (dict(serve_mode="ragged", pack_max_segments=4, max_batch=2)
          if mode == "ragged" else dict(max_batch=4))
    A = tcfg.model.num_annotations
    with Server(tparams, tcfg, device="cpu", buckets=BUCKETS, quant="int8",
                max_wait_s=0.005, **kw) as srv:
        futs = [(seq, srv.submit("embed", seq)) for seq in SEQS]
        go = srv.submit("predict_go", SEQS[1])
        for seq, fut in futs:
            got = fut.result(60)
            want = _jax_entry(jquant.quant_entry("embed"), jq,
                              _tokens(tcfg, seq), np.zeros((1, A)), jcfg)
            _close(want["global"][0], got["global"])
            _close(want["local_mean"][0], got["local_mean"])
        want = _jax_entry(jquant.quant_entry("predict_go"), jq,
                          _tokens(tcfg, SEQS[1]), np.zeros((1, A)), jcfg)
        _close(want[0], go.result(60))
        stats = srv.stats()["quant"]
    assert stats["mode"] == "int8" and stats["fp32_resident"] == "host"
    assert stats["weight_bytes_ratio"] <= 0.30


def test_ragged_dispatcher_matches_jax_quant_packed_entry(pair):
    """One packed batch through `RaggedDispatcher(quant="int8")` against
    the JAX `quant_packed_entry` on the same packed arrays."""
    jcfg, tcfg, jparams, tparams = pair
    jq = jquant.quantize_params(jparams)
    disp = RaggedDispatcher(tparams, tcfg, buckets=BUCKETS, rows_per_batch=2,
                            max_segments=S, device="cpu", quant="int8")
    Lfull = tcfg.data.seq_len
    tokens = np.zeros((2, Lfull), np.int32)
    seg = np.zeros((2, Lfull), np.int32)
    ann = np.zeros((2, S, tcfg.model.num_annotations), np.float32)
    riders, layout = [], [[SEQS[0], SEQS[1], SEQS[2]], [SEQS[4]]]
    for r, seqs in enumerate(layout):
        pos = 0
        for s, seq in enumerate(seqs):
            t = _tokens(tcfg, seq)[0]
            tokens[r, pos:pos + len(t)] = t
            seg[r, pos:pos + len(t)] = s + 1
            riders.append((r, s, pos, len(t)))
            pos += len(t)
    ann[0, 1, :5] = 1.0
    for kind in ("embed", "predict_residues"):
        got = disp.run_packed(kind, tokens, seg, ann, riders)
        host = jax.tree.map(np.asarray, jquant.quant_packed_entry(kind)(
            jq, jnp.asarray(tokens), jnp.asarray(seg), jnp.asarray(ann),
            jcfg.model))
        for (row, s, start, span), g in zip(riders, got):
            if kind == "embed":
                _close(host["global"][row, s], g["global"])
                _close(host["local_mean"][row, s], g["local_mean"])
            else:
                _close(host[row, start:start + span], g)


def test_int8_act_dispatcher_matches_jax(pair):
    """The activation arm (bucketed only) against `_q_act_encode_batch`
    and `_q_act_go_probs_batch`. Tolerance: one step of the fake-quant
    grid (amax/127 of the trunk output) for a pooled/probability output,
    where a float32 difference of 1e-6 may move an element across a
    rounding boundary; every other element agrees to 1e-5."""
    jcfg, tcfg, jparams, tparams = pair
    jq = jquant.quantize_params(jparams)
    disp = BucketDispatcher(tparams, tcfg, buckets=BUCKETS, max_batch=2,
                            device="cpu", quant="int8_act")
    tokens = np.concatenate([_tokens(tcfg, s) for s in SEQS[:2]])
    ann = np.zeros((2, tcfg.model.num_annotations), np.float32)
    ann[1, 3] = 1.0
    got = disp.run("embed", tokens, ann)
    want = _jax_entry(jquant._q_act_encode_batch, jq, tokens, ann, jcfg)
    for k in ("global", "local_mean"):
        step = float(np.abs(want[k]).max()) / 127.0
        diff = np.abs(want[k] - got[k])
        assert diff.max() <= step, k
        assert (diff > TOL).sum() <= 2, k
    got = disp.run("predict_go", tokens, ann)
    want = _jax_entry(jquant._q_act_go_probs_batch, jq, tokens, ann, jcfg)
    np.testing.assert_allclose(want, got, atol=0.01)
    # The activation arm changes the answer: it is not the weight-only one.
    plain = BucketDispatcher(tparams, tcfg, buckets=BUCKETS, max_batch=2,
                             device="cpu", quant="int8")
    assert parity_max(plain.run("embed", tokens, ann),
                      disp.run("embed", tokens, ann)) > 0


def test_quant_modes_are_checked(pair):
    _, tcfg, _, tparams = pair
    with pytest.raises(ValueError, match="bucketed-arm"):
        RaggedDispatcher(tparams, tcfg, buckets=BUCKETS, device="cpu",
                         quant="int8_act")
    with pytest.raises(ValueError, match="bucketed-arm"):
        Server(tparams, tcfg, device="cpu", buckets=BUCKETS,
               serve_mode="ragged", quant="int8_act")
    for bad in ("int4", "bf16"):
        with pytest.raises(ValueError, match="quant must be one of"):
            BucketDispatcher(tparams, tcfg, buckets=BUCKETS, device="cpu",
                             quant=bad)
        with pytest.raises(ValueError, match="quant must be one of"):
            Server(tparams, tcfg, device="cpu", buckets=BUCKETS, quant=bad)


def test_server_quant_defaults_come_from_the_config(pair):
    _, tcfg, _, tparams = pair
    cfg = tcfg.replace(serve=dataclasses.replace(
        tcfg.serve, quant="int8", quant_parity_every=3))
    srv = Server(tparams, cfg, device="cpu", buckets=BUCKETS)
    assert srv.dispatcher.quant == "int8"
    assert srv.dispatcher.quant_parity_every == 3
    assert Server(tparams, cfg, device="cpu", buckets=BUCKETS,
                  quant="fp32").stats()["quant"] is None


def test_fp32_tree_residency(pair):
    """Without a parity shadow the fp32 tree moves to the host and the
    batches read only the int8 tree; with one it stays where it was."""
    _, tcfg, _, tparams = pair
    parked = BucketDispatcher(tparams, tcfg, buckets=BUCKETS, device="cpu",
                              quant="int8", quant_parity_every=0)
    assert parked.quant_report["fp32_resident"] == "host"
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(
        parked.params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    quantized, run_params = parked._arm()
    assert quantized and run_params is parked.qparams
    shadow = BucketDispatcher(tparams, tcfg, buckets=BUCKETS, device="cpu",
                              quant="int8", quant_parity_every=2)
    assert shadow.quant_report["fp32_resident"] == "device"
    assert shadow.params is tparams


def test_parity_cadence_skips_warmup(pair):
    """Warmup batches neither consume the parity cadence nor count as
    samples; with N=2 live batches 1 and 3 run the fp32 shadow, and
    parity_max is the worst deviation measured outside."""
    _, tcfg, _, tparams = pair
    disp = BucketDispatcher(tparams, tcfg, buckets=BUCKETS, max_batch=2,
                            device="cpu", quant="int8", quant_parity_every=2)
    fp32 = BucketDispatcher(tparams, tcfg, buckets=BUCKETS, max_batch=2,
                            device="cpu")
    assert disp.warmup(("embed",)) == len(BUCKETS) * 2
    assert disp._quant_batches == 0
    assert "parity_samples" not in disp.quant_report
    worst, stamps = 0.0, []
    for seq in SEQS[:3]:
        tokens = _tokens(tcfg, seq)
        out, timings = disp.run_timed("embed", tokens)
        sampled = "quant_parity_max" in timings
        stamps.append((sampled, timings["quant"]))
        if sampled:
            worst = max(worst, parity_max(out, fp32.run("embed", tokens)))
    assert stamps == [(True, "int8"), (False, "int8"), (True, "int8")]
    assert disp.quant_report["parity_samples"] == 2
    assert worst > 0
    assert disp.quant_parity_max == worst
