"""The port's packed kernel modules on the CPU: the plain versions of #3
(segment-masked local track) and #6 (one-pass trunk, both entries) against
the JAX package's Pallas kernels in interpret mode and its plain
references, on the same numpy-seeded inputs, at C=128 with the reference
model's head shape (G=512, H=4, k=64, v=128); the port's one-pass rule
against `pallas_onepass_supported` on the shape grid; cross-segment
isolation bit for bit. float32, tolerance 1e-5 (same arithmetic, another
summation order). #6's bf16 passes (csrc/one_pass_sm90.cuh) by their plain
versions: the mask ids of the query pass against the JAX kernel's
`seg_oh * real`, and the passes chained against the JAX reference; the
launcher's refusals and scratch on meta tensors. The CUDA kernels are held
against these plain versions on the card by chip_smoke.py."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.kernels import fused_block as jfused
from proteinbert_tpu.kernels import one_pass as jone
from proteinbert_tpu.ops import attention as jops
from proteinbert_tpu_torch.kernels import budget
from proteinbert_tpu_torch.kernels import fused_block as tfused
from proteinbert_tpu_torch.kernels import one_pass as tone
from proteinbert_tpu_torch.ops import attention as tops

torch.set_num_threads(1)

TOL = 1e-5
C, G, H, K = 128, 512, 4, 64
B, L, S = 2, 64, 4


def _track_params(rng):
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


def _attn_params(rng):
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


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _close(want, got):
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=TOL,
                               atol=TOL)


def _seg():
    """Packed rows: boundaries mid-row, a pad gap, an id above S (pad by
    contract), segment 4 empty in row 0, a pad tail."""
    seg = np.zeros((B, L), np.int32)
    seg[0, :20], seg[0, 20:45], seg[0, 48:60] = 1, 2, 3
    seg[1, :10], seg[1, 10:30], seg[1, 30:36], seg[1, 36:64] = 1, 2, 6, 4
    return seg


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    return {"track": _track_params(rng), "attn": _attn_params(rng),
            "x": rng.standard_normal((B, L, C)).astype(np.float32),
            "bseg": rng.standard_normal((B, S, C)).astype(np.float32),
            "gseg": rng.standard_normal((B, S, G)).astype(np.float32),
            "seg": _seg(),
            "real": rng.random((B, L)) < 0.9}


# ------------------------------------------------------------------ #3

def test_segment_track_matches_pallas_and_references(inputs):
    p, x, bseg, seg = (inputs[k] for k in ("track", "x", "bseg", "seg"))
    got = tfused.fused_local_track_segments(_torch(p), _torch(x),
                                            _torch(bseg), _torch(seg), 1, 5)
    pallas = jfused.fused_local_track_segments(
        _jax(p), _jax(x), _jax(bseg), _jax(seg), 1, 5, True)
    _close(pallas, got)
    oh = (seg[..., None] == np.arange(1, S + 1)).astype(np.float32)
    _close(jfused.local_track_segment_oh_reference(
        _jax(p), _jax(x), _jax(bseg), _jax(oh), 1, 5), got)
    # The integer-id form with the per-position gather: ids 1..S only
    # (the JAX id form keeps ids above S as segments of their own).
    seg_in = np.where(seg > S, 0, seg)
    pos = tfused.gather_segment_broadcast(_torch(bseg), _torch(seg_in))
    want_pos = jfused.gather_segment_broadcast(_jax(bseg), _jax(seg_in))
    np.testing.assert_array_equal(np.asarray(want_pos), pos.numpy())
    got_ids = tfused.local_track_segment_reference(
        _torch(p), _torch(x), pos, _torch(seg_in), 1, 5)
    _close(jfused.local_track_segment_reference(
        _jax(p), _jax(x), want_pos, _jax(seg_in), 1, 5), got_ids)
    _close(pallas, got_ids)


def test_segment_track_one_full_segment_is_the_dense_track(inputs):
    """One segment over the whole row: the masks are all 1, so #3's plain
    version is K1's, bit for bit."""
    p, x, bseg = (_torch(inputs[k]) for k in ("track", "x", "bseg"))
    ones = torch.ones((B, L), dtype=torch.int32)
    got = tfused.fused_local_track_segments(p, x, bseg, ones)
    want = tfused.fused_local_track(p, x, bseg[:, 0])
    np.testing.assert_allclose(want.numpy(), got.numpy(), rtol=TOL,
                               atol=TOL)


# ------------------------------------------------------------------ #6

def test_onepass_segments_matches_pallas(inputs):
    t = {k: _torch(v) for k, v in inputs.items()}
    j = {k: _jax(v) for k, v in inputs.items()}
    before = jone.ONEPASS_PATH_TOTAL.get(("pallas", "packed"), 0)
    wl, wa = jone.fused_onepass_segments(
        j["track"], j["attn"], j["x"], j["bseg"], j["gseg"], j["seg"],
        j["real"], interpret=True)
    assert jone.ONEPASS_PATH_TOTAL[("pallas", "packed")] == before + 1
    gl, ga = tone.fused_onepass_segments(
        t["track"], t["attn"], t["x"], t["bseg"], t["gseg"], t["seg"],
        t["real"])
    _close(wl, gl)
    _close(wa, ga)
    # Segment 4 is empty in row 0: exactly +0.0, as the TPU kernel zeroes it.
    assert (ga[0, 3] == 0).all() and not torch.signbit(ga[0, 3]).any()
    oh = (inputs["seg"][..., None] == np.arange(1, S + 1)).astype(np.float32)
    rl, ra = jone.onepass_oh_reference(
        j["track"], j["attn"], j["x"], j["bseg"], j["gseg"], jnp.asarray(oh),
        j["real"][..., None].astype(jnp.float32))
    _close(rl, gl)
    _close(ra, ga)


def test_onepass_dense_matches_pallas(inputs):
    t = {k: _torch(v) for k, v in inputs.items()}
    j = {k: _jax(v) for k, v in inputs.items()}
    pad = np.ones((B, L), bool)
    pad[0, L // 3:] = False
    pad[1] = False  # all-pad row: uniform softmax, not NaN
    before = jone.ONEPASS_PATH_TOTAL.get(("pallas", "dense"), 0)
    wl, wa = jone.fused_onepass_dense(
        j["track"], j["attn"], j["x"], j["bseg"][:, 0], j["gseg"][:, 0],
        jnp.asarray(pad), interpret=True)
    assert jone.ONEPASS_PATH_TOTAL[("pallas", "dense")] == before + 1
    gl, ga = tone.fused_onepass_dense(
        t["track"], t["attn"], t["x"], t["bseg"][:, 0], t["gseg"][:, 0],
        torch.from_numpy(pad))
    assert ga.shape == (B, G) and torch.isfinite(ga).all()
    _close(wl, gl)
    _close(wa, ga)


def test_cross_segment_isolation_is_bit_exact(inputs):
    """New tokens in segment 2 change nothing outside it: other positions'
    local outputs and other segments' attention outputs are bit-identical,
    in both the #3 and the #6 plain versions."""
    t = {k: _torch(v) for k, v in inputs.items()}
    sel = t["seg"] == 2
    x2 = t["x"].clone()
    x2[sel] = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (int(sel.sum()), C)).astype(np.float32))
    runs = []
    for x in (t["x"], x2):
        runs.append((tfused.fused_local_track_segments(
            t["track"], x, t["bseg"], t["seg"]),) + tone.fused_onepass_segments(
            t["track"], t["attn"], x, t["bseg"], t["gseg"], t["seg"],
            t["real"]))
    (a_track, a_local, a_attn), (b_track, b_local, b_attn) = runs
    assert torch.equal(a_track[~sel], b_track[~sel])
    assert torch.equal(a_local[~sel], b_local[~sel])
    assert not torch.equal(a_local[sel], b_local[sel])
    others = [0, 2, 3]
    assert torch.equal(a_attn[:, others], b_attn[:, others])


def test_packed_attention_reference_matches_jax(inputs):
    rng = np.random.default_rng(12)
    local = rng.standard_normal((B, L, C)).astype(np.float32)
    want = jops.packed_global_attention_apply(
        _jax(inputs["attn"]), _jax(local), _jax(inputs["gseg"]),
        _jax(inputs["seg"]), _jax(inputs["real"]))
    got = tops.packed_global_attention_apply(
        _torch(inputs["attn"]), _torch(local), _torch(inputs["gseg"]),
        _torch(inputs["seg"]), _torch(inputs["real"]))
    _close(want, got)


# ------------------------------------------------------- the one-pass rule

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads", [(512, 4, 64), (512, 8, 64)],
                         ids=["default", "base"])
def test_onepass_rule_equals_the_reference(dtype, heads):
    Gh, Hh, k = heads
    tdtype = getattr(torch, dtype)
    grid = [(c, length, s) for c in (128, 256, 512)
            for length in (128, 256, 512, 1024) for s in (1, 8)]
    for c, length, s in grid:
        want = jone.pallas_onepass_supported(c, Gh, length, s, k, Hh, dtype)
        assert budget.onepass_supported(
            c, Gh, length, s, k, Hh, tdtype) == want, (c, length, s)
    # The served shapes: the base preset never runs #6, the reference
    # model's default width runs it up to L=1024.
    if Hh == 8:
        assert not any(budget.onepass_supported(512, Gh, n, s, k, Hh, tdtype)
                       for n in (128, 256, 512) for s in (1, 8))
    else:
        assert all(budget.onepass_supported(128, Gh, n, s, k, Hh, tdtype)
                   for n in (128, 256, 512, 1024) for s in (1, 8))


def _meta_operands(C, Gh, Hh, k, length, s, dtype, packed):
    """Meta tensors of the shapes `_onepass_kernel` is called with."""
    def meta(*shape, dt=dtype):
        return torch.empty(shape, device="meta", dtype=dt)

    track = {name: {"kernel": meta(C, C), "bias": meta(C), "scale": meta(C)}
             for name in tfused.TRACK_PARAMS}
    for name in ("narrow_conv", "wide_conv"):
        track[name]["kernel"] = meta(9, C, C)
    attn = {"wq": meta(Hh, Gh, k), "wk": meta(Hh, C, k),
            "wv": meta(Hh, C, Gh // Hh)}
    seg = meta(2, length, dt=torch.int32) if packed else None
    return (track, attn, meta(2, length, C), meta(2, s, C), meta(2, s, Gh),
            seg, meta(2, length, dt=torch.bool))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("heads", [(512, 4, 64), (512, 8, 64)],
                         ids=["default", "base"])
def test_kernel_covers_every_shape_the_rule_admits(dtype, heads):
    """Wherever the one-pass rule sends a shape to #6 on the card,
    `check_onepass_shapes` accepts it (the CUDA kernel has the
    instantiation): C in {128, 256, 512}, L from 8 to 512, S in
    {1, 8, 16}, dense and packed. The rule admits the base preset's
    C=512, H=8 at L=8 in bfloat16, and never float32 at C=512, where the
    kernel has no instantiation."""
    Gh, Hh, k = heads
    admitted = 0
    for C in (128, 256, 512):
        for length in (8, 16, 32, 64, 128, 256, 512):
            for s in (1, 8, 16):
                if not budget.onepass_supported(C, Gh, length, s, k, Hh,
                                                dtype):
                    continue
                admitted += 1
                for packed in (s > 1, True):
                    tone.check_onepass_shapes(*_meta_operands(
                        C, Gh, Hh, k, length, s, dtype, packed))
    assert admitted > 0
    if dtype == torch.bfloat16:
        assert budget.onepass_supported(512, 512, 8, 1, 64, 8, dtype)
    else:
        assert not any(budget.onepass_supported(512, Gh, n, s, k, Hh, dtype)
                       for n in (8, 16, 128) for s in (1, 8))
        with pytest.raises(ValueError, match="C=512"):
            tone.check_onepass_shapes(*_meta_operands(
                512, Gh, Hh, k, 8, 1, dtype, False))


# ------------------------------------------- launch or raise, never fall back

def test_wrappers_raise_on_devices_they_do_not_run_on(inputs):
    p, a = _torch(inputs["track"]), _torch(inputs["attn"])

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)

    seg = meta(B, L, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.fused_local_track_segments(p, meta(B, L, C), meta(B, S, C),
                                          seg)
    with pytest.raises(ValueError, match="unsupported device"):
        tone.fused_onepass_segments(p, a, meta(B, L, C), meta(B, S, C),
                                    meta(B, S, G), seg)
    with pytest.raises(ValueError, match="unsupported device"):
        tone.fused_onepass_dense(p, a, meta(B, L, C), meta(B, C), meta(B, G))


def test_kernel_registry_and_flop_counts():
    from proteinbert_tpu_torch.kernels import KERNELS

    names = [k.name for k in KERNELS]
    assert names == ["local_track", "local_track_segments",
                     "global_attention", "one_pass", "local_track_tiled",
                     "local_track_segments_tiled", "local_track_segments_q8",
                     "global_attention_q8", "one_pass_q8",
                     "local_track_valid", "local_track_tiled_valid"]
    assert len({k.library_path() for k in KERNELS}) == 11
    # one_pass.py:362-366 at the default-width served shape: 3.42 GFLOP.
    flops = tone.onepass_flops(8, 512, 128, 512, 8, 4, 64)
    assert flops == (2 * 8 * 512 * 128**2 * 19
                     + 2 * 8 * 4 * (512 * 128 * 192 + 8 * 512 * 64
                                    + 512 * 8 * 192))
    assert round(flops / 989e12 * 1e3, 4) == 0.0035


# ------------------------------------------- #6's bf16 passes, plain versions

def _ids_case(rng, dense):
    """Seeded segment ids 0..S+2 (ids above S are pad by contract) with
    segment 2 empty in every row, a real mask, and for dense rows the
    `pad_mask` with row 1 all pad."""
    seg = rng.integers(0, S + 3, size=(B, L)).astype(np.int32)
    seg[seg == 2] = 0
    real = rng.random((B, L)) < 0.8
    if dense:
        real[1] = False
    return seg, real


@pytest.mark.parametrize("dense", [False, True], ids=["packed", "dense"])
def test_onepass_attention_ids_are_the_jax_mask(dense):
    """`onepass_attention_ids` (the mask ids #6's query pass writes) as a
    one-hot is the JAX kernel's attention mask `seg_oh * real`
    (one_pass.py:284-285): packed rows take the segment where real and in
    1..S, dense rows the pad mask itself (one segment, real = ones)."""
    seg, real = _ids_case(np.random.default_rng(21), dense)
    if dense:
        oh = jnp.asarray(real[..., None], jnp.float32)
        want = oh * jnp.ones((B, L, 1), jnp.float32)
        ids = tone.onepass_attention_ids(None, torch.from_numpy(real), 1)
        got = tattn_ids_one_hot(ids, 1)
    else:
        oh = jattn_segment_one_hot(jnp.asarray(seg), S)
        want = oh * jnp.asarray(real[..., None], jnp.float32)
        ids = tone.onepass_attention_ids(torch.from_numpy(seg),
                                         torch.from_numpy(real), S)
        got = tattn_ids_one_hot(ids, S)
        assert int(ids.max()) <= S and not (ids == 2).any()
    assert ids.dtype == torch.int32 and ids.shape == (B, L)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    if dense:
        assert not got[1].any()  # the all-pad row: no position in segment 1


def tattn_ids_one_hot(ids, n):
    from proteinbert_tpu_torch.kernels.attention import ids_one_hot
    return ids_one_hot(ids, n)


def jattn_segment_one_hot(seg, n):
    from proteinbert_tpu.kernels.attention import _segment_one_hot
    return _segment_one_hot(seg, n, jnp.float32)


@pytest.mark.parametrize("dense", [False, True], ids=["packed", "dense"])
def test_onepass_passes_reference_matches_jax(inputs, dense):
    """The bf16 passes' plain versions chained (query and ids → local
    track → projection: scores and V → softmax) are the JAX
    `onepass_oh_reference` in float32 within 1e-5, packed (an empty
    segment exactly +0.0) and dense (an all-pad row: the uniform
    softmax)."""
    t = {k: _torch(v) for k, v in inputs.items()}
    j = {k: _jax(v) for k, v in inputs.items()}
    if dense:
        pad = np.ones((B, L), bool)
        pad[0, L // 3:] = False
        pad[1] = False
        want = jone.onepass_oh_reference(
            j["track"], j["attn"], j["x"], j["bseg"][:, :1], j["gseg"][:, :1],
            jnp.asarray(pad[..., None], jnp.float32),
            jnp.ones((B, L, 1), jnp.float32), seg_masked=False,
            zero_empty=False)
        got = tone.onepass_passes_reference(
            t["track"], t["attn"], t["x"], t["bseg"][:, :1],
            t["gseg"][:, :1], None, torch.from_numpy(pad), zero_empty=False)
        assert torch.isfinite(got[1]).all()
    else:
        oh = (inputs["seg"][..., None] == np.arange(1, S + 1)).astype(
            np.float32)
        want = jone.onepass_oh_reference(
            j["track"], j["attn"], j["x"], j["bseg"], j["gseg"],
            jnp.asarray(oh), j["real"][..., None].astype(jnp.float32))
        got = tone.onepass_passes_reference(
            t["track"], t["attn"], t["x"], t["bseg"], t["gseg"], t["seg"],
            t["real"])
        # Segment 4 is empty in row 0: exactly +0.0.
        assert (got[1][0, 3] == 0).all() and not torch.signbit(
            got[1][0, 3]).any()
    _close(want[0], got[0])
    _close(want[1], got[1])


def test_onepass_passes_reference_in_bf16(inputs):
    """In bf16 the chained passes round where the kernel rounds (q, K, V
    before and after tanh / gelu, the softmax weights) and so where the
    port's one-hot plain version `onepass_oh_reference` rounds; the two
    differ only in the order of a few float32 sums (the scores' 64-term
    dot products, laid out (B, H, S, L) here and (B, S, H, L) there), which
    can move a softmax weight across a bf16 rounding boundary: one bf16
    step of an output (< 2^-8 at |attn| < 1), so the tolerance is 2^-8."""
    t = {k: _torch(v) for k, v in inputs.items()}
    bf = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
          for k, v in (("x", t["x"]), ("bseg", t["bseg"]),
                       ("gseg", t["gseg"]))}
    oh = torch.from_numpy(
        (inputs["seg"][..., None] == np.arange(1, S + 1)).astype(np.float32))
    want = tone.onepass_oh_reference(
        t["track"], t["attn"], bf["x"], bf["bseg"], bf["gseg"], oh,
        t["real"][..., None].float())
    got = tone.onepass_passes_reference(
        t["track"], t["attn"], bf["x"], bf["bseg"], bf["gseg"], t["seg"],
        t["real"])
    assert got[1].dtype == torch.bfloat16
    assert torch.equal(want[0], got[0])
    err = (want[1].float() - got[1].float()).abs().max().item()
    assert err <= 2.0 ** -8, err


# ------------------------------------- #6's launcher in bf16 (meta tensors)

@pytest.fixture
def onepass_launches(monkeypatch):
    """#6's launches recorded (name, arguments), not run."""
    calls = []
    for k in (tone.ONEPASS, tone.ONEPASS_Q8):
        monkeypatch.setattr(k, "launch", lambda *a, k=k: calls.append(
            (k.name, a)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tone, "stream_ptr", lambda d: 0)
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


def _meta_onepass(C, dtype, quant=False, Hh=4, v=128):
    """#6's operands at width C as meta tensors: the track, the attention
    (int8 quant leaves with float32 scales where `quant`), x and a packed
    row's broadcast, global rows, ids and real mask (B=2, L=40, S=3)."""
    Gh = Hh * v

    def w(*shape):
        if quant:
            return {"q": _meta(*shape, dtype=torch.int8),
                    "scale": _meta(*shape[:-2], shape[-1],
                                   dtype=torch.float32)}
        return _meta(*shape, dtype=dtype)

    track = {name: {k: _meta(C, dtype=torch.float32)
                    for k in ("bias", "scale")}
             for name in tfused.TRACK_PARAMS}
    for name in ("narrow_conv", "wide_conv"):
        track[name]["kernel"] = w(9, C, C)
    track["local_dense"]["kernel"] = w(C, C)
    attn = {"wq": w(Hh, Gh, 64), "wk": w(Hh, C, 64), "wv": w(Hh, C, v)}
    b, n, s = 2, 40, 3
    return (track, attn, _meta(b, n, C, dtype=dtype),
            _meta(b, s, C, dtype=dtype), _meta(b, s, Gh, dtype=dtype),
            _meta(b, n, dtype=torch.int32), _meta(b, n, dtype=torch.bool))


@pytest.mark.parametrize("operand", ["x", "narrow_conv", "wide_conv",
                                     "local_dense", "wq", "wk", "wv"])
@pytest.mark.parametrize("C", [128, 256, 512])
def test_onepass_launcher_refuses_what_tma_cannot_read(C, operand,
                                                       onepass_launches):
    """#6 in bf16 raises ValueError, before any launch, for an x or a
    weight whose base is not 16-byte aligned (TMA reads x, the conv and
    dense kernels, wk and wv; the query pass reads wq in 16-byte loads);
    the same call on aligned operands launches once, with the arguments
    the C signature declares. A strided x is copied contiguous first and
    launches too."""
    track, attn, x, bs, gs, seg, real = _meta_onepass(C, torch.bfloat16)
    if operand == "x":
        target = x
    elif operand in attn:
        target = attn[operand]
    else:
        target = track[operand]["kernel"]
    n = target.numel()
    flat = _meta(n + 8)

    def call(t):
        tr, at, xx = track, attn, x
        if operand == "x":
            xx = t
        elif operand in attn:
            at = {**attn, operand: t}
        else:
            tr = {**track, operand: {**track[operand], "kernel": t}}
        return tone._onepass_kernel(tr, at, xx, bs, gs, seg, real, 1, 5,
                                    True)

    with pytest.raises(ValueError, match="16-byte aligned"):
        call(flat[1:n + 1].view(target.shape))
    assert onepass_launches == []
    local, out = call(flat[8:n + 8].view(target.shape))
    assert local.shape == x.shape and out.shape == gs.shape
    assert [(name, len(a)) for name, a in onepass_launches] == [
        ("one_pass", len(tone.ONEPASS.argtypes))]
    if operand == "x":
        wide = _meta(*x.shape[:-1], C + 8)[..., :C]  # an odd row stride
        assert not wide.is_contiguous()
        call(wide)
        assert len(onepass_launches) == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_onepass_scratches_have_the_c_entry_shapes(quant, dtype,
                                                   onepass_launches):
    """In bf16 #6 passes one scratch buffer, just after attn, whose parts
    `onepass_scratch_layout` lays out in the order the C entry carves them
    (csrc/one_pass_sm90.cuh `onepass_scratch`), each 256-byte aligned: on
    the int8 leg the dequantized track and attention weights first, then
    h, q, the mask ids, the scores (one a position) and V. float32 (the
    one-launch cluster plan) takes q alone."""
    C, Hh, v = 128, 4, 128
    track, attn, x, bs, gs, seg, real = _meta_onepass(C, dtype, quant, Hh, v)
    b, n, _ = x.shape
    s = bs.shape[1]
    layout, nbytes = tone.onepass_scratch_layout(b, n, C, s, Hh, v, quant,
                                                 dtype, 64, 9, 9)
    if dtype == torch.float32:
        assert layout == (((b, s, Hh, 64), torch.float32, 0),)
        assert nbytes % 256 == 0 and nbytes >= b * s * Hh * 64 * 4
    else:
        want = ([((9, C, C), torch.bfloat16)] * 2
                + [((C, C), torch.bfloat16), ((Hh, C, 64), torch.bfloat16),
                   ((Hh, C, v), torch.bfloat16)] if quant else [])
        want += [((b, n, C), torch.float32),
                 ((b, s, Hh, 64), torch.float32), ((b, n), torch.int32),
                 ((b, Hh, n), torch.float32),
                 ((b, n, Hh * v), torch.bfloat16)]
        assert [(shape, dt) for shape, dt, _ in layout] == want
        end = 0
        for shape, dt, off in layout:
            assert off % 256 == 0 and off >= end
            end = off + int(np.prod(shape)) * dt.itemsize
        assert nbytes % 256 == 0 and nbytes >= end
    tone._onepass_kernel(track, attn, x, bs, gs, seg, real, 1, 5, True)
    ((name, a),) = onepass_launches
    kernel = tone.ONEPASS_Q8 if quant else tone.ONEPASS
    assert name == kernel.name and len(a) == len(kernel.argtypes)
    # ..., local, attn, scratch, then B, L, C, G, S, H, key_dim, the narrow
    # and wide taps and dilations, zero_empty and the stream.
    assert a[-14] is not None
    assert a[-15] is not None and a[-7:-1] == (64, 9, 9, 1, 5, 1)
    assert a[:2] == (tfused.KERNEL_DTYPES[dtype], 1)
