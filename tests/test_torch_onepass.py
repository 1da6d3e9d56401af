"""The port's packed kernel modules on the CPU: the plain versions of #3
(segment-masked local track) and #6 (one-pass trunk, both entries) against
the JAX package's Pallas kernels in interpret mode and its plain
references, on the same numpy-seeded inputs, at C=128 with the reference
model's head shape (G=512, H=4, k=64, v=128); the port's one-pass rule
against `pallas_onepass_supported` on the shape grid; cross-segment
isolation bit for bit. float32, tolerance 1e-5 (same arithmetic, another
summation order). The CUDA kernels are held against these plain versions
on the card by chip_smoke.py."""

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
                     "global_attention_q8", "one_pass_q8"]
    assert len({k.library_path() for k in KERNELS}) == 9
    # one_pass.py:362-366 at the default-width served shape: 3.42 GFLOP.
    flops = tone.onepass_flops(8, 512, 128, 512, 8, 4, 64)
    assert flops == (2 * 8 * 512 * 128**2 * 19
                     + 2 * 8 * 4 * (512 * 128 * 192 + 8 * 512 * 64
                                    + 512 * 8 * 192))
    assert round(flops / 989e12 * 1e3, 4) == 0.0035
