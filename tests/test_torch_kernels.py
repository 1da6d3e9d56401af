"""The port's kernel modules on the CPU: the plain versions of K1 (local
track) and K2 (global attention) against the JAX package's Pallas kernels
run in interpret mode and against its plain references, on the same
numpy-seeded inputs, at the smallest shapes the JAX guards accept (C=128,
lane-aligned). float32, tolerance 1e-5 (same arithmetic, another summation
order). #2's plain version (K1's, at C=1024) against the JAX channel-tiled
kernel in interpret mode in bfloat16 (0.05, the JAX package's own tiled
tolerance: the XLA and kernel rounding points differ) and against the
JAX reference in float32 (1e-5). #4's plain version (#3's, at C=1024 on
packed rows) the same way against the JAX channel-tiled segment kernel
and the JAX segment references. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.kernels import attention as jattn
from proteinbert_tpu.kernels import fused_block as jfused
from proteinbert_tpu_torch.kernels import attention as tattn
from proteinbert_tpu_torch.kernels import build as tbuild
from proteinbert_tpu_torch.kernels import fused_block as tfused

torch.set_num_threads(1)

TOL = 1e-5
C, G, H, K = 128, 128, 4, 32


def _track_params(rng, C=C):
    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def vec(scale=0.1, base=0.0):
        return (base + scale * rng.standard_normal(C)).astype(np.float32)

    return {"narrow_conv": {"kernel": w((9, C, C), 9 * C), "bias": vec()},
            "wide_conv": {"kernel": w((9, C, C), 9 * C), "bias": vec()},
            "local_ln1": {"scale": vec(base=1.0), "bias": vec()},
            "local_dense": {"kernel": w((C, C), C), "bias": vec()},
            "local_ln2": {"scale": vec(base=1.0), "bias": vec()}}


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


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("L", [64, 256])
def test_local_track_matches_pallas_and_reference(L):
    rng = np.random.default_rng(L)
    p = _track_params(rng)
    x = rng.standard_normal((2, L, C)).astype(np.float32)
    bc = rng.standard_normal((2, C)).astype(np.float32)
    got = tfused.fused_local_track(_torch(p), _torch(x), _torch(bc), 1, 5)
    # JAX kernel in interpret mode, called positionally as
    # tests/test_kernels.py does.
    pallas = jfused.fused_local_track(_jax(p), _jax(x), _jax(bc), 1, 5, True)
    ref = jfused.local_track_reference(_jax(p), _jax(x), _jax(bc), 1, 5)
    _close(pallas, got)
    _close(ref, got)


def test_local_track_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(7)
    p = _torch(_track_params(rng))
    x = _torch(rng.standard_normal((1, 64, C)).astype(np.float32))
    bc = _torch(rng.standard_normal((1, C)).astype(np.float32))
    assert torch.equal(tfused.fused_local_track(p, x, bc),
                       tfused.local_track_reference(p, x, bc))


def test_local_track_bf16_keeps_conv_outputs_unrounded():
    """In bfloat16 the plain version rounds where the TPU kernel rounds:
    x1 and the output only. Rounding the conv outputs too (the XLA
    reference's points) must give a different, not a closer, answer."""
    rng = np.random.default_rng(8)
    p = _track_params(rng)
    x = rng.standard_normal((1, 64, C)).astype(np.float32)
    bc = rng.standard_normal((1, C)).astype(np.float32)
    xb = _torch(x).bfloat16()
    got = tfused.local_track_reference(_torch(p), xb, _torch(bc))
    assert got.dtype == torch.bfloat16
    pallas = jfused.fused_local_track(_jax(p), _jax(x).astype(jnp.bfloat16),
                                      _jax(bc).astype(jnp.bfloat16), 1, 5,
                                      True)
    # Same rounding points as the JAX kernel: agreement within one bf16
    # step of the LayerNorm-scaled output (|y| < 8 → 2^-5).
    np.testing.assert_allclose(np.asarray(pallas.astype(jnp.float32)),
                               got.float().numpy(), atol=2 ** -5)


# ------------------------------------------------------------------ #2

def test_tiled_width_bf16_matches_pallas_tiled_kernel():
    """C=1024 (ProteinBERT-Large), B=1, L=128: the JAX dispatch runs
    `_fused_kernel_tiled` (fused_block.py:881) in interpret mode."""
    rng = np.random.default_rng(40)
    p = _track_params(rng, 1024)
    x = rng.standard_normal((1, 128, 1024)).astype(np.float32)
    bc = rng.standard_normal((1, 1024)).astype(np.float32)
    want = jfused.fused_local_track(_jax(p), _jax(x).astype(jnp.bfloat16),
                                    _jax(bc).astype(jnp.bfloat16), 1, 5,
                                    True)
    got = tfused.fused_local_track(_torch(p), _torch(x).bfloat16(),
                                   _torch(bc).bfloat16(), 1, 5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np.asarray(want.astype(jnp.float32)),
                               got.float().numpy(), rtol=0.05, atol=0.05)


def test_tiled_width_fp32_matches_reference():
    """In float32 (which the JAX package answers through XLA at this
    width) the plain version is the JAX reference to 1e-5."""
    rng = np.random.default_rng(41)
    p = _track_params(rng, 1024)
    x = rng.standard_normal((2, 64, 1024)).astype(np.float32)
    bc = rng.standard_normal((2, 1024)).astype(np.float32)
    want = jfused.local_track_reference(_jax(p), _jax(x), _jax(bc), 1, 5)
    _close(want, tfused.fused_local_track(_torch(p), _torch(x), _torch(bc),
                                          1, 5))


@pytest.mark.parametrize("C,ok", [(512, True), (640, True), (1024, True),
                                  (2048, True), (1088, False),
                                  (2176, False), (96, False)])
def test_local_track_kernel_widths(C, ok):
    """What `fused_local_track` launches on CUDA: K1 at C <= 512, #2 at
    512 < C <= 2048 with C % 128 == 0; anything else raises."""
    p = {name: {k: torch.zeros(1) for k in ("kernel", "bias", "scale")}
         for name in tfused.TRACK_PARAMS}
    for name in ("narrow_conv", "wide_conv"):
        p[name]["kernel"] = torch.zeros((9, C, C))
    widths = tfused.KERNEL_WIDTHS + tfused.TILED_WIDTHS
    x = torch.zeros((1, 8, C), dtype=torch.bfloat16)
    if ok:
        tfused._track_operands("t", p, x, 1, 5, widths)
    else:
        with pytest.raises(ValueError, match=f"C={C}"):
            tfused._track_operands("t", p, x, 1, 5, widths)


# ------------------------------------------------------------------ #4

def _tiled_segments(case):
    """Packed rows at C=1024. "one_row": B=1, L=128, S=4 with a pad gap,
    an id above S (pad by contract), segment 4 empty and a pad tail.
    "tile_edge": B=2, L=256, S=3, a boundary exactly on the TPU kernel's
    128-row tile edge (tests/test_kernels.py:320-344)."""
    if case == "one_row":
        seg = np.zeros((1, 128), np.int32)
        seg[0, :30], seg[0, 33:70], seg[0, 70:80], seg[0, 80:120] = 1, 2, 7, 3
        return seg, 4
    seg = np.zeros((2, 256), np.int32)
    seg[0, :128], seg[0, 128:220] = 1, 2
    seg[1, :100], seg[1, 100:256] = 1, 3
    return seg, 3


@pytest.mark.parametrize("case", ["one_row", "tile_edge"])
def test_tiled_segments_bf16_matches_pallas_tiled_kernel(case):
    """C=1024 packed rows in bfloat16: the JAX dispatch runs
    `_fused_segment_kernel_tiled` (fused_block.py:1220) in interpret mode;
    0.05 is the JAX package's own tolerance for it."""
    seg, S = _tiled_segments(case)
    B, L = seg.shape
    rng = np.random.default_rng(42)
    p = _track_params(rng, 1024)
    x = rng.standard_normal((B, L, 1024)).astype(np.float32)
    bs = rng.standard_normal((B, S, 1024)).astype(np.float32)
    before = jfused.PATH_TOTAL.get(("pallas", "packed"), 0)
    want = jfused.fused_local_track_segments(
        _jax(p), _jax(x).astype(jnp.bfloat16), _jax(bs).astype(jnp.bfloat16),
        jnp.asarray(seg), 1, 5, True)
    assert jfused.PATH_TOTAL[("pallas", "packed")] == before + 1
    got = tfused.fused_local_track_segments(
        _torch(p), _torch(x).bfloat16(), _torch(bs).bfloat16(), _torch(seg),
        1, 5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np.asarray(want.astype(jnp.float32)),
                               got.float().numpy(), rtol=0.05, atol=0.05)


def test_tiled_segments_fp32_matches_reference():
    """In float32 (no tiled plan in the JAX package, which answers through
    XLA) #4's plain version is the JAX reference to 1e-5, in the id form
    (ids 1..S) and the one-hot form (an id above S is pad)."""
    seg, S = _tiled_segments("one_row")
    rng = np.random.default_rng(43)
    p = _track_params(rng, 1024)
    x = rng.standard_normal((1, 128, 1024)).astype(np.float32)
    bs = rng.standard_normal((1, S, 1024)).astype(np.float32)
    got = tfused.fused_local_track_segments(_torch(p), _torch(x), _torch(bs),
                                            _torch(seg), 1, 5)
    oh = (seg[..., None] == np.arange(1, S + 1)).astype(np.float32)
    _close(jfused.local_track_segment_oh_reference(
        _jax(p), _jax(x), _jax(bs), _jax(oh), 1, 5), got)
    seg_in = np.where(seg > S, 0, seg)
    got_ids = tfused.fused_local_track_segments(
        _torch(p), _torch(x), _torch(bs), _torch(seg_in), 1, 5)
    _close(jfused.local_track_segment_reference(
        _jax(p), _jax(x), jfused.gather_segment_broadcast(_jax(bs),
                                                          _jax(seg_in)),
        _jax(seg_in), 1, 5), got_ids)


@pytest.mark.parametrize("C,kernel", [
    (512, "local_track_segments"), (640, "local_track_segments_tiled"),
    (1024, "local_track_segments_tiled"), (2048, "local_track_segments_tiled"),
    (1088, None), (2176, None), (96, None)])
def test_segment_track_kernel_widths(C, kernel, monkeypatch):
    """What `fused_local_track_segments` launches on CUDA: #3 at C <= 512,
    #4 (with its float32 (B, L, C) scratch) at 512 < C <= 2048 with
    C % 128 == 0; anything else raises before any launch. Meta tensors
    stand in for the card's, and the launches are recorded, not run."""
    calls = []
    kernels = {k.name: k for k in (tfused.LOCAL_TRACK_SEGMENTS,
                                   tfused.LOCAL_TRACK_SEGMENTS_TILED)}
    for k in kernels.values():
        monkeypatch.setattr(k, "launch", lambda *a, k=k: calls.append(
            (k.name, len(a))))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tfused, "stream_ptr", lambda d: 0)

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)

    p = {name: {k: meta(C) for k in ("bias", "scale")}
         for name in tfused.TRACK_PARAMS}
    for name in ("narrow_conv", "wide_conv"):
        p[name]["kernel"] = meta(9, C, C)
    p["local_dense"]["kernel"] = meta(C, C)
    B, L, S = 2, 8, 3
    args = (p, meta(B, L, C, dtype=torch.bfloat16), meta(B, S, C),
            meta(B, L, dtype=torch.int32), 1, 5)
    if kernel is None:
        with pytest.raises(ValueError, match=f"C={C}"):
            tfused._segments_kernel(*args)
        assert calls == []
    else:
        out = tfused._segments_kernel(*args)
        assert out.shape == (B, L, C) and out.dtype == torch.bfloat16
        # One launch, with the arguments its C signature declares.
        assert calls == [(kernel, len(kernels[kernel].argtypes))]


@pytest.mark.parametrize("case,ok", [
    ("fresh", True), ("aligned view", True), ("offset view", False),
    ("odd row stride", False)])
def test_check_tma(case, ok):
    """TMA reads the bf16 tiled operands: a base address not 16-byte
    aligned, or a row stride that is not a multiple of 16 bytes, raises
    ValueError; CPU tensors, since the check reads only addresses and
    strides."""
    n = 4 * 64 * 128
    flat = torch.zeros(n + 64, dtype=torch.bfloat16)
    wide = torch.zeros((4, 64, 132), dtype=torch.bfloat16)  # 264-byte rows
    t = {"fresh": torch.zeros((4, 64, 128), dtype=torch.bfloat16),
         "aligned view": flat[8:8 + n].view(4, 64, 128),
         "offset view": flat[1:1 + n].view(4, 64, 128),
         "odd row stride": wide[..., :128]}[case]
    if ok:
        tbuild.check_tma("t", t)
    else:
        with pytest.raises(ValueError, match="TMA"):
            tbuild.check_tma("t", t)


@pytest.mark.parametrize("entry", ["dense", "prehaloed", "segments"])
def test_tiled_launchers_refuse_what_tma_cannot_read(entry, monkeypatch):
    """#2, its prehaloed entry and #4 in bf16 raise ValueError, before any
    launch, for an x whose base is not 16-byte aligned; the same call on
    an aligned x launches once. Meta tensors stand in for the card's."""
    calls = []
    for k in (tfused.LOCAL_TRACK_TILED, tfused.LOCAL_TRACK_TILED_VALID,
              tfused.LOCAL_TRACK_SEGMENTS_TILED):
        monkeypatch.setattr(k, "launch", lambda *a, k=k: calls.append(k.name))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tfused, "stream_ptr", lambda d: 0)

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)

    C, B, L, S = 1024, 2, 48, 3
    p = {name: {k: meta(C) for k in ("bias", "scale")}
         for name in tfused.TRACK_PARAMS}
    for name in ("narrow_conv", "wide_conv"):
        p[name]["kernel"] = meta(9, C, C)
    p["local_dense"]["kernel"] = meta(C, C)
    rows = L + (2 * tfused.track_halo(p, 1, 5) if entry == "prehaloed" else 0)
    n = B * rows * C
    flat = meta(n + 8, dtype=torch.bfloat16)

    def run(x):
        if entry == "segments":
            return tfused._segments_kernel(p, x, meta(B, S, C),
                                           meta(B, L, dtype=torch.int32), 1, 5)
        if entry == "prehaloed":
            return tfused._local_track_valid_kernel(p, x, meta(B, C), 1, 5)
        return tfused._local_track_kernel(p, x, meta(B, C), 1, 5)

    with pytest.raises(ValueError, match="16-byte aligned"):
        run(flat[1:n + 1].view(B, rows, C))
    assert calls == []
    assert run(flat[8:n + 8].view(B, rows, C)).shape == (B, L, C)
    assert len(calls) == 1


# --------------------------------- K1, its prehaloed entry, #3 in bf16

@pytest.fixture
def track_launches(monkeypatch):
    """The local-track launches recorded (name, arguments), not run; meta
    tensors stand in for the card's."""
    calls = []
    for k in (tfused.LOCAL_TRACK, tfused.LOCAL_TRACK_VALID,
              tfused.LOCAL_TRACK_SEGMENTS, tfused.LOCAL_TRACK_TILED,
              tfused.LOCAL_TRACK_TILED_VALID,
              tfused.LOCAL_TRACK_SEGMENTS_TILED):
        monkeypatch.setattr(k, "launch", lambda *a, k=k: calls.append(
            (k.name, a)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tfused, "stream_ptr", lambda d: 0)
    return calls


def _meta_track(C, dtype=torch.float32):
    p = {name: {k: _meta(C, dtype=torch.float32) for k in ("bias", "scale")}
         for name in tfused.TRACK_PARAMS}
    for name in ("narrow_conv", "wide_conv"):
        p[name]["kernel"] = _meta(9, C, C, dtype=dtype)
    p["local_dense"]["kernel"] = _meta(C, C, dtype=dtype)
    return p


def _base_call(entry, p, x, B, L, S=3):
    """One launch of K1 ("dense"), its prehaloed entry or #3 at x's
    width."""
    C = x.shape[-1]
    if entry == "segments":
        return tfused._segments_kernel(p, x, _meta(B, S, C, dtype=x.dtype),
                                       _meta(B, L, dtype=torch.int32), 1, 5)
    if entry == "prehaloed":
        return tfused._local_track_valid_kernel(
            p, x, _meta(B, C, dtype=x.dtype), 1, 5)
    return tfused._local_track_kernel(p, x, _meta(B, C, dtype=x.dtype), 1, 5)


_BASE_KERNELS = {"dense": tfused.LOCAL_TRACK,
                 "prehaloed": tfused.LOCAL_TRACK_VALID,
                 "segments": tfused.LOCAL_TRACK_SEGMENTS}


@pytest.mark.parametrize("operand", ["x", "narrow_conv", "wide_conv",
                                     "local_dense"])
@pytest.mark.parametrize("entry", ["dense", "prehaloed", "segments"])
def test_base_width_launchers_refuse_what_tma_cannot_read(entry, operand,
                                                          track_launches):
    """K1, its prehaloed entry and #3 in bf16 at C=512 (the wgmma + TMA
    passes) raise ValueError, before any launch, for an x, narrow or wide
    conv kernel (the conv pass reads them by TMA) or dense kernel (the
    finish pass does) whose base is not 16-byte aligned; the same call on
    aligned operands launches once, with the arguments its C signature
    declares."""
    C, B, L = 512, 2, 48
    p = _meta_track(C, torch.bfloat16)
    rows = L + (2 * tfused.track_halo(p, 1, 5) if entry == "prehaloed" else 0)
    x = _meta(B, rows, C)
    target = x if operand == "x" else p[operand]["kernel"]
    n = target.numel()
    flat = _meta(n + 8)

    def call(t):
        if operand == "x":
            return _base_call(entry, p, t, B, L)
        q = {**p, operand: {**p[operand], "kernel": t}}
        return _base_call(entry, q, x, B, L)

    with pytest.raises(ValueError, match="16-byte aligned"):
        call(flat[1:n + 1].view(target.shape))
    assert track_launches == []
    out = call(flat[8:n + 8].view(target.shape))
    assert out.shape == (B, L, C) and out.dtype == torch.bfloat16
    kernel = _BASE_KERNELS[entry]
    assert [(name, len(a)) for name, a in track_launches] == [
        (kernel.name, len(kernel.argtypes))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("entry", ["dense", "prehaloed", "segments"])
def test_base_width_scratches_have_the_c_entry_shapes(entry, dtype,
                                                      track_launches):
    """In bf16 K1, its prehaloed entry and #3 pass the float32 (B, L, C)
    scratch where their two passes meet — the one part of
    `track_scratch_layout` off the int8 leg — just before out, the
    position csrc/local_track{,_valid,_segments}.cu take it at; float32
    (one CUDA-core launch) passes none."""
    C, B, L = 256, 2, 40
    p = _meta_track(C, dtype)
    rows = L + (2 * tfused.track_halo(p, 1, 5) if entry == "prehaloed" else 0)
    layout, nbytes = tfused.track_scratch_layout(B, L, C, False, 9, 9)
    assert layout == (((B, L, C), torch.float32, 0),)
    assert nbytes >= B * L * C * 4 and nbytes % 256 == 0
    out = _base_call(entry, p, _meta(B, rows, C, dtype=dtype), B, L)
    assert out.shape == (B, L, C) and out.dtype == dtype
    ((name, a),) = track_launches
    kernel = _BASE_KERNELS[entry]
    assert name == kernel.name and len(a) == len(kernel.argtypes)
    # ..., b2, h, out, then B, L, C, [S,] the narrow and wide taps and
    # dilations, and the stream
    h = a[-11] if entry == "segments" else a[-10]
    assert (h is None) == (dtype == torch.float32)
    assert a[0] == tfused.KERNEL_DTYPES[dtype]


# ------------------------------------------------------------------ K2

def _attn_inputs(rng, L, S):
    local = rng.standard_normal((3, L, C)).astype(np.float32)
    glob = rng.standard_normal((3, S, G)).astype(np.float32)
    return local, glob


@pytest.mark.parametrize("L", [64, 256])
def test_dense_attention_matches_pallas(L):
    rng = np.random.default_rng(10 + L)
    p = _attn_params(rng)
    local, glob = _attn_inputs(rng, L, 1)
    glob = glob[:, 0]
    mask = np.ones((3, L), bool)
    mask[1, L // 2:] = False   # half-padded row
    mask[2] = False            # all-pad row: uniform softmax, not NaN
    before = jattn.ATTN_PATH_TOTAL.get(("pallas", "dense"), 0)
    want = jattn.fused_global_attention(_jax(p), _jax(local), _jax(glob),
                                        jnp.asarray(mask), interpret=True)
    assert jattn.ATTN_PATH_TOTAL[("pallas", "dense")] == before + 1
    got = tattn.fused_global_attention(_torch(p), _torch(local),
                                       _torch(glob), _torch(mask))
    assert torch.isfinite(got).all()
    _close(want, got)
    ref = jattn.attention_oh_reference(
        _jax(p), _jax(local), _jax(glob)[:, None, :],
        jnp.asarray(mask[..., None], jnp.float32), zero_empty=False)
    _close(ref.reshape(3, G), got)


@pytest.mark.parametrize("L", [64, 256])
def test_packed_attention_zero_empty_segment(L):
    rng = np.random.default_rng(20 + L)
    p = _attn_params(rng)
    S = 3
    local, glob = _attn_inputs(rng, L, S)
    seg = rng.integers(0, 3, (3, L)).astype(np.int32)  # segment 3 empty
    seg[2] = 0                                          # an all-pad row
    real = rng.random((3, L)) < 0.9
    before = jattn.ATTN_PATH_TOTAL.get(("pallas", "packed"), 0)
    want = jattn.fused_packed_attention(_jax(p), _jax(local), _jax(glob),
                                        jnp.asarray(seg), jnp.asarray(real),
                                        interpret=True)
    assert jattn.ATTN_PATH_TOTAL[("pallas", "packed")] == before + 1
    got = tattn.fused_packed_attention(_torch(p), _torch(local),
                                       _torch(glob), _torch(seg),
                                       _torch(real))
    _close(want, got)
    # Empty segments are exactly +0.0, as the TPU kernel zeroes them.
    assert (got[:, S - 1] == 0).all() and (got[2] == 0).all()
    assert not torch.signbit(got[:, S - 1]).any()
    oh = ((seg[..., None] == np.arange(1, S + 1)) & real[..., None])
    ref = jattn.attention_oh_reference(_jax(p), _jax(local), _jax(glob),
                                       jnp.asarray(oh, jnp.float32))
    _close(ref, got)


@pytest.mark.parametrize("G,H,v,k,S,ok", [
    (512, 8, 64, 64, 1, True),      # base width
    (512, 4, 128, 64, 1, True),     # value_dim 128 (fp32 C=256, L=512)
    (1024, 16, 64, 64, 1, True),    # Large
    (512, 4, 128, 64, 16, True),
    (384, 4, 96, 64, 1, True),      # value_dim 96
    (512, 8, 64, 32, 1, True),      # key_dim 32
    (512, 8, 64, 12, 1, False),     # key_dim 12: not a multiple of 8
    (512, 2, 256, 64, 1, True),     # value_dim 256
    (512, 1, 512, 64, 1, False),    # value_dim 512
    (512, 8, 64, 64, 17, True),     # past 16 segments: any S
    (512, 8, 64, 64, 65535, True),  # a grid's z extent
    (512, 8, 64, 64, 65536, False),  # too many segments
])
def test_attention_kernel_shape_checks(G, H, v, k, S, ok):
    C, L = 256, 512

    def z(*shape):  # shapes only: no storage at S = 65536
        return torch.empty(shape, device="meta")
    params = {"wq": z(H, G, k), "wk": z(H, C, k), "wv": z(H, C, v)}
    args = (params, z(2, L, C), z(2, S, G), z(2, L, S))
    if ok:
        tattn.check_attention_shapes(*args)
    else:
        with pytest.raises(ValueError, match="fused_attention"):
            tattn.check_attention_shapes(*args)


# ---------------------------------------- K2's launch on the card, recorded

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.fixture
def k2_launches(monkeypatch):
    """K2's launches recorded (name, arguments), not run; meta tensors
    stand in for the card's."""
    calls = []
    for k in (tattn.ATTENTION, tattn.ATTENTION_Q8):
        monkeypatch.setattr(k, "launch", lambda *a, k=k: calls.append(
            (k.name, a)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tattn, "stream_ptr", lambda d: 0)
    return calls


def _k2_case(entry, v=64):
    """(params, x, g, ids, zero_empty) of one K2 launch at C=256, as the
    dense entry (S=1, zero_empty off) or the packed entry (S=8) makes it."""
    B, L, C, H = 2, 48, 256, 4
    S = 1 if entry == "dense" else 8
    params = {"wq": _meta(H, H * v, 64), "wk": _meta(H, C, 64),
              "wv": _meta(H, C, v)}
    return (params, _meta(B, L, C), _meta(B, S, H * v),
            _meta(B, L, dtype=torch.int32), entry != "dense")


@pytest.mark.parametrize("operand", ["x", "wq", "wk", "wv"])
@pytest.mark.parametrize("entry", ["dense", "packed"])
def test_attention_refuses_what_tma_cannot_read(entry, operand, k2_launches):
    """K2 in bf16 raises ValueError, before any launch, for an x, wk or wv
    whose base is not 16-byte aligned (its projection pass reads them by
    TMA), or such a wq (its query pass reads it in 16-byte loads); the
    same call on aligned operands launches once."""
    params, x, g, mask, zero_empty = _k2_case(entry)
    target = x if operand == "x" else params[operand]
    n = target.numel()
    flat = _meta(n + 8)
    bad = flat[1:n + 1].view(target.shape)
    if operand == "x":
        args = (params, bad, g, mask, zero_empty)
    else:
        args = ({**params, operand: bad}, x, g, mask, zero_empty)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn._attention_launch(*args)
    assert k2_launches == []
    good = flat[8:n + 8].view(target.shape)
    if operand == "x":
        args = (params, good, g, mask, zero_empty)
    else:
        args = ({**params, operand: good}, x, g, mask, zero_empty)
    out = tattn._attention_launch(*args)
    assert out.shape == g.shape and out.dtype == torch.bfloat16
    assert [(n, len(a)) for n, a in k2_launches] == [
        ("global_attention", len(tattn.ATTENTION.argtypes))]


@pytest.mark.parametrize("v", [64, 128])
@pytest.mark.parametrize("entry", ["dense", "packed"])
def test_attention_scratches_have_the_c_entry_shapes(entry, v, k2_launches):
    """One bf16 launch carves q (B, S, H, 64) and scores (B, H, L), one a
    position, in float32 and V (B, L, H·v) in bf16, the shapes and order
    csrc/global_attention.cu documents, from one buffer (256-byte aligned
    parts that do not overlap) and passes the parts' addresses; float32
    passes q alone."""
    params, x, g, mask, zero_empty = _k2_case(entry, v)
    (B, L, C), (_, S, G), H = x.shape, g.shape, params["wq"].shape[0]
    layout, nbytes = tattn.attention_scratch_layout(B, L, C, S, H, v, False,
                                                    64, torch.bfloat16)
    assert [(shape, dtype) for shape, dtype, _ in layout] == [
        ((B, S, H, 64), torch.float32), ((B, H, L), torch.float32),
        ((B, L, G), torch.bfloat16)]
    ends = [off + np.prod(shape) * dtype.itemsize
            for shape, dtype, off in layout]
    offsets = [off for _, _, off in layout]
    assert all(off % 256 == 0 for off in offsets)
    assert offsets[0] == 0 and ends[:-1] <= offsets[1:] and ends[-1] <= nbytes
    tattn._attention_launch(params, x, g, mask, zero_empty)
    f32 = {n: t.float() for n, t in params.items()}
    tattn._attention_launch(f32, x.float(), g.float(), mask, zero_empty)
    (name, bf), (_, fp) = k2_launches
    assert name == "global_attention"
    assert len(bf) == len(fp) == len(tattn.ATTENTION.argtypes)
    ptrs = bf[7:10]   # dtype, x, ids, g, wq, wk, wv, then the scratches
    assert [p - ptrs[0] for p in ptrs] == offsets
    assert fp[7] is not None and fp[8:10] == (None, None)
    assert tattn.attention_scratch_layout(
        B, L, C, S, H, v, False, 64, torch.float32)[0] == (
        ((B, S, H, 64), torch.float32, 0),)


@pytest.mark.parametrize("real", [False, True])
def test_one_hot_and_segment_ids_round_trip(real):
    """The kernel's (B, L) segment ids and the plain versions' one-hot
    name the same positions: `one_hot_ids` of `segment_one_hot` is the ids
    with pad, ids outside 1..S and masked-out positions at 0, and
    `ids_one_hot` of those ids is the one-hot again."""
    rng = np.random.default_rng(7)
    S = 5
    seg = torch.from_numpy(rng.integers(0, S + 3, (3, 40)).astype(np.int32))
    mask = torch.from_numpy(rng.random((3, 40)) < 0.8) if real else None
    oh = tattn.segment_one_hot(seg, S, mask)
    ids = tattn.one_hot_ids(oh)
    keep = (seg >= 1) & (seg <= S)
    if real:
        keep &= mask
    assert ids.dtype == torch.int32
    assert torch.equal(ids, torch.where(keep, seg, 0))
    assert torch.equal(tattn.ids_one_hot(ids, S), oh)


# ------------------------------------------- launch or raise, never fall back

def test_wrappers_raise_on_devices_they_do_not_run_on():
    rng = np.random.default_rng(30)
    p = _torch(_track_params(rng))
    x = torch.empty((1, 64, C), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.fused_local_track(p, x, torch.empty((1, C), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.fused_attention(_torch(_attn_params(rng)), x,
                              torch.empty((1, 1, G), device="meta"),
                              torch.empty((1, 64, 1), device="meta"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc → building raises; nothing falls back to the plain path."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    kernel = tbuild.Kernel("local_track", "local_track.cu",
                           "pbt_local_track", [])
    with pytest.raises(RuntimeError, match="nvcc"):
        tbuild.build_all([kernel])
    assert kernel.launches == 0


def test_library_name_tracks_the_sources():
    lib = tfused.LOCAL_TRACK.library_path()
    assert lib.parent == tbuild.BUILD_DIR
    assert lib.name.startswith("pbt_local_track_") and lib.suffix == ".so"
    assert lib != tattn.ATTENTION.library_path()


def test_flop_counts_are_the_tpu_kernels():
    # fused_block.py:779 and attention.py:308 at the base serving shape.
    assert tfused.local_track_flops(8, 512, 512) == 2 * 8 * 512 * 512**2 * 19
    assert tattn.attention_flops(8, 512, 512, 512, 1, 8, 64) == (
        2 * 8 * 8 * (512 * 512 * 128 + 512 * 64 + 512 * 128))
