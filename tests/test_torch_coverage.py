"""Every model shape the JAX package runs, in the port: the JAX kernel
gates copied into `kernels/budget.py` (each equal to JAX's on a grid of
shapes), the route each block takes (`track_route`, `attention_route`,
`onepass_route`: a kernel where one covers the shape, the reference
route where the JAX gate refuses it and none does, ValueError where the
gate accepts it and none does), the route counters under JAX's names
against JAX's under `use_pallas=True`, the `tiny` preset (its local
track on the reference route, its attention on K2) against JAX's forward
and train step, the plain attention at the head widths the kernels
gained, a `tiny` Server's route coverage in `stats()` and its registry,
the `remat_policy` refusal, `graph-purity`'s route guard, and the
kernels' coverage constants against the CUDA headers.

CPU only, small shapes, one torch thread."""

import dataclasses
import pathlib
import re
import textwrap

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
from proteinbert_tpu.ops import attention as jops
from proteinbert_tpu_torch import kernels as tk
from proteinbert_tpu_torch.analysis import CheckConfig, run_check
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.kernels import attention as tattn
from proteinbert_tpu_torch.kernels import budget
from proteinbert_tpu_torch.kernels import fused_block as tfused
from proteinbert_tpu_torch.kernels import one_pass as tone
from proteinbert_tpu_torch.kernels.path_counter import quiet
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.parallel.seq_parallel import seq_parallel_apply
from proteinbert_tpu_torch.serve.server import Server
from proteinbert_tpu_torch.train import train_state as tts
from proteinbert_tpu_torch.weights import params_from_flat, params_to_flat
from tests.test_torch_train import (
    _corrupted, _jax_value_and_grad, _jx, _tree_like, _tx,
)

torch.set_num_threads(1)

WIDTHS = (32, 64, 128, 200, 256, 384, 512, 640, 1024, 2048, 2176)
LENGTHS = (4, 8, 128, 512, 2048)
SEGMENTS = (1, 8, 16, 32, 64, 256, 512)
DTYPES = (("bfloat16", torch.bfloat16), ("float32", torch.float32))
TAPS = ((7, 7), (9, 9), (11, 11), (9, 7), (5, 5), (13, 13), (8, 8))
DILATIONS = tuple(range(1, 8)) + (12, 40)
KEY_DIMS = (16, 32, 48, 64, 128)
HEADS = ((256, 4), (512, 8), (512, 2), (512, 16), (1024, 4))  # (G, H)

# What the port's kernels cover, written out apart from the code under
# test: the local track at C in {128, 256, 384, 512} (K1, #3) and 640 ...
# 2048 in steps of 128 (#2, #4), odd taps (equal ones at 640 ... 2048),
# dilations >= 1 reaching at most 2^20 rows;
# K2 at C a multiple of 32 up to 2048, head widths multiples of 8 (key
# <= 128, value <= 256), any S up to 65535, float32 one score a position
# in shared memory; #6 at the local track's convs, C in {128, 256, 384,
# 512} (float32 up to 384).
TRACK_WIDTHS = (128, 256, 384, 512) + tuple(range(640, 2049, 128))
ONEPASS_WIDTHS = {"bfloat16": (128, 256, 384, 512),
                  "float32": (128, 256, 384)}


def _a128(n):
    return -(-n // 128) * 128


def _f32_attn_smem(L):
    # The projection region, a bit for each of 65535 segments, (L,) scores.
    return 49152 + 8192 + _a128(L * 4)


def _f32_track_smem(C, seg):
    # The tile's own 16 rows, h, the weight tiles and a double-buffered
    # (16, 16) A tile; no halo rows, whatever the taps.
    return (_a128(16 * C * 4) + _a128(16 * C * 4) + _a128(2 * 16 * C * 4)
            + _a128(2 * 16 * 16 * 4) + (_a128(16 * 4) if seg else 0))


def _track_covered(C, nt, wt, nd, wd, widths=TRACK_WIDTHS):
    return (C in widths and nt % 2 == 1 and wt % 2 == 1 and nd >= 1
            and wd >= 1 and max((nt - 1) // 2 * nd, (wt - 1) // 2 * wd)
            <= 2 ** 20 and (C <= 512 or nt == wt))


def _heads_covered(k, G, H):
    v = G // H
    return (G % H == 0 and k % 8 == 0 and 8 <= k <= 128 and v % 8 == 0
            and 8 <= v <= 256)


def _attn_covered(C, G, L, S, k, H, name):
    return (C % 32 == 0 and 32 <= C <= 2048 and _heads_covered(k, G, H)
            and 1 <= S <= 65535
            and (name == "bfloat16" or _f32_attn_smem(L) <= 232448))


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return "ValueError"


# ------------------------------------------------------------- the gates

def test_gates_equal_jax_on_the_grid():
    """`budget.pallas_supported`, `pallas_segments_supported`,
    `pallas_attention_supported` and `onepass_supported` answer as the
    JAX gates do on every shape of the grid (and both routes occur)."""
    n, seen = 0, set()
    for C in WIDTHS:
        for L in LENGTHS:
            for name, dt in DTYPES:
                for nt, wt in TAPS:
                    for wd in DILATIONS:
                        want = jfused.pallas_supported(C, L, name, nt, wt,
                                                       wd)
                        assert budget.pallas_supported(
                            C, L, dt, nt, wt, wd) == want, (C, L, name, wd)
                        seen.add(("track", want))
                        n += 1
                        for S in SEGMENTS:
                            for nd in (1, 2):
                                want = jfused.pallas_segments_supported(
                                    C, L, S, name, nt, wt, wd, nd)
                                assert budget.pallas_segments_supported(
                                    C, L, S, dt, nt, wt, wd, nd) == want
                                seen.add(("segments", want))
                                n += 1
                for S in SEGMENTS:
                    for k in KEY_DIMS:
                        for G, H in HEADS:
                            want = jattn.pallas_attention_supported(
                                C, G, L, S, k, H, name)
                            assert budget.pallas_attention_supported(
                                C, G, L, S, k, H, dt) == want
                            seen.add(("attention", want))
                            want = jone.pallas_onepass_supported(
                                C, G, L, S, k, H, name)
                            assert budget.onepass_supported(
                                C, G, L, S, k, H, dt) == want
                            seen.add(("onepass", want))
                            n += 2
    assert n >= 200
    assert seen == {(g, b) for g in ("track", "segments", "attention",
                                     "onepass") for b in (True, False)}


# ------------------------------------------------------------- the routes

def test_track_route_on_the_grid():
    """The local track's route, dense and packed: the kernel where K1 /
    #2 (#3 / #4) cover the shape; the reference route exactly where the
    JAX gate refuses it and no kernel covers it; ValueError exactly where
    the gate accepts it and no kernel covers it (even taps on the dense
    route, where JAX's kernel fails too)."""
    counts = {}
    for C in WIDTHS:
        for L in LENGTHS:
            for name, dt in DTYPES:
                for nt, wt in TAPS:
                    for wd in DILATIONS:
                        for S in (None,) + SEGMENTS:
                            for nd in (1, 2):
                                if S is None:
                                    gate = jfused.pallas_supported(
                                        C, L, name, nt, wt, wd)
                                else:
                                    gate = jfused.pallas_segments_supported(
                                        C, L, S, name, nt, wt, wd, nd)
                                covered = _track_covered(C, nt, wt, nd, wd)
                                got = _outcome(tfused.track_route, C, L, dt,
                                               nt, wt, nd, wd, S)
                                if covered:
                                    want = ("pallas", "dense" if S is None
                                            else "packed")
                                elif gate:
                                    want = "ValueError"
                                else:
                                    want = ("reference",
                                            "unsupported_shape" if S is None
                                            else "segments")
                                assert got == want, (C, L, name, nt, wt, nd,
                                                     wd, S)
                                key = want if isinstance(want, str) \
                                    else want[0]
                                counts[key] = counts.get(key, 0) + 1
    assert set(counts) == {"pallas", "reference", "ValueError"}, counts


def test_attention_route_on_the_grid():
    """K2's route, dense (S=1) and packed: the kernel where it covers the
    shape, the reference route exactly where the JAX gate refuses and it
    does not cover, ValueError exactly where the gate accepts and it does
    not (key_dim 12, not a multiple of 8); every S the gate admits at a
    covered width, 32 to 512 too, goes to the kernel."""
    counts = {}
    for C in WIDTHS:
        for L in LENGTHS:
            for name, dt in DTYPES:
                for S in SEGMENTS:
                    for k in KEY_DIMS + (12,):
                        for G, H in HEADS + ((480, 5), (2048, 4)):
                            for packed in (False, True):
                                if not packed and S != 1:
                                    continue
                                v = G // H
                                gate = jattn.pallas_attention_supported(
                                    C, G, L, S, k, H, name)
                                covered = _attn_covered(C, G, L, S, k, H,
                                                        name)
                                got = _outcome(tattn.attention_route, C, G,
                                               L, S, k, H, v, dt, packed)
                                if covered:
                                    want = ("pallas", "packed" if packed
                                            else "dense")
                                elif gate:
                                    want = "ValueError"
                                else:
                                    want = ("reference", "segments" if packed
                                            else "unsupported_shape")
                                assert got == want, (C, G, L, S, k, H, name)
                                key = want if isinstance(want, str) \
                                    else want[0]
                                counts[key] = counts.get(key, 0) + 1
                                if gate and covered and S > 16:
                                    counts["gate, S > 16"] = counts.get(
                                        "gate, S > 16", 0) + 1
    assert set(counts) == {"pallas", "reference", "ValueError",
                           "gate, S > 16"}, counts


def test_onepass_route_on_the_grid():
    """#6's route: #6 where the JAX rule admits the shape and #6 covers
    it (any S the rule admits, 32 to 512 too; any odd taps and wide
    dilation), ValueError where the rule admits it and #6 does not (a
    key_dim of 136, past K2's 128), the composition ("reference")
    wherever the rule refuses (even taps among them)."""
    counts = {}
    for C in WIDTHS:
        for L in LENGTHS:
            for name, dt in DTYPES:
                for S in SEGMENTS:
                    for k in (16, 48, 128, 136):
                        for G, H in HEADS:
                            for nt, wt in TAPS:
                                for wd in (1, 5, 6):
                                    packed = S > 1
                                    gate = jone.pallas_onepass_supported(
                                        C, G, L, S, k, H, name, nt, wt, wd,
                                        1)
                                    covered = (
                                        _track_covered(
                                            C, nt, wt, 1, wd,
                                            ONEPASS_WIDTHS[name])
                                        and _heads_covered(k, G, H)
                                        and S <= 65535
                                        and (name == "bfloat16" or max(
                                            _f32_track_smem(C, packed),
                                            _f32_attn_smem(L))
                                            <= 232448))
                                    got = _outcome(
                                        tone.onepass_route, C, G, L, S, k,
                                        H, G // H, dt, nt, wt, 1, wd, packed)
                                    tag = "packed" if packed else "dense"
                                    if not gate:
                                        want = ("reference", "segments"
                                                if packed
                                                else "unsupported_shape")
                                    elif covered:
                                        want = ("pallas", tag)
                                    else:
                                        want = "ValueError"
                                    assert got == want, (C, G, L, S, k, H,
                                                         name, nt, wd)
                                    key = want if isinstance(want, str) \
                                        else want[0]
                                    counts[key] = counts.get(key, 0) + 1
                                    if gate and covered and S > 16:
                                        counts["gate, S > 16"] = counts.get(
                                            "gate, S > 16", 0) + 1
    assert set(counts) == {"pallas", "reference", "ValueError",
                           "gate, S > 16"}, counts


# ------------------------------------------------- counters against JAX

SMALL = dict(local_dim=128, global_dim=256, key_dim=32, num_heads=4)
C384 = dict(local_dim=384, global_dim=512, key_dim=64, num_heads=8)


def _snapshot(counters):
    return [dict(c) for c in counters]


def _delta(before, counters):
    return [{k: n - b.get(k, 0) for k, n in dict(c).items()
             if n != b.get(k, 0)} for b, c in zip(before, counters)]


JAX_COUNTERS = (jfused.PATH_TOTAL, jattn.ATTN_PATH_TOTAL,
                jone.ONEPASS_PATH_TOTAL)
PORT_COUNTERS = (tk.PATH_TOTAL, tk.ATTN_PATH_TOTAL, tk.ONEPASS_PATH_TOTAL)


@pytest.mark.parametrize("case,model,dtype,L,k2_only", [
    ("tiny", {}, "float32", 128, True),
    ("small", SMALL, "bfloat16", 128, False),
    ("c384 one-pass", C384, "bfloat16", 256, False),
    ("c384 composition", C384, "bfloat16", 512, False),
])
def test_route_counters_equal_jax(case, model, dtype, L, k2_only):
    """Per family, the (path, reason) deltas of one 2-block forward equal
    the JAX model's under `use_pallas=True` (traced, not run): one
    decision a family per forward, as JAX's scanned block body traces
    once. `k2_only`: K2 covers an attention JAX's gate sends to XLA (the
    `tiny` preset's C=32), so there, and only there, the port counts
    pallas/dense where JAX counts reference/unsupported_shape."""
    jcfg = jax_preset("tiny").model
    jm = dataclasses.replace(jcfg, use_pallas=True, dtype=dtype, **model)
    tm = dataclasses.replace(get_preset("tiny").model, dtype=dtype, **model)
    rng = np.random.default_rng(5)
    tokens = rng.integers(4, 26, (1, L)).astype(np.int32)
    tokens[0, 0] = 1
    ann = np.zeros((1, jm.num_annotations), np.float32)
    jparams = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jm))
    before = _snapshot(JAX_COUNTERS)
    jax.eval_shape(lambda p: jmodel.apply(p, jnp.asarray(tokens),
                                          jnp.asarray(ann), jm), jparams)
    want = _delta(before, JAX_COUNTERS)
    params = tmodel.init(tm, torch.Generator().manual_seed(0), device="cpu")
    before = _snapshot(PORT_COUNTERS)
    with torch.inference_mode():
        tmodel.apply(params, torch.from_numpy(tokens),
                     torch.from_numpy(ann), tm)
    got = _delta(before, PORT_COUNTERS)
    if k2_only:
        assert set(want[1]) == {("reference", "unsupported_shape")}
        want[1] = {("pallas", "dense"): want[1][("reference",
                                                 "unsupported_shape")]}
    assert got == want
    assert any(got)


# ------------------------------------------- the tiny preset against JAX

@pytest.fixture(scope="module")
def tiny_params():
    jcfg, tcfg = jax_preset("tiny"), get_preset("tiny")
    jparams = jmodel.init(jax.random.PRNGKey(8), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_tiny_forward_matches_jax(tiny_params):
    """The `tiny` preset (C=32: the local track on the reference route,
    the attention on K2's plain version) in float32: the port's logits
    against the JAX model's."""
    jcfg, tcfg, jparams, tparams = tiny_params
    rng = np.random.default_rng(9)
    tokens = rng.integers(4, 26, (2, 64)).astype(np.int32)
    tokens[:, 0], tokens[1, 40], tokens[1, 41:] = 1, 2, 0
    ann = (rng.random((2, jcfg.model.num_annotations)) < 0.02).astype(
        np.float32)
    jl, jg = jmodel.apply(jparams, jnp.asarray(tokens), jnp.asarray(ann),
                          jcfg.model)
    with torch.inference_mode():
        tl, tg = tmodel.apply(tparams, torch.from_numpy(tokens),
                              torch.from_numpy(ann), tcfg.model)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)


def test_tiny_train_step_matches_jax(tiny_params):
    """One float32 `tiny` train step: the loss and every gradient against
    JAX's, with test_torch_train's tolerance (loss 1e-5, grads 1e-4)."""
    jcfg, tcfg, jparams, tparams = tiny_params
    X, Y, W = _corrupted(np.random.default_rng(10), 2, 64,
                         jcfg.model.num_annotations)
    (jl, _), jg = _jax_value_and_grad(jparams, _jx(X), _jx(Y), _jx(W), jcfg)
    tg, tm = tts.loss_and_grads(tparams, _tx(X), _tx(Y), _tx(W), tcfg)
    assert abs(float(jl) - float(tm["loss"])) <= 1e-5
    want = flatten_params(jg)
    got = params_to_flat(_tree_like(tparams, tg))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ------------------------------------ the plain attention at new widths

@pytest.mark.parametrize("k", [16, 32, 128])
@pytest.mark.parametrize("v", [32, 256])
def test_plain_attention_at_new_head_widths_matches_jax(k, v):
    """K2's entries on the CPU (its plain version) at head widths the
    kernel gained, dense and packed, against JAX's
    `global_attention_apply` / `packed_global_attention_apply`."""
    rng = np.random.default_rng(k + v)
    B, L, C, H, S = 2, 24, 128, 2, 3
    G = H * v
    p = {"wq": rng.standard_normal((H, G, k)) / np.sqrt(G),
         "wk": rng.standard_normal((H, C, k)) / np.sqrt(C),
         "wv": rng.standard_normal((H, C, v)) / np.sqrt(C)}
    p = {n: w.astype(np.float32) for n, w in p.items()}
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    g = rng.standard_normal((B, G)).astype(np.float32)
    pad = np.ones((B, L), bool)
    pad[1, 15:] = False
    jp = {n: jnp.asarray(w) for n, w in p.items()}
    tp = {n: torch.from_numpy(w) for n, w in p.items()}
    want = jops.global_attention_apply(jp, jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(pad))
    got = tk.fused_global_attention(tp, torch.from_numpy(x),
                                    torch.from_numpy(g),
                                    torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    seg = rng.integers(0, S + 1, (B, L)).astype(np.int32)
    seg[:, -3:] = 0
    gs = rng.standard_normal((B, S, G)).astype(np.float32)
    want = jops.packed_global_attention_apply(
        jp, jnp.asarray(x), jnp.asarray(gs), jnp.asarray(seg),
        jnp.asarray(pad))
    got = tk.fused_packed_attention(tp, torch.from_numpy(x),
                                    torch.from_numpy(gs),
                                    torch.from_numpy(seg),
                                    torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------- the tiny server

def test_tiny_server_reports_route_coverage(tiny_params, tmp_path):
    """A `tiny` Server on the CPU: its one warm shape counts one decision
    a family (a replay, or here a repeat, adds nothing): the local track
    and the one-pass on the reference route, the attention on K2, in
    `stats()`'s path keys, the registry's
    `*_kernel_path_total{path,reason}` and `pbt diagnose --serve`'s
    coverage lines; drain releases its observers."""
    from proteinbert_tpu_torch import obs
    from proteinbert_tpu_torch.obs import diagnose

    _, tcfg, _, tparams = tiny_params
    events = str(tmp_path / "serve.jsonl")
    tele = obs.Telemetry(events_path=events)
    srv = Server(tparams, tcfg, device="cpu", buckets=(128,),
                 batch_classes=(4,), max_batch=4, telemetry=tele).start()
    try:
        for seq in ("MKTAYIAKQR", "ACDEFGHIK", "MKTAYIAKQR" * 3, "GGGGA"):
            srv.embed(seq, timeout=60)
        stats = srv.stats()
    finally:
        srv.drain()
    for key, label in (("fused_path", "reference/unsupported_shape"),
                       ("attention_path", "pallas/dense"),
                       ("onepass_path", "reference/unsupported_shape")):
        assert stats[key].get(label, 0) >= 1
        assert all(k.startswith(("pallas/", "reference/"))
                   for k in stats[key])
    reg = {k: n for k, n in tele.metrics.snapshot()["counters"].items()
           if "_kernel_path_total" in k}
    want = {f'{m}{{path="{path}",reason="{reason}"}}': 1.0
            for m, path, reason in (
                ("fused_kernel_path_total", "reference", "unsupported_shape"),
                ("attention_kernel_path_total", "pallas", "dense"),
                ("onepass_kernel_path_total", "reference",
                 "unsupported_shape"))}
    assert reg == want
    for counter, cb in ((tfused._COUNTER, srv._path_cb),
                        (tattn._COUNTER, srv._attn_path_cb),
                        (tone._COUNTER, srv._onepass_path_cb)):
        assert cb not in counter._observers
    tele.close()
    text = diagnose.render_serve(diagnose.summarize_serve(
        obs.read_events(events, strict=True)))
    for label in ("fused-kernel", "attention-kernel", "one-pass-trunk"):
        assert f"{label} coverage:" in text, text
    assert "reference/unsupported_shape" in text


def test_quiet_silences_counting_on_its_thread():
    """`quiet()` (a served shape's repeated runs) counts nothing; outside
    it a note counts once; a path other than JAX's two raises."""
    before = _snapshot(PORT_COUNTERS)
    with quiet():
        tk.note_kernel_path("reference", "unsupported_shape", ("q",))
    assert _delta(before, PORT_COUNTERS) == [{}, {}, {}]
    tk.note_kernel_path("pallas", "dense", ("q",))
    assert _delta(before, PORT_COUNTERS)[0] == {("pallas", "dense"): 1}
    with pytest.raises(ValueError, match="path must be"):
        tk.note_kernel_path("xla", "dense")


# ------------------------------------------------------- remat_policy

def test_remat_policy_refusal_is_jax_word_for_word(tiny_params):
    """A `remat_policy` other than "full" / "convs": the JAX model's
    ValueError, word for word, from the port's forward and its seq step
    body (raised before the first block, as JAX's `remat_wrap` does)."""
    jcfg, tcfg, jparams, tparams = tiny_params
    jm = dataclasses.replace(jcfg.model, remat_policy="dots")
    tm = dataclasses.replace(tcfg.model, remat_policy="dots")
    tokens = np.full((1, 16), 5, np.int32)
    ann = np.zeros((1, jm.num_annotations), np.float32)
    with pytest.raises(ValueError) as want:
        jmodel.apply(jparams, jnp.asarray(tokens), jnp.asarray(ann), jm)
    with pytest.raises(ValueError) as got:
        tmodel.apply(tparams, torch.from_numpy(tokens),
                     torch.from_numpy(ann), tm)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as seq:
        seq_parallel_apply(None, tparams, torch.from_numpy(tokens),
                           torch.from_numpy(ann), tm)
    assert str(seq.value) == str(want.value)
    for policy in ("full", "convs"):
        tmodel.apply(tparams, torch.from_numpy(tokens),
                     torch.from_numpy(ann),
                     dataclasses.replace(tm, remat_policy=policy))


# ------------------------------------------ graph-purity's route guard

ROUTED = """
    def k_reference(x):
        return x * 2


    def k_route(x):
        return ("reference", "unsupported_shape") if x.n else ("pallas", "dense")


    def _launch(x):
        KERNEL.launch(x.data_ptr())
        return x


    def guarded(x):
        path, reason = k_route(x)
        if path == "reference":
            return k_reference(x)
        return _launch(x)


    def guarded_else(x):
        path, _ = k_route(x)
        if path == "pallas":
            return _launch(x)
        else:
            return k_reference(x)


    def unguarded(x):
        path, _ = k_route(x)
        out = k_reference(x)                    # on every route
        if path == "pallas":
            return _launch(x)
        return out


    def wrong_name(x):
        path = x.device_kind()
        if path == "reference":                 # not a route decision
            return k_reference(x)
        return _launch(x)
"""


def test_graph_purity_accepts_the_route_guard_and_catches_the_rest(tmp_path):
    """A plain version named under `path == "reference"` (or the else of
    `== "pallas"`), `path` bound from a `*_route` call, is the reference
    route; named outside that test, or under a test of a name no route
    bound, it is still a plain-route finding."""
    root = tmp_path / "pkg"
    root.mkdir()
    (root / "k.py").write_text(textwrap.dedent(ROUTED))
    cfg = CheckConfig(
        root=str(tmp_path), scan_roots=("pkg",), durability_files=(),
        events_py="pkg/events.py", docs_md="docs.md",
        reference_roots=("pkg",), kernel_roots=("pkg",),
        captured_functions=())
    res = run_check(cfg, rules=["graph-purity"])
    got = {f.key for f in res["findings"]}
    prefix = "graph-purity::pkg/k.py::"
    assert got == {prefix + "unguarded:plain-route:k_reference",
                   prefix + "wrong_name:plain-route:k_reference"}


# --------------------------------- coverage constants against the headers

CSRC = pathlib.Path(tfused.__file__).resolve().parent.parent / "csrc"


def _header_constants(name):
    text = (CSRC / name).read_text()
    found = {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (k\w+) = (\d+);", text)}
    m = re.search(r"struct TrackCfg<float, C> \{\s*static constexpr int "
                  r"TL = (\d+), KC = (\d+), PAD = (\d+);", text)
    if m:
        found.update(zip(("TL", "KC", "PAD"), map(int, m.groups())))
    return found


@pytest.mark.parametrize("header,table", [
    ("attention.cuh", tattn.CUDA_CONSTANTS),
    ("local_track.cuh", tfused.CUDA_CONSTANTS),
])
def test_coverage_constants_match_the_cuda_headers(header, table):
    """The coverage predicates and the float32 plans' shared-memory sizes
    read one table of constants (`attention.CUDA_CONSTANTS`,
    `fused_block.CUDA_CONSTANTS`); each value is the one the CUDA header
    declares under the same name, which the C entries check with."""
    found = _header_constants(header)
    assert {k: found.get(k) for k in table} == table
