"""More than 16 segments a row, on the CPU against the JAX package with the
same weights (made by the JAX `init` from a seed, carried through the flat
export layout, `export.flatten_params` → `weights.params_from_flat`), at
S = 17, 32 and 64:

(a) K2's packed entry (`fused_packed_attention`, its plain path here)
    against the JAX entry's Pallas kernel in interpret mode, with more
    segments than the rows hold: the empty ones are exactly +0.0;
(b) #6's packed entry (`fused_onepass_segments`) against the JAX entry's
    Pallas kernel in interpret mode;
(c) a 2-block C=128 packed forward (`encode`, `apply`) against JAX's;
(d) a ragged served batch at pack_max_segments=32, short proteins (8-14
    residues, a 16-token span each) more than 16 to a row, against JAX's
    `RaggedDispatcher`.

Both packages take the kernel route at every shape here (their route
counters say so). The CUDA kernels are held against these plain versions
on the card by chip_smoke.py (`--phase coverage`). float32, tolerance
1e-5 on trunk and attention outputs (same arithmetic, another summation
order), 1e-4 on logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteinbert_tpu.configs import get_preset as jax_preset
from proteinbert_tpu.data.packing import OnlinePacker
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.kernels import attention as jattn
from proteinbert_tpu.kernels import one_pass as jone
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.serve import dispatch as jdispatch
from proteinbert_tpu_torch import inference as tinf
from proteinbert_tpu_torch import kernels as tk
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.kernels import attention as tattn
from proteinbert_tpu_torch.kernels import one_pass as tone
from proteinbert_tpu_torch.models import proteinbert as tmodel
from proteinbert_tpu_torch.serve import dispatch as tdispatch
from proteinbert_tpu_torch.weights import params_from_flat

torch.set_num_threads(1)

TOL = 1e-5
LOGIT_TOL = 1e-4
SEGMENTS = (17, 32, 64)
B, L = 2, 128
WIDE = dict(local_dim=128, global_dim=128, key_dim=32, num_heads=4,
            num_blocks=2, num_annotations=64, dtype="float32",
            use_pallas=True)
SERVE_LEN, SERVE_SEGMENTS = 512, 32
BUCKETS = (16, 32, 64, 128, 256, 512)


@pytest.fixture(scope="module")
def pair():
    """The JAX and port configs at WIDE and the same weights in both."""
    jcfg, tcfg = jax_preset("tiny"), get_preset("tiny")
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **WIDE))
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **WIDE))
    jparams = jmodel.init(jax.random.PRNGKey(25), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


def _jax_block(jparams, i):
    """Block i's JAX params, whether the blocks are stacked or a list."""
    blocks = jparams["blocks"]
    if isinstance(blocks, (list, tuple)):
        return blocks[i]
    return jax.tree_util.tree_map(lambda a: a[i], blocks)


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(want), np.asarray(got), rtol=tol,
                               atol=tol)


def _inputs(S, seed):
    """Random rows and per-segment globals; packed ids over 1..S-3 in runs
    of 1-6 positions with pad gaps (segments S-2 .. S hold no position),
    and a real-token mask."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, L), np.int32)
    for b in range(B):
        pos, sid = 0, 1
        while pos < L and sid <= S - 3:
            n = int(rng.integers(1, 7))
            seg[b, pos:pos + n] = sid
            pos += n + int(rng.integers(0, 2))
            sid += 1
    return {"x": rng.standard_normal((B, L, 128)).astype(np.float32),
            "bseg": rng.standard_normal((B, S, 128)).astype(np.float32),
            "gseg": rng.standard_normal((B, S, 128)).astype(np.float32),
            "seg": seg, "real": rng.random((B, L)) < 0.9}


def _empty_exact_zero(out, seg, real, S):
    """Every segment no real position names: exactly +0.0 in `out`."""
    seen = np.where(real, seg, 0)
    n = 0
    for b in range(B):
        for s in range(S):
            if not (seen[b] == s + 1).any():
                rows = out[b, s]
                assert (rows == 0).all() and not torch.signbit(rows).any()
                n += 1
    return n


def _count(counter, key):
    return dict(counter).get(key, 0)


# -------------------------------------------------------------- (a) K2

@pytest.mark.parametrize("S", SEGMENTS)
def test_packed_attention_matches_pallas(pair, S):
    jcfg, tcfg, jparams, tparams = pair
    d = _inputs(S, 100 + S)
    pk = ("pallas", "packed")
    j0, t0 = _count(jattn.ATTN_PATH_TOTAL, pk), _count(tk.ATTN_PATH_TOTAL, pk)
    want = jattn.fused_packed_attention(
        _jax_block(jparams, 0)["attention"], jnp.asarray(d["x"]),
        jnp.asarray(d["gseg"]), jnp.asarray(d["seg"]),
        jnp.asarray(d["real"]), interpret=True)
    got = tattn.fused_packed_attention(
        tparams["blocks"][0]["attention"], torch.from_numpy(d["x"]),
        torch.from_numpy(d["gseg"]), torch.from_numpy(d["seg"]),
        torch.from_numpy(d["real"]))
    assert _count(jattn.ATTN_PATH_TOTAL, pk) == j0 + 1
    assert _count(tk.ATTN_PATH_TOTAL, pk) == t0 + 1
    assert got.shape == (B, S, 128)
    _close(want, got)
    assert _empty_exact_zero(got, d["seg"], d["real"], S) >= 3 * B


# -------------------------------------------------------------- (b) #6

@pytest.mark.parametrize("S", SEGMENTS)
def test_onepass_segments_matches_pallas(pair, S):
    jcfg, tcfg, jparams, tparams = pair
    d = _inputs(S, 200 + S)
    jb, tb = _jax_block(jparams, 1), tparams["blocks"][1]
    names = tk.TRACK_PARAMS
    pk = ("pallas", "packed")
    j0 = _count(jone.ONEPASS_PATH_TOTAL, pk)
    t0 = _count(tk.ONEPASS_PATH_TOTAL, pk)
    wl, wa = jone.fused_onepass_segments(
        {n: jb[n] for n in names}, jb["attention"], jnp.asarray(d["x"]),
        jnp.asarray(d["bseg"]), jnp.asarray(d["gseg"]),
        jnp.asarray(d["seg"]), jnp.asarray(d["real"]), interpret=True)
    gl, ga = tone.fused_onepass_segments(
        {n: tb[n] for n in names}, tb["attention"], torch.from_numpy(d["x"]),
        torch.from_numpy(d["bseg"]), torch.from_numpy(d["gseg"]),
        torch.from_numpy(d["seg"]), torch.from_numpy(d["real"]))
    assert _count(jone.ONEPASS_PATH_TOTAL, pk) == j0 + 1
    assert _count(tk.ONEPASS_PATH_TOTAL, pk) == t0 + 1
    _close(wl, gl)
    _close(wa, ga)
    assert _empty_exact_zero(ga, d["seg"], d["real"], S) >= 3 * B


# ------------------------------------------------ (c) the packed forward

def _packed_rows(S, A, seed):
    """(B, L) tokens of short proteins packed S - 1 to a row, the last
    segment empty, and per-segment annotations."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    span = L // S
    for b in range(B):
        for s in range(S - 1):
            n = int(rng.integers(1, span - 1)) if span > 2 else 0
            start = s * span
            tokens[b, start] = 1
            tokens[b, start + 1:start + 1 + n] = rng.integers(4, 26, n)
            tokens[b, start + 1 + n] = 2
            seg[b, start:start + span] = s + 1
    ann = (rng.random((B, S, A)) < 0.05).astype(np.float32)
    return tokens, seg, ann


@pytest.mark.parametrize("S", SEGMENTS)
def test_packed_forward_matches_jax(pair, S):
    jcfg, tcfg, jparams, tparams = pair
    tokens, seg, ann = _packed_rows(S, tcfg.model.num_annotations, 300 + S)
    pad = tokens != 0
    pk = ("pallas", "packed")
    t0 = _count(tk.ATTN_PATH_TOTAL, pk) + _count(tk.ONEPASS_PATH_TOTAL, pk)
    jl, jg = jmodel.encode(jparams, jnp.asarray(tokens), jnp.asarray(ann),
                           jcfg.model, jnp.asarray(pad), jnp.asarray(seg))
    tl, tg = tmodel.encode(tparams, torch.from_numpy(tokens),
                           torch.from_numpy(ann), tcfg.model,
                           torch.from_numpy(pad), torch.from_numpy(seg))
    assert _count(tk.ATTN_PATH_TOTAL, pk) + _count(
        tk.ONEPASS_PATH_TOTAL, pk) > t0
    assert tg.shape == (B, S, tcfg.model.global_dim)
    _close(jl, tl.numpy())
    _close(jg, tg.numpy())
    jlog = jmodel.apply(jparams, jnp.asarray(tokens), jnp.asarray(ann),
                        jcfg.model, segment_ids=jnp.asarray(seg))
    tlog = tmodel.apply(tparams, torch.from_numpy(tokens),
                        torch.from_numpy(ann), tcfg.model,
                        segment_ids=torch.from_numpy(seg))
    for j, t in zip(jlog, tlog):
        _close(j, t.numpy(), LOGIT_TOL)


# -------------------------------------------- (d) the ragged served batch

def test_ragged_batch_of_short_proteins_matches_jax(pair):
    """40 proteins of 8-14 residues in 16-token spans through JAX's packer:
    32 in row 0, 8 in row 1; `embed` and `predict_go` per rider."""
    jcfg, tcfg, jparams, tparams = pair
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data,
                                                 seq_len=SERVE_LEN))
    tcfg = tcfg.replace(data=dataclasses.replace(tcfg.data,
                                                 seq_len=SERVE_LEN))
    rng = np.random.default_rng(25)
    alphabet = "ACDEFGHIKLMNPQRSTVWY"
    seqs = ["".join(rng.choice(list(alphabet), int(rng.integers(8, 15))))
            for _ in range(40)]
    jd = jdispatch.RaggedDispatcher(jparams, jcfg, buckets=BUCKETS,
                                    rows_per_batch=2,
                                    max_segments=SERVE_SEGMENTS)
    td = tdispatch.RaggedDispatcher(tparams, tcfg, buckets=BUCKETS,
                                    rows_per_batch=2,
                                    max_segments=SERVE_SEGMENTS,
                                    device="cpu")
    toks = tinf._tokenize_masked(seqs, SERVE_LEN)
    packer = OnlinePacker(SERVE_LEN, SERVE_SEGMENTS)
    for i, s in enumerate(seqs):
        assert td.bucket_len(len(s)) == 16
        packer.place(i, td.bucket_len(len(s)))
    tokens = np.zeros((2, SERVE_LEN), np.int32)
    seg = np.zeros_like(tokens)
    ann = np.zeros((2, SERVE_SEGMENTS, tcfg.model.num_annotations),
                   np.float32)
    riders = []
    for r, row in enumerate(packer.pop_rows(2)):
        for s, (i, start, span) in enumerate(row):
            tokens[r, start:start + span] = toks[i, :span]
            seg[r, start:start + span] = s + 1
            riders.append((r, s, start, span))
    assert len(riders) == 40 and int(seg[0].max()) == SERVE_SEGMENTS
    batch = (tokens, seg, ann, riders)
    pk = ("pallas", "packed")
    t0 = _count(tk.ATTN_PATH_TOTAL, pk) + _count(tk.ONEPASS_PATH_TOTAL, pk)
    for kind in ("embed", "predict_go"):
        want = jd.run_packed(kind, *batch)
        got = td.run_packed(kind, *batch)
        assert len(got) == len(want) == 40
        for w, g in zip(want, got):
            if kind == "embed":
                for k in ("global", "local_mean"):
                    _close(w[k], g[k])
            else:
                _close(w, g)
    assert _count(tk.ATTN_PATH_TOTAL, pk) + _count(
        tk.ONEPASS_PATH_TOTAL, pk) > t0
