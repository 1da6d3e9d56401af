"""The port's packing module (`proteinbert_tpu_torch.data.packing`) against
the JAX package's on seeded length streams: plans, online placement,
expiry and pops, assembled batches and their inverse must be IDENTICAL
(integer bookkeeping, no tolerance)."""

import numpy as np
import pytest

from proteinbert_tpu.data import packing as jpack
from proteinbert_tpu_torch.data import packing as tpack


def _lengths(seed, n, seq_len):
    rng = np.random.default_rng(seed)
    # UniRef-like: most proteins short, a tail at the window.
    return np.minimum(rng.lognormal(4.5, 0.8, n).astype(int) + 3, seq_len)


@pytest.mark.parametrize("seed,seq_len,max_segments,max_open", [
    (0, 128, 4, 2), (1, 512, 8, 16), (2, 64, 1, 3), (3, 256, 16, 1)])
def test_pack_planner_plans_are_identical(seed, seq_len, max_segments,
                                          max_open):
    j = jpack.PackPlanner(seq_len, max_segments, max_open)
    t = tpack.PackPlanner(seq_len, max_segments, max_open)
    for i, n in enumerate(_lengths(seed, 300, seq_len)):
        assert t.add(i, int(n)) == j.add(i, int(n))
    assert t.flush() == j.flush()


@pytest.mark.parametrize("seed,seq_len,max_segments", [
    (4, 512, 8), (5, 128, 2), (6, 1024, 16)])
def test_online_packer_matches_place_expire_pop(seed, seq_len,
                                                max_segments):
    rng = np.random.default_rng(seed)
    buckets = np.array([s for s in (32, 64, 128, 256, 512, 1024)
                        if s <= seq_len])
    j = jpack.OnlinePacker(seq_len, max_segments)
    t = tpack.OnlinePacker(seq_len, max_segments)
    for i in range(400):
        op = rng.random()
        if op < 0.8:
            span = int(rng.choice(buckets))
            assert t.place(i, span) == j.place(i, span)
        elif op < 0.9:
            mod = int(rng.integers(2, 7))
            assert (t.expire(lambda p: p % mod == 0)
                    == j.expire(lambda p: p % mod == 0))
        else:
            n = int(rng.integers(1, 4))
            assert t.pop_rows(n) == j.pop_rows(n)
        assert len(t) == len(j) and t.total_items() == j.total_items()
        assert t.row_heads() == j.row_heads()
    assert t.drain_items() == j.drain_items()


def test_online_packer_rejects_what_jax_rejects():
    for args in ((128, 0), (1, 4)):
        with pytest.raises(ValueError):
            jpack.OnlinePacker(*args)
        with pytest.raises(ValueError):
            tpack.OnlinePacker(*args)
    t = tpack.OnlinePacker(64, 2)
    for span in (0, 65):
        with pytest.raises(ValueError, match="span"):
            t.place("x", span)


def test_pack_rows_unpack_and_pad_fraction_are_identical():
    rng = np.random.default_rng(7)
    seq_len, S, A = 128, 4, 6
    lengths = _lengths(8, 40, seq_len - 2)
    tokens = np.zeros((40, seq_len), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, 0] = 1
        tokens[i, 1:1 + n] = rng.integers(4, 26, n)
        tokens[i, 1 + n] = 2
    ann = (rng.random((40, A)) < 0.3).astype(np.float32)
    planner = jpack.PackPlanner(seq_len, S, 4)
    groups = []
    for i in range(40):
        groups.extend(planner.add(i, int((tokens[i] != 0).sum())))
    groups.extend(planner.flush())
    want = jpack.pack_rows(tokens, ann, groups, seq_len, S)
    got = tpack.pack_rows(tokens, ann, groups, seq_len, S)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert tpack.pad_fraction(got["tokens"]) == jpack.pad_fraction(
        want["tokens"])
    for (gt, ga), (wt, wa) in zip(tpack.unpack_segments(got),
                                  jpack.unpack_segments(want)):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(ga, wa)
    assert len(tpack.unpack_segments(got)) == 40
