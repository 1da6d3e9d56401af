"""The port's C++ host components against the JAX package's: the batch
tokenizer (native, numpy and the JAX `tokenize_batch`, bit for bit) and
the .fai builder (port native, JAX native and Python, byte for byte), on
inputs made from a numpy seed."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from proteinbert_tpu.data.transforms import tokenize_batch as jax_tokenize
from proteinbert_tpu.etl.fasta import build_index as jax_build_index
from proteinbert_tpu_torch import native
from proteinbert_tpu_torch.data import transforms
from proteinbert_tpu_torch.data.transforms import tokenize_batch
from proteinbert_tpu_torch.data.vocab import EOS_ID, SOS_ID, UNK_ID
from proteinbert_tpu_torch.etl.fasta import build_index
from proteinbert_tpu_torch.native import build as native_build
from tests.test_torch_obs import _body

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALPHABET = list("ACDEFGHIKLMNPQRSTVWYXZ*")
pytestmark = pytest.mark.skipif(
    not native.native_available("tokenizer")
    or not native.native_available("fasta_index"),
    reason="no C++ compiler here: the port's native libraries do not build")


def _seqs(seed, n, max_len, alphabet=ALPHABET):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(alphabet, size=int(rng.integers(0, max_len))))
            for _ in range(n)]


def _all_four(seqs, seq_len, **kw):
    """The port's native and numpy paths, then JAX's native and numpy."""
    return (native.tokenize_batch_native(seqs, seq_len, **kw),
            tokenize_batch(seqs, seq_len, use_native=False, **kw),
            jax_tokenize(seqs, seq_len, use_native=True, **kw),
            jax_tokenize(seqs, seq_len, use_native=False, **kw))


# The rows of `row_ids` are global dataset indices, far from 0..B-1.
CASES = {
    "no_crop": (dict(n=64, max_len=60), 64, {}),
    "head_truncation": (dict(n=32, max_len=200), 48, {}),
    "crop_windows": (dict(n=48, max_len=400), 40,
                     dict(crop_seed=2**63 + 12345,
                          row_ids=np.arange(48, dtype=np.int64) * 977 + 5)),
    "crop_default_rows": (dict(n=16, max_len=300), 32, dict(crop_seed=7)),
    "unknown_characters": (dict(n=24, max_len=80,
                                alphabet=list("ACDE#@jkl ~\x7f")), 96, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tokenizer_bit_for_bit_with_numpy_and_jax(case):
    shape, seq_len, kw = CASES[case]
    got = _all_four(_seqs(3, **shape), seq_len, **kw)
    assert got[0].dtype == np.int32 and got[0].shape == (shape["n"], seq_len)
    for other in got[1:]:
        np.testing.assert_array_equal(got[0], other)


def test_tokenizer_unknown_characters_map_to_unk():
    out = native.tokenize_batch_native(["A#A", "é"], 8)
    assert out[0, 2] == UNK_ID and out[0, 0] == SOS_ID and out[0, 4] == EOS_ID
    np.testing.assert_array_equal(out, tokenize_batch(["A#A", "é"], 8,
                                                      use_native=False))


def test_tokenizer_empty_batch_and_empty_sequence():
    for seqs in ([], [""], ["", "MKT", ""]):
        got = _all_four(seqs, 10)
        assert got[0].shape == (len(seqs), 10)
        for other in got[1:]:
            np.testing.assert_array_equal(got[0], other)
    assert list(native.tokenize_batch_native([""], 4)[0]) == [
        SOS_ID, EOS_ID, 0, 0]


def test_tokenize_batch_goes_native_from_eight_rows(monkeypatch):
    """B >= _NATIVE_MIN_BATCH runs the C++ tokenizer (its counter moves),
    B below it and use_native=False the numpy path; the output is the
    same either way."""
    seqs = _seqs(5, 9, 50)
    assert transforms._NATIVE_MIN_BATCH == 8
    for n, native_ran in ((7, False), (8, True), (9, True)):
        before = native.calls["tokenizer"]
        out = tokenize_batch(seqs[:n], 32, crop_seed=1)
        assert (native.calls["tokenizer"] > before) == native_ran, n
        np.testing.assert_array_equal(out, tokenize_batch(
            seqs[:n], 32, crop_seed=1, use_native=False))
    before = native.calls["tokenizer"]
    tokenize_batch(seqs, 32, use_native=False)
    tokenize_batch(seqs[:2], 32, use_native=True)
    assert native.calls["tokenizer"] == before + 1
    # Without the library the numpy path answers.
    monkeypatch.setattr("proteinbert_tpu_torch.native.tokenizer._lib",
                        lambda: None)
    before = native.calls["tokenizer"]
    np.testing.assert_array_equal(tokenize_batch(seqs, 32), tokenize_batch(
        seqs, 32, use_native=False))
    assert native.calls["tokenizer"] == before


def test_abi_mismatch_raises(monkeypatch):
    from proteinbert_tpu_torch.native import tokenizer

    monkeypatch.setattr(tokenizer, "_configured", False)
    monkeypatch.setattr(tokenizer, "_ABI_VERSION", 99)
    with pytest.raises(RuntimeError, match="ABI 2 != expected 99"):
        tokenizer.tokenize_batch_native(["MKT"], 8)


def test_builds_the_ports_own_sources_into_its_build_dir():
    """Hash-keyed .so files under proteinbert_tpu_torch/native/_build/,
    compiled from the port's .cpp files, never the JAX package's."""
    pkg = ROOT / "proteinbert_tpu_torch" / "native"
    assert pathlib.Path(native_build._SRC_DIR) == pkg
    assert pathlib.Path(native_build._BUILD_DIR) == pkg / "_build"
    for name in ("tokenizer", "fasta_index"):
        lib = native_build.load_library(name)
        so = pathlib.Path(lib._name)
        assert so.parent == pkg / "_build" and so.name.startswith(name + "-")
        src = (pkg / f"{name}.cpp").read_text()
        assert so == pathlib.Path(native_build._so_path(name, src))
    assert "proteinbert_tpu_torch/native/_build/" in (
        ROOT / ".gitignore").read_text().split()


def test_failed_build_gives_none_once(tmp_path, monkeypatch):
    """No compiler: None (logged once, then cached) and callers use
    their Python path."""
    monkeypatch.setattr(native_build, "_cache", {})
    monkeypatch.setattr(native_build, "_CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native_build, "_BUILD_DIR", str(tmp_path / "b"))
    assert native_build.load_library("tokenizer") is None
    assert native_build._cache == {"tokenizer": None}
    assert not native_build.native_available("tokenizer")


def _without_counter(source):
    """The source without the call counter, the copy's one addition: the
    wrappers' `calls[...] += 1` lines and build.py's `calls = {...}`."""
    tree = ast.parse("\n".join(ln for ln in source.splitlines()
                               if "calls[" not in ln))
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "")
        == "calls")]
    return ast.unparse(tree)


@pytest.mark.parametrize("module", ["native/build.py", "native/tokenizer.py",
                                    "native/fasta_index.py"])
def test_copies_differ_from_jax_only_in_docstrings_imports_and_counter(
        module):
    want = (ROOT / "proteinbert_tpu" / module).read_text()
    got = (ROOT / "proteinbert_tpu_torch" / module).read_text()
    assert _body(_without_counter(got)) == _body(want)


def test_cpp_sources_differ_from_jax_only_in_comments():
    def code(path):
        return [ln.split("//")[0].rstrip() for ln in
                path.read_text().splitlines()
                if ln.split("//")[0].strip()]

    for name in ("tokenizer.cpp", "fasta_index.cpp"):
        assert code(ROOT / "proteinbert_tpu_torch/native" / name) == code(
            ROOT / "proteinbert_tpu/native" / name)


# ---------------------------------------------------------- fasta indexer

def _fai_three_ways(tmp_path, text, name):
    """The .fai by the port's C++ scanner, the JAX package's C++ scanner
    and the port's Python loop."""
    fa = tmp_path / f"{name}.fasta"
    fa.write_bytes(text if isinstance(text, bytes) else text.encode())
    before = native.calls["fasta_index"]
    paths = (build_index(str(fa), str(tmp_path / f"{name}.port.fai")),
             jax_build_index(str(fa), str(tmp_path / f"{name}.jax.fai")),
             build_index(str(fa), str(tmp_path / f"{name}.py.fai"),
                         use_native=False))
    assert native.calls["fasta_index"] == before + 1
    return [pathlib.Path(p).read_bytes() for p in paths]


def _wrapped_fasta(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seq = "".join(rng.choice(ALPHABET[:20], size=int(rng.integers(1, 200))))
        width = int(rng.integers(5, 70))
        body = "\n".join(seq[j:j + width] for j in range(0, len(seq), width))
        out.append(f">UniRef90_R{i} desc {i}\n{body}\n")
    return "".join(out)


FAI_CASES = {
    "simple": ">a desc\nMKTAYI\n>b\nGGG\n",
    "wrapped_short_tail": ">a\nMKTAYIAK\nQRQISF\n>b x y\nAC\n",
    "no_trailing_newline": ">a\nMKTAYIAK\nQRQISFVK\nGG",
    "crlf": ">a\r\nMKTAYIAK\r\nQR\r\n>b\r\nAC\r\n",
    "blank_line_between_records": ">a\nMKTAYI\n\n>b\nACDE\n",
    "header_whitespace": ">  a desc\nMKTA\n>\t b\nGG\n",
    "empty_header": ">\nAC\n",
    "zero_length_record": ">only_header\n",
    "empty_file": "",
    "seeded_wrapped": _wrapped_fasta(11, 40),
}


@pytest.mark.parametrize("name", sorted(FAI_CASES))
def test_fai_port_native_equals_jax_native_and_python(tmp_path, name):
    port, jax, python = _fai_three_ways(tmp_path, FAI_CASES[name], name)
    assert port == jax == python
    if name == "header_whitespace":
        assert port.decode().splitlines()[1].startswith("b\t")


@pytest.mark.parametrize("text,record", [
    (">ok\nAAAA\n>bad_rec\nMKTA\nYIAKQRQI\n", "'bad_rec'"),
    ("AB\nABCD\n>a\nAC\n", "None"),   # ragged text before any header
])
def test_fai_ragged_same_error_and_no_index(tmp_path, text, record):
    fa = tmp_path / "ragged.fasta"
    fa.write_text(text)
    messages = []
    for build, kw in ((build_index, {}), (build_index, {"use_native": False}),
                      (jax_build_index, {})):
        with pytest.raises(ValueError, match=f"record {record}") as err:
            build(str(fa), **kw)
        messages.append(str(err.value))
        assert not (tmp_path / "ragged.fasta.fai").exists()
        assert not list(tmp_path.glob("*.tmp*"))
    assert len(set(messages)) == 1
