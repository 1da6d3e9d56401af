"""The port's corpus tools against the JAX package's on the same inputs:
UniRef XML → SQLite (one shard, two shards merged, malformed entries, a
truncated gzip), the SQLite ↔ FASTA join, SQLite + FASTA → HDF5, the GO
ontology, the FASTA readers, `utils/sharding`, `utils/stats` and the four
corpus verbs of the command line. The corpus is chip_smoke's seeded
UniRef90-shaped generator at a few hundred entries; the hostile inputs
are tests/test_etl.py's. Every comparison is exact: the port's modules
are copies of the JAX ones (held to them by syntax tree below)."""

import ast
import contextlib
import gzip
import io
import json
import pathlib

import h5py
import numpy as np
import pytest
import torch

import chip_smoke
from proteinbert_tpu import etl as jetl
from proteinbert_tpu.cli.main import main as jmain
from proteinbert_tpu.utils import sharding as jsharding
from proteinbert_tpu.utils import stats as jstats
from proteinbert_tpu_torch import etl as tetl
from proteinbert_tpu_torch.cli.main import main as pmain
from proteinbert_tpu_torch.utils import sharding as tsharding
from proteinbert_tpu_torch.utils import stats as tstats
from tests.test_etl import RECORDS, _hostile_xml, _make_xml
from tests.test_torch_cli import loggers_restored  # noqa: F401 (autouse)
from tests.test_torch_obs import _body

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 400           # corpus entries
MIN_RECORDS = 20  # create-h5 --min-records at this size: ~40 columns kept
PKGS = {"port": tetl, "jax": jetl}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """chip_smoke's corpus of N entries, plus a FASTA that lacks every
    7th record (unjoinable annotation rows) and its one-shard DB and meta
    CSV written by the JAX package."""
    root = tmp_path_factory.mktemp("corpus")
    paths = chip_smoke.write_uniref_corpus(str(root), N, seed=5)
    gappy = root / "gappy.fasta"
    with open(gappy, "w") as f:
        for i, (name, seq) in enumerate(jetl.iter_fasta(paths["fasta"])):
            if i % 7:
                f.write(f">{name} member\n" + "".join(
                    seq[j:j + 60] + "\n" for j in range(0, len(seq), 60)))
    paths["gappy"] = str(gappy)
    onto = jetl.parse_obo(paths["go"])
    paths["db"] = str(root / "jax.db")
    parser = jetl.UnirefToSqliteParser(paths["xml"], onto, paths["db"],
                                       verbose=False)
    parser.parse()
    paths["meta"] = str(root / "jax_meta.csv")
    jetl.save_meta_csv(onto, paths["meta"], counts=parser.go_record_counts,
                       total_records=parser.n_records_with_any_go)
    return paths


def _parse(pkg, xml, go, db, **kw):
    onto = PKGS[pkg].parse_obo(go)
    parser = PKGS[pkg].UnirefToSqliteParser(xml, onto, str(db),
                                            verbose=False, **kw)
    parser.parse()
    return parser


def _outcome(parser):
    return (dict(parser.go_record_counts), dict(parser.unrecognized_go),
            dict(parser.skipped_entries),
            dict(parser.unrecognized_go_categories),
            parser.n_records_with_any_go, parser.n_entries,
            None if parser.stream_error is None
            else parser.stream_error.split(":")[0])


# ------------------------------------------------------------ ontology

def test_ontology_and_meta_csv_match_jax(corpus, tmp_path):
    port, jax = (PKGS[k].parse_obo(corpus["go"]) for k in ("port", "jax"))
    assert len(port) == len(jax) == chip_smoke.ETL_GO_TERMS
    for gid, t in jax.terms.items():
        p = port.terms[gid]
        assert (p.index, p.name, p.namespace, p.parents, p.children) == (
            t.index, t.name, t.namespace, t.parents, t.children)
    assert port.roots() == jax.roots()
    rng = np.random.default_rng(0)
    ids = sorted(jax.terms) + ["GO:9999999"]
    for _ in range(20):
        pick = list(rng.choice(ids, size=int(rng.integers(0, 8))))
        assert port.complete(pick) == jax.complete(pick)
        assert port.complete_indices(pick) == jax.complete_indices(pick)
    counts = {g: int(c) for g, c in zip(ids, rng.integers(0, 50, len(ids)))}
    for k, onto in (("port", port), ("jax", jax)):
        PKGS[k].save_meta_csv(onto, str(tmp_path / f"{k}.csv"),
                              counts=counts, total_records=77)
    assert (tmp_path / "port.csv").read_bytes() == (
        tmp_path / "jax.csv").read_bytes()
    assert tetl.load_meta_csv(str(tmp_path / "port.csv")) == \
        jetl.load_meta_csv(str(tmp_path / "jax.csv"))


# ------------------------------------------------------ XML → SQLite

@pytest.mark.parametrize("limit", [None, 150])
def test_one_shard_tables_match_jax(corpus, tmp_path, limit):
    parsers = {k: _parse(k, corpus["xml"], corpus["go"], tmp_path / f"{k}.db",
                         max_entries=limit, chunk_size=64)
               for k in PKGS}
    rows = {k: chip_smoke.sqlite_rows(str(tmp_path / f"{k}.db"))
            for k in PKGS}
    assert rows["port"] == rows["jax"]
    assert len(rows["port"]["protein_annotations"]) == (limit or N)
    assert _outcome(parsers["port"]) == _outcome(parsers["jax"])
    assert parsers["port"].unrecognized_go  # the corpus's unknown ids


def test_two_shards_merged_match_jax_and_one_shard(corpus, tmp_path):
    merged = {}
    for k in PKGS:
        shards = [str(tmp_path / f"{k}{i}.db") for i in range(2)]
        for i, path in enumerate(shards):
            _parse(k, corpus["xml"], corpus["go"], path, shard_index=i,
                   num_shards=2)
        out = str(tmp_path / f"{k}_merged.db")
        assert PKGS[k].merge_shard_dbs(shards, out) == N
        merged[k] = (chip_smoke.sqlite_rows(out), PKGS[k].read_aggregates(out))
    assert merged["port"] == merged["jax"]
    assert merged["port"][0] == chip_smoke.sqlite_rows(corpus["db"])


def test_malformed_entries_counted_as_jax(tmp_path):
    go = tmp_path / "go.txt"
    from tests.test_etl import GO_TXT

    go.write_text(GO_TXT)
    xml = tmp_path / "hostile.xml.gz"
    with gzip.open(xml, "wt") as f:
        f.write(_hostile_xml(None))
    parsers = {k: _parse(k, str(xml), str(go), tmp_path / f"{k}.db")
               for k in PKGS}
    assert _outcome(parsers["port"]) == _outcome(parsers["jax"])
    assert sum(parsers["port"].skipped_entries.values()) == 4
    assert chip_smoke.sqlite_rows(str(tmp_path / "port.db")) == \
        chip_smoke.sqlite_rows(str(tmp_path / "jax.db"))


@pytest.mark.parametrize("cut", [0.3, 0.6])
def test_truncated_gzip_same_as_jax(corpus, tmp_path, cut):
    data = pathlib.Path(corpus["xml"]).read_bytes()
    xml = tmp_path / "cut.xml.gz"
    xml.write_bytes(data[:int(len(data) * cut)])
    parsers = {k: _parse(k, str(xml), corpus["go"], tmp_path / f"{k}.db")
               for k in PKGS}
    assert parsers["port"].stream_error is not None
    assert _outcome(parsers["port"]) == _outcome(parsers["jax"])
    port = chip_smoke.sqlite_rows(str(tmp_path / "port.db"))
    assert port == chip_smoke.sqlite_rows(str(tmp_path / "jax.db"))
    assert 0 < len(port["protein_annotations"]) < N


# ---------------------------------------------------- join + HDF5

@pytest.mark.parametrize("kw", [dict(shuffle=False),
                                dict(shuffle=True, seed=3),
                                dict(shuffle=True, seed=0,
                                     records_limit=100)],
                         ids=["ordered", "shuffled", "limited"])
def test_join_stream_and_stats_match_jax(corpus, kw):
    got = {}
    for k in PKGS:
        stats = {}
        rows = list(PKGS[k].load_seqs_and_annotations(
            corpus["db"], corpus["gappy"], verbose=False, stats=stats, **kw))
        got[k] = (rows, stats)
    assert got["port"] == got["jax"]
    rows, stats = got["port"]
    assert stats["n_unjoinable"] > 0 and stats["n_yielded"] == len(rows)


def _h5_contents(path):
    out = {}
    with h5py.File(path, "r") as f:
        for name, ds in f.items():
            out[name] = (ds.shape, ds.maxshape, ds.chunks, str(ds.dtype),
                         ds[()].tolist(), dict(ds.attrs))
        out["/"] = dict(f.attrs)
    return out


def test_create_h5_matches_jax(corpus, tmp_path):
    n = {}
    for k in PKGS:
        n[k] = PKGS[k].create_h5_dataset(
            corpus["db"], corpus["gappy"], corpus["meta"],
            str(tmp_path / f"{k}.h5"), seed=1,
            min_records_to_keep_annotation=MIN_RECORDS, chunk_size=64,
            verbose=False)
    assert n["port"] == n["jax"] > 0
    port, jax = (_h5_contents(tmp_path / f"{k}.h5") for k in PKGS)
    assert port == jax
    assert port["annotation_masks"][0][1] > 10   # common columns kept


def test_fasta_readers_match_jax(corpus, tmp_path):
    assert list(tetl.iter_fasta(corpus["gappy"])) == list(
        jetl.iter_fasta(corpus["gappy"]))
    names = [name for name, _ in jetl.iter_fasta(corpus["gappy"])][::37]
    with tetl.FastaReader(corpus["gappy"]) as p, \
            jetl.FastaReader(corpus["gappy"]) as j:
        assert len(p) == len(j)
        for name in names:
            assert p.fetch(name) == j.fetch(name)
            assert p.fetch_range(name, 3, 70) == j.fetch_range(name, 3, 70)
    genome = tmp_path / "genome.fa"
    genome.write_text(">chr1\nACGTACGTAC\nGTAC\n>chrX\nTTTTGGGGCC\n")
    with tetl.GenomeReader(str(genome)) as p, \
            jetl.GenomeReader(str(genome)) as j:
        for chrom in ("1", "chr1", 23, "X"):
            assert p.chromosome_name(chrom) == j.chromosome_name(chrom)
        assert p.fetch("X", 2, 6) == j.fetch("X", 2, 6)
        assert p.fetch0(1, 8, 13) == j.fetch0(1, 8, 13)


# ------------------------------------------------------------ utilities

def test_sharding_matches_jax():
    for n in (0, 1, 7, 100, 101):
        for k in (1, 2, 3, 8):
            spans = [tsharding.shard_range(n, i, k) for i in range(k)]
            assert spans == [jsharding.shard_range(n, i, k)
                             for i in range(k)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert max(e - s for s, e in spans) - min(
                e - s for s, e in spans) <= 1
            items = list(range(n))
            assert [tsharding.shard_items(items, i, k) for i in range(k)] \
                == [jsharding.shard_items(items, i, k) for i in range(k)]
    assert list(tsharding.to_chunks(range(10), 4)) == list(
        jsharding.to_chunks(range(10), 4))
    assert tsharding.all_shard_file_names("a/u.db", 3) == \
        jsharding.all_shard_file_names("a/u.db", 3)
    assert tsharding.shard_file_name("u.db", 0, 1) == "u.db"


ENV_CASES = {
    "standalone": ({}, (), (0, 1)),
    "explicit": ({"SLURM_ARRAY_TASK_ID": "5", "TASK_INDEX": "1"}, (2, 4),
                 (2, 4)),
    "slurm": ({"SLURM_ARRAY_TASK_ID": "3", "SLURM_ARRAY_TASK_COUNT": "8",
               "TASK_INDEX": "1", "TASK_COUNT": "2"}, (), (3, 8)),
    "slurm_offset": ({"SLURM_ARRAY_TASK_ID": "3", "TASK_ID_OFFSET": "10",
                      "SLURM_ARRAY_TASK_COUNT": "8"}, (), (13, 8)),
    "generic": ({"TASK_INDEX": "1", "TASK_COUNT": "2"}, (), (1, 2)),
    "generic_no_count": ({"TASK_INDEX": "0"}, (), (0, 1)),
    "slurm_no_count": ({"SLURM_ARRAY_TASK_ID": "3"}, (), ValueError),
    "explicit_half": ({}, (1, None), ValueError),
    "explicit_out_of_range": ({}, (4, 4), ValueError),
}


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_task_identity_precedence_matches_jax(case, monkeypatch):
    env, args, want = ENV_CASES[case]
    for var in ("SLURM_ARRAY_TASK_ID", "SLURM_ARRAY_TASK_COUNT",
                "TASK_ID_OFFSET", "TASK_INDEX", "TASK_COUNT"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    if want is ValueError:
        messages = []
        for mod in (tsharding, jsharding):
            with pytest.raises(ValueError) as err:
                mod.task_identity(*args)
            messages.append(str(err.value))
        assert messages[0] == messages[1]
    else:
        assert tsharding.task_identity(*args) == jsharding.task_identity(
            *args) == want


def test_stats_match_jax():
    rng = np.random.default_rng(0)
    for labels, k in (([0, 2, 1], 4), ([1, 1], None), ([], None)):
        np.testing.assert_array_equal(tstats.one_hot(labels, k),
                                      jstats.one_hot(labels, k))
    for bad in ([-1], [5]):
        for mod in (tstats, jstats):
            with pytest.raises(ValueError):
                mod.one_hot(bad, 3)
    p = rng.random(50) ** 3
    np.testing.assert_array_equal(tstats.benjamini_hochberg(p),
                                  jstats.benjamini_hochberg(p))
    p[::7] = np.nan
    for alpha in (0.05, 0.2):
        for got, want in zip(tstats.benjamini_hochberg_with_nulls(p, alpha),
                             jstats.benjamini_hochberg_with_nulls(p, alpha)):
            np.testing.assert_array_equal(got, want)
    for args in ((18, 20, 20, 1000), (0, 20, 20, 1000), (3, 9, 40, 120)):
        assert tstats.fisher_enrichment(*args) == \
            jstats.fisher_enrichment(*args)
    a = rng.normal(size=(20, 3))
    x = np.c_[a, a[:, 0] + a[:, 1], a[:, 2] * 2, rng.normal(size=20)]
    np.testing.assert_array_equal(tstats.drop_redundant_columns(x),
                                  jstats.drop_redundant_columns(x))
    assert tstats.drop_redundant_columns(x).shape == (20, 4)


# ---------------------------------------------------------------- verbs

def _run(pkg, argv):
    """(exit code, stdout) of the package's CLI `main` in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = (pmain if pkg == "port" else jmain)([*map(str, argv)])
    return rc, buf.getvalue()


def test_corpus_verbs_write_what_jax_writes(corpus, tmp_path):
    """create-uniref-db (one shard with its meta CSV; a two-task array),
    merge-uniref-dbs and create-h5 through each package's `main`."""
    out = {}
    for k in PKGS:
        d = tmp_path / k
        d.mkdir()
        common = ["--uniref-xml", corpus["xml"], "--go-meta", corpus["go"]]
        assert _run(k, ["create-uniref-db", *common, "--output-db",
                        d / "one.db", "--go-meta-csv", d / "one.csv",
                        "--records-limit", 300])[0] == 0
        for i in range(2):
            assert _run(k, ["create-uniref-db", *common, "--output-db",
                            d / "u.db", "--task-index", i,
                            "--task-count", 2])[0] == 0
        assert _run(k, ["merge-uniref-dbs", "--output-db", d / "u.db",
                        "--num-shards", 2, "--go-meta", corpus["go"],
                        "--go-meta-csv", d / "u.csv"])[0] == 0
        assert _run(k, ["create-h5", "--db", d / "u.db", "--fasta",
                        corpus["gappy"], "--go-meta-csv", d / "u.csv",
                        "--output", d / "u.h5", "--min-records",
                        MIN_RECORDS])[0] == 0
        out[k] = (chip_smoke.sqlite_rows(str(d / "one.db")),
                  (d / "one.csv").read_bytes(),
                  sorted(p.name for p in d.iterdir()),
                  chip_smoke.sqlite_rows(str(d / "u.db")),
                  (d / "u.csv").read_bytes(), _h5_contents(d / "u.h5"))
    assert out["port"] == out["jax"]
    assert "u.shard1of2.db" in out["port"][2]


@pytest.mark.parametrize("argv", [
    ["merge-uniref-dbs", "--output-db", "{d}/x.db"],
    ["merge-uniref-dbs", "--output-db", "{d}/x.db", "--num-shards", "2"],
    ["merge-uniref-dbs", "--output-db", "{db}", "--shards", "{db}",
     "--go-meta-csv", "{d}/m.csv"],
], ids=["no-shards", "missing-shards", "csv-without-obo"])
def test_corpus_verb_refusals_match_jax(corpus, tmp_path, argv):
    messages = []
    for k in PKGS:
        d = tmp_path / k
        d.mkdir()
        args = [a.format(d=d, db=corpus["db"]) for a in argv]
        if "{db}" in argv[2]:   # merging into a copy, not the fixture
            args[2] = str(d / "merged.db")
        with pytest.raises(SystemExit) as err:
            _run(k, args)
        messages.append(str(err.value).replace(str(d), "<d>"))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("data", [False, True], ids=["synthetic", "hdf5"])
def test_data_bench_prints_the_jax_lines(corpus, tmp_path, data):
    """Both packages' data-bench, the same variants, keys and counts; the
    bucketed iterator with --data (the `long` preset's path)."""
    extra = ["--set", "data.batch_size=4", "--set", "data.seq_len=64"]
    if data:
        h5 = tmp_path / "c.h5"
        jetl.create_h5_dataset(corpus["db"], corpus["gappy"], corpus["meta"],
                               str(h5), min_records_to_keep_annotation=
                               MIN_RECORDS, verbose=False)
        extra += ["--data", h5, "--set", "data.buckets=[32,64]"]
    else:
        extra += ["--set", "model.num_annotations=64"]
    lines = {}
    for k in PKGS:
        rc, text = _run(k, ["data-bench", "--preset", "tiny", "--batches", 4,
                            *extra])
        assert rc == 0
        lines[k] = [json.loads(ln) for ln in text.splitlines()
                    if ln.startswith("{")]
    for k in PKGS:
        assert [(ln["variant"], sorted(ln), ln["batches"])
                for ln in lines[k]] == [
            ("direct", ["batch_ms", "batches", "batches_per_sec",
                        "residues_per_sec", "variant"], 4),
            ("prefetch", ["batch_ms", "batches", "batches_per_sec",
                          "residues_per_sec", "variant"], 4)]
        assert all(ln["batches_per_sec"] > 0 for ln in lines[k])


# ---------------------------------------------------------------- copies

@pytest.mark.parametrize("module", [
    "etl/__init__.py", "etl/fasta.py", "etl/genome.py", "etl/go_ontology.py",
    "etl/h5_builder.py", "etl/uniref_parser.py", "utils/sharding.py",
    "utils/stats.py"])
def test_copies_differ_from_jax_only_in_docstrings_and_imports(module):
    want = (ROOT / "proteinbert_tpu" / module).read_text()
    got = (ROOT / "proteinbert_tpu_torch" / module).read_text()
    assert _body(got) == _body(want)
    # The imports say the same, re-pointed to the port.
    def imports(src):
        return sorted(ast.unparse(n) for n in ast.walk(ast.parse(src))
                      if isinstance(n, (ast.Import, ast.ImportFrom)))
    assert imports(got) == sorted(
        s.replace("proteinbert_tpu.", "proteinbert_tpu_torch.")
        for s in imports(want))


def test_etl_exports_match_jax():
    assert set(tetl.__all__) == set(jetl.__all__)
    assert tetl.GO_ANNOTATION_CATEGORIES == jetl.GO_ANNOTATION_CATEGORIES
    assert RECORDS and _make_xml(RECORDS).count("<entry ") == len(RECORDS)
