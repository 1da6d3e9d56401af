"""Offline ETL: UniRef90 XML → SQLite → HDF5 (reference C1-C4, rebuilt) —
the port's copy of `proteinbert_tpu/etl/`, host-only (no tensor).

Pipeline (mirrors the reference's two CLI stages, reference
create_uniref_db.py / creare_uniref_h5_db.py):
  1. parse_obo(go.txt) → GoOntology (DAG + ancestor closure)
  2. UnirefToSqliteParser: uniref90.xml.gz → protein_annotations SQLite
     (shardable across a task array; merge_shard_dbs recombines)
  3. create_h5_dataset: SQLite + indexed FASTA → one HDF5 file the
     training feed reads (data/dataset.py HDF5PretrainingDataset)
"""

from proteinbert_tpu_torch.etl.fasta import FastaReader, build_index, iter_fasta
from proteinbert_tpu_torch.etl.genome import GenomeReader
from proteinbert_tpu_torch.etl.go_ontology import (
    GoOntology,
    GoTerm,
    load_meta_csv,
    parse_obo,
    save_meta_csv,
)
from proteinbert_tpu_torch.etl.h5_builder import (
    create_h5_dataset,
    load_seqs_and_annotations,
)
from proteinbert_tpu_torch.etl.uniref_parser import (
    GO_ANNOTATION_CATEGORIES,
    UnirefToSqliteParser,
    merge_shard_dbs,
    read_aggregates,
)

__all__ = [
    "FastaReader", "GenomeReader", "build_index", "iter_fasta",
    "GoOntology", "GoTerm", "parse_obo", "save_meta_csv", "load_meta_csv",
    "create_h5_dataset", "load_seqs_and_annotations",
    "UnirefToSqliteParser", "merge_shard_dbs", "read_aggregates",
    "GO_ANNOTATION_CATEGORIES",
]
