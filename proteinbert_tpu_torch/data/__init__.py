"""The data pipeline — the port of `proteinbert_tpu/data/`: the vocabulary
(`vocab.py`), tokenization and crops (`transforms.py`), the pretraining
corruption (`corruption.py`), the in-memory and HDF5 datasets with their
iterators (`dataset.py`, h5py imported only by the HDF5 reader) and
packing (`packing.py`). The names are the JAX package's."""

from proteinbert_tpu_torch.data.vocab import (
    ALPHABET,
    PAD_ID,
    SOS_ID,
    EOS_ID,
    UNK_ID,
    VOCAB_SIZE,
    N_SPECIAL,
    Vocab,
    get_vocab,
)
from proteinbert_tpu_torch.data.transforms import (
    tokenize,
    tokenize_batch,
    random_crop,
    crop_starts,
    epoch_crop_seed,
    splitmix64,
)
from proteinbert_tpu_torch.data.corruption import (
    randomize_tokens,
    corrupt_annotations,
    corrupt_batch,
    corrupt_packed_batch,
    packed_weights,
    pretrain_weights,
)
from proteinbert_tpu_torch.data.dataset import (
    InMemoryPretrainingDataset,
    HDF5PretrainingDataset,
    make_bucketed_iterator,
    make_pretrain_iterator,
    Subset,
    train_eval_split,
)
from proteinbert_tpu_torch.data.packing import (
    PackPlanner,
    make_packed_iterator,
    pack_rows,
    unpack_segments,
)

__all__ = [
    "ALPHABET", "PAD_ID", "SOS_ID", "EOS_ID", "UNK_ID", "VOCAB_SIZE",
    "N_SPECIAL", "Vocab", "get_vocab",
    "tokenize", "tokenize_batch", "random_crop",
    "crop_starts", "epoch_crop_seed", "splitmix64",
    "randomize_tokens", "corrupt_annotations", "corrupt_batch",
    "corrupt_packed_batch", "packed_weights", "pretrain_weights",
    "InMemoryPretrainingDataset", "HDF5PretrainingDataset",
    "make_bucketed_iterator", "make_pretrain_iterator",
    "Subset", "train_eval_split",
    "PackPlanner", "make_packed_iterator", "pack_rows", "unpack_segments",
]
