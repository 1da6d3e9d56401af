"""The model — the port of `proteinbert_tpu/models/`: the ProteinBERT
trunk and its pretraining heads (`proteinbert.py`) and the fine-tuning
heads (`finetune.py`). The names are the JAX package's."""

from proteinbert_tpu_torch.models import finetune, proteinbert

__all__ = ["finetune", "proteinbert"]
