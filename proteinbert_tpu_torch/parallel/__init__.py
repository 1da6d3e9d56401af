"""Parallelism and quantization — port of `proteinbert_tpu/parallel/`. So
far: the serving half of `quant.py` (the int8 serving arm)."""
