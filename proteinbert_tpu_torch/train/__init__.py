"""Pretraining: loss, optimizer chain, train state and steps, FLOP/step-time
accounting, the NaN halt and the `pretrain` loop — the port of
`proteinbert_tpu/train/` without checkpointing and telemetry."""
