"""Dense-row pretraining: loss, optimizer chain, train state and steps,
FLOP/step-time accounting and the `pretrain` loop — the port of
`proteinbert_tpu/train/` without checkpointing, meshes and telemetry."""
