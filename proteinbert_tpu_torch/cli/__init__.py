"""The port's command line (`python -m proteinbert_tpu_torch <command>`),
the counterpart of `proteinbert_tpu/cli/`."""

from proteinbert_tpu_torch.cli.main import build_parser, main

__all__ = ["build_parser", "main"]
