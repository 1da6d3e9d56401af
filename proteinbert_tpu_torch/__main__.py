"""`python -m proteinbert_tpu_torch <command>` (cli/main.py)."""

import sys

from proteinbert_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
