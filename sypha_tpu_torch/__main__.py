"""``python -m sypha_tpu_torch``: the CLI entry point (reference src/main.cpp)."""

import sys

from sypha_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
