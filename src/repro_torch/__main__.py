"""``python -m repro_torch`` — the quantization pipeline CLI (pipeline/cli.py)."""
import sys

from .pipeline.cli import main

if __name__ == "__main__":
    sys.exit(main())
