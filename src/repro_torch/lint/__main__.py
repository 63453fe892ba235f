"""Entry point: ``python -m repro_torch.lint`` (see lint/cli.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
