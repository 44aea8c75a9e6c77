"""``python -m slam_indoor_code_tpu_torch <config.json>`` (see cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
