"""`python -m grail_tpu_torch` runs the CLI (see cli.py)."""

import sys

from .cli import main

sys.exit(main())
