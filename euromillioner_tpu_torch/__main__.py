"""``python -m euromillioner_tpu_torch`` → the CLI."""

import sys

from euromillioner_tpu_torch.cli import main

sys.exit(main())
