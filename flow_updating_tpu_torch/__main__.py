"""``python -m flow_updating_tpu_torch`` — the CLI entry point."""

import sys

from flow_updating_tpu_torch.cli import main

sys.exit(main())
