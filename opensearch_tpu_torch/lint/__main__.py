"""Entry point for ``python -m opensearch_tpu_torch.lint``."""

import sys

from opensearch_tpu_torch.lint.cli import main

sys.exit(main())
