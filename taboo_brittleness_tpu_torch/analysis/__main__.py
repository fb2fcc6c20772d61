"""``python -m taboo_brittleness_tpu_torch.analysis`` — the port's tbx-check gate."""

import sys

from taboo_brittleness_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
