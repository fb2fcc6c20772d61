import sys

from taboo_brittleness_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
