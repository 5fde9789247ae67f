import sys

from tpu_patterns_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
