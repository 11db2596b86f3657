"""``python -m repro_torch.gym`` -> the gym CLI."""

import sys

from repro_torch.gym.cli import main

if __name__ == "__main__":
    main(sys.argv[1:])
