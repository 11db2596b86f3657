"""``python -m repro_torch.experiment`` — alias for ``python -m repro_torch.experiment.cli``."""

from repro_torch.experiment.cli import main

if __name__ == "__main__":
    main()
