"""Training CLI (reference train.py; counterpart of
`egotap_tpu/cli/train.py`, with its flags and presets).

    python -m egotap_tpu_torch.cli.train --preset egotap_unrealego \
        --data_dir /data/UnrealEgoData [--flag value ...]

Runs on the CUDA card; from Python, ``main(argv, device="cpu")`` runs
the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import sys

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.train.loop import run_training


def main(argv=None, device="cuda", epoch_callback=None) -> None:
    """Train the configuration ``argv`` gives (`Config.from_args`);
    ``epoch_callback`` as in `train.loop.train_main`."""
    cfg = Config.from_args(argv)
    run_training(cfg, epoch_callback=epoch_callback, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
