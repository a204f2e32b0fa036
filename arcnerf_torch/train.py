"""Training entry of the port (counterpart of the repo's ``train.py``).

Usage:
    python -m arcnerf_torch.train --configs <cfg.yaml> [--device cuda:0] [--dotted.overrides ...]

Trains on ``device`` (default ``cuda:0``; ``--device cpu`` runs every
kernel's plain version) and writes checkpoints (``model_step{N}.pt``,
``latest.pt``, ``final.pt``) and ``train.log`` under ``dir.expr_dir``
(default ``experiments/<name>``). ``--resume <checkpoint.pt>`` continues a
run from its step, Adam state and occupancy state. A final checkpoint
loads in ``python -m arcnerf_torch.evaluate --model_pt``.

``--progress.scan_steps N`` (N > 1) runs strides of up to N steps that end
on every logging, validation, checkpoint, batch-size and occupancy event:
on the card each stride replays the training step captured as a CUDA graph
for its ray bucket (the bucket's first step runs eagerly, then the step is
captured), on the CPU the same static-buffer step runs directly. With the
same seed the result equals N = 1 up to the card's float atomics (bit for
bit on the CPU).
"""

import sys

from .trainer import ArcNerfTrainer
from .utils.cfgs import parse_configs


def main(argv=None):
    """Train from command-line style arguments; returns the trainer."""
    cfgs = parse_configs(sys.argv[1:] if argv is None else argv)
    return ArcNerfTrainer(cfgs).train()


if __name__ == "__main__":
    main()
