"""Training loop of the port (counterpart of ``arcnerf_tpu/trainer``)."""

from .trainer import ArcNerfTrainer  # noqa: F401
