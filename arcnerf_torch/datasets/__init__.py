"""Dataset registry (counterpart of ``arcnerf_tpu/datasets/__init__.py``).
Only the procedural ``Synthetic`` scene is registered so far."""

from ..utils.registry import DATASET_REGISTRY


def get_dataset(dataset_cfgs, dirs, mode="train", transforms=None, logger=None):
    """Build a dataset from cfgs.dataset.<mode> with ``type`` name."""
    mode_cfgs = getattr(dataset_cfgs, mode) if hasattr(dataset_cfgs, mode) else dataset_cfgs
    dataset_type = mode_cfgs.type
    dataset = DATASET_REGISTRY.get(dataset_type)(mode_cfgs, dirs, mode, transforms)
    if logger is not None:
        logger.add_log("{} dataset: {} ({} imgs, {}x{})".format(
            mode, dataset_type, len(dataset), dataset.W, dataset.H))
    return dataset


from . import synthetic_dataset  # noqa: F401, E402
