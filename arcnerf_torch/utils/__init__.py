"""Host utilities: configs, registries, logging, checkpoints."""
