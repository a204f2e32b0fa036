"""The benchmark's door into the program (``arcnerf_torch``) for the NeuS
configurations, beside ``port.py``'s for NGP: the program's parameter of
each NeuS leaf, its trainer over the benchmark's views and weights, the
names of the kernels NeuS adds (K and L of PERF.md's table), and a watch on
the occupancy update's points. Nothing here imports JAX.
"""

import torch

from . import port

# the program's parameter of each leaf of reference/neus.py
NAMES = {"table": "fg_model.geo_net.encoder.embeddings", "geo.0": "fg_model.geo_net.fc_0",
         "geo.0.wn": "fg_model.geo_net.wn_0", "geo.out": "fg_model.geo_net.fc_1",
         "geo.out.wn": "fg_model.geo_net.wn_1", "rad.0": "fg_model.radiance_net.mlp.fc_0",
         "rad.1": "fg_model.radiance_net.mlp.fc_1", "rad.out": "fg_model.radiance_net.mlp.fc_out",
         "inv_s": "fg_model.inv_s"}

# the hash grid's input gradient (K) and its backward (L), as the profiler names them
SDF_KERNELS = {"K": "hash_dx_kernel", "L": "hash_dx_bwd_kernel"}


def sdf_kernel_of(name):
    """"K" or "L" for a device operation of those kernels, else None."""
    for key, part in SDF_KERNELS.items():
        if part + "<" in name:
            return key
    return None


def load_leaves(model, leaves):
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, name in NAMES.items():
            params[name].copy_(leaves[k])


def leaves_of(model):
    params = dict(model.named_parameters())
    return {k: params[name] for k, name in NAMES.items()}


def ema_of(trainer):
    """The trainer's EMA shadows (not debiased) by leaf name."""
    return {k: trainer.ema[name] for k, name in NAMES.items()}


def trainer(tree, device, seed, expr_dir, views, leaves, val=()):
    """As ``port.trainer``, for a NeuS model: the trainer over the
    benchmark's views, starting from ``leaves``."""
    from arcnerf_torch.trainer import ArcNerfTrainer
    from arcnerf_torch.trainer.pipeline import Pipeline
    from arcnerf_torch.utils.cfgs import get_value_from_cfgs_field

    class BenchTrainer(ArcNerfTrainer):
        def prepare_data(self):
            sched = get_value_from_cfgs_field(self.cfgs.dataset.train, "scheduler", None)
            self.pipeline = Pipeline(sched, int(get_value_from_cfgs_field(self.cfgs, "n_rays", 4096)), self.device)
            self.pipeline.process_train_data(views)
            return {"val": list(val)} if val else {}

    t = BenchTrainer(port.cfgs(tree, device, seed, expr_dir))
    load_leaves(t.model, leaves)
    return t


def watch_occupancy(trainer, record):
    """Hand the points of each occupancy estimate (the NeuS model's
    ``get_est_opacity``) to ``record``; returns the function that stops."""
    fg = trainer.model.fg_model
    inner = fg.get_est_opacity

    def wrapper(dt, pts):
        record(pts.detach())
        return inner(dt, pts)

    fg.get_est_opacity = wrapper
    return lambda: delattr(fg, "get_est_opacity")
