"""The benchmark's door into the program (``arcnerf_torch``) for the VolSDF
configuration, beside ``port.py``'s for NGP and ``port_neus.py``'s for
NeuS: the program's parameter of each leaf of ``reference/volsdf.py``, its
trainer over the benchmark's views and weights, a watch on the sampler's
output, and the names of the dense GEMM kernels (cuBLAS) its plain f32
chains launch. Nothing here imports JAX.
"""

from . import port

# the device operations of a dense f32 matmul (cuBLAS's GEMM, GEMV and split-K
# reduction kernels), by parts of their names, lower case
GEMM_PARTS = ("gemm", "gemv", "splitkreduce")


def is_gemm(name):
    low = name.lower()
    return any(p in low for p in GEMM_PARTS)


def names(spec):
    """The program's parameter of each leaf of ``reference/volsdf.py``."""
    out = {"ln_beta": "fg_model.ln_beta"}
    for net, module, dims in (("geo", "geo_net", spec.geo_dims()), ("rad", "radiance_net", spec.rad_dims())):
        for i in range(len(dims)):
            out["{}.{}".format(net, i)] = "fg_model.{}.fc_{}".format(module, i)
            out["{}.{}.b".format(net, i)] = "fg_model.{}.fc_{}_bias".format(module, i)
            out["{}.{}.wn".format(net, i)] = "fg_model.{}.wn_{}".format(module, i)
    return out


def leaves_of(model, spec):
    params = dict(model.named_parameters())
    return {k: params[name] for k, name in names(spec).items()}


def trainer(tree, device, seed, expr_dir, views, leaves, spec, val=()):
    """As ``port.trainer``, for the VolSDF model: the trainer over the
    benchmark's views, starting from ``leaves``."""
    import torch

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
    params = dict(t.model.named_parameters())
    with torch.no_grad():
        for k, name in names(spec).items():
            params[name].copy_(leaves[k])
    return t


def watch_samples(trainer, record):
    """Hand each call's samples (the sampler's output, (rays, n_sample +
    n_importance)) to ``record``; returns the function that stops. Graph
    replays call no Python: watch eager calls only."""
    fg = trainer.model.fg_model
    inner = fg.upsample_zvals

    def wrapper(*args, **kwargs):
        out = inner(*args, **kwargs)
        record(out[0])
        return out

    fg.upsample_zvals = wrapper
    return lambda: delattr(fg, "upsample_zvals")
