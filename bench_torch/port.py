"""The benchmark's one door into the program (``arcnerf_torch``): build its
trainer and render engine from a configuration file's tree, hand them the
benchmark's traffic and weights, and name its kernels. Nothing else in the
benchmark imports the program, and nothing here imports JAX.
"""

import copy

import torch

# the program's parameter of each leaf
NAMES = {"table": "fg_model.coarse_geo_net.encoder.embeddings", "geo.0": "fg_model.coarse_geo_net.mlp.fc_0",
         "geo.out": "fg_model.coarse_geo_net.mlp.fc_out", "rad.0": "fg_model.coarse_radiance_net.mlp.fc_0",
         "rad.1": "fg_model.coarse_radiance_net.mlp.fc_1", "rad.out": "fg_model.coarse_radiance_net.mlp.fc_out"}

# the kernels as the profiler names them, by the letters of PERF.md's table
KERNELS = {"A": ("fused_mlp_fwd_kernel",), "B": ("hash_encode_fwd_kernel",), "C": ("segment_march_fwd_kernel",),
           "D": ("fused_mlp_bwd_kernel", "reduce_parts_kernel"), "E": ("hash_encode_bwd_kernel",),
           "F": ("segment_march_bwd_kernel",)}


def kernel_of(name):
    """The letter of a device operation's kernel, "adam" for the optimizer's,
    or None for the program's other (plain PyTorch) operations."""
    for key, parts in KERNELS.items():
        if any(p in name for p in parts):
            return key
    return "adam" if "adam" in name.lower() else None


def cfgs(tree, device, seed=None, expr_dir=None):
    from arcnerf_torch.utils.cfgs import dict_to_obj

    tree = copy.deepcopy(tree)
    tree["device"] = str(device)
    if seed is not None:
        tree.setdefault("dist", {})["random_seed"] = int(seed)
    if expr_dir is not None:
        tree.setdefault("dir", {})["expr_dir"] = expr_dir
    return dict_to_obj(tree)


def load_leaves(model, leaves):
    """Copy the benchmark's leaves into the program's parameters, in place."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, name in NAMES.items():
            params[name].copy_(leaves[k])


def leaves_of(model):
    params = dict(model.named_parameters())
    return {k: params[name] for k, name in NAMES.items()}


def trainer(tree, device, seed, expr_dir, views, leaves, val=()):
    """The program's trainer over the benchmark's training views (its ray
    pool) and validation views ``val`` (samples its ``valid_epoch``
    renders), starting from ``leaves``."""
    from arcnerf_torch.trainer import ArcNerfTrainer
    from arcnerf_torch.trainer.pipeline import Pipeline
    from arcnerf_torch.utils.cfgs import get_value_from_cfgs_field

    class BenchTrainer(ArcNerfTrainer):
        def prepare_data(self):
            sched = get_value_from_cfgs_field(self.cfgs.dataset.train, "scheduler", None)
            self.pipeline = Pipeline(sched, int(get_value_from_cfgs_field(self.cfgs, "n_rays", 4096)), self.device)
            self.pipeline.process_train_data(views)
            return {"val": list(val)} if val else {}

    t = BenchTrainer(cfgs(tree, device, seed, expr_dir))
    load_leaves(t.model, leaves)
    return t


def engine(tree, device, leaves, bitfield):
    """The program's render engine of a model holding ``leaves`` and the
    occupancy ``bitfield``."""
    from arcnerf_torch.models import build_model
    from arcnerf_torch.render.engine import RenderEngine

    c = cfgs(tree, device)
    model = build_model(c, generator=torch.Generator().manual_seed(0)).to(device)
    load_leaves(model, leaves)
    bound_state = model.init_bound_state(device)
    bound_state["fg"]["bitfield"].copy_(bitfield)
    return RenderEngine(model, c, bound_state, device)


def wrap_hash_encode(record):
    """Wrap the encoding's entry (``hash_encode``, kernel B on the card) so
    that each call hands its points to ``record``; returns the function
    that unwraps it. Graph replays call no Python: wrap eager work only."""
    from arcnerf_torch.models.base_modules import encoding

    inner = encoding.hash_encode

    def wrapper(xyz, *args, **kwargs):
        record(xyz.detach())
        return inner(xyz, *args, **kwargs)

    wrapper.launches = inner.launches  # the kernel's launch counter lives on this name
    encoding.hash_encode = wrapper

    def unwrap():
        inner.launches = wrapper.launches
        encoding.hash_encode = inner

    return unwrap
