"""One run of one cell of the port's benchmark (``arcnerf_torch`` on NVIDIA
GPUs).

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--rehearse]

The cell is a ``workloads`` entry of ``BENCHMARK.json``; everything that
belongs to it is found by name: its traffic in ``workloads/<cell>.json``
(the driver that runs it, its parameters, the limits of its check), its
configuration in the file ``BENCHMARK.json`` names, and each per-layer
metric's reader in ``metrics/<metric>.py`` or its family's
``metrics/<family>.py``. With ``--trace 0`` the run
measures the cell's end-to-end metrics over a window of ``--seconds``;
with ``--trace 1`` it profiles a short window instead and reports the
per-layer metrics, ``busy_s``, ``window_s`` and the breakdown. Either way
it then frees the program and runs the plain reference against what the
window produced, prints each number compared beside its limit as its last
lines on standard error, and prints the result as one JSON line last on
standard output.

It needs a CUDA device: without one (or with fewer than the cell asks
for) it exits 2 and prints no result. ``--rehearse`` runs the same path on
the CPU at tiny sizes, with the kernels' plain versions; its numbers are no
measurement and its device says so. The tiny sizes come in four layers,
each a block of dotted keys applied over the one before: ``rehearsal.json``'s
``config`` block, each key only where the configuration's ``run`` tree
already holds that path (a key never adds a subtree, so a configuration
without a hash grid or a volume bound keeps its shape); the configuration
file's own ``rehearse`` block; ``rehearsal.json``'s ``traffic`` block named
by the cell's driver; the workload file's own ``rehearse`` block.

What a new cell brings, none of it an edit to a file already here: its
entries in ``BENCHMARK.json``; ``workloads/<cell>.json``; for a new model,
its configuration file (with a ``rehearse`` block of its tiny sizes) and
its plain reference; for new traffic code, ``drivers/<driver>.py``, whose
``DRIVER(ctx)`` has ``setup``, ``window``, ``traced``, ``free`` and
``reference``; a reader ``metrics/<metric>.py`` for each new per-layer
metric. ``Ctx`` assumes no model family: ``ctx.spec``, the NGP reference's
sizes, is built only when a driver reads it.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the JAX package and its stack: a run whose process holds any of them once the window has closed measured more than
# the port, and prints no result
REFERENCE_STACK = ("jax", "jaxlib", "flax", "arcnerf_tpu")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _set_caches():
    """Kernel caches at fixed paths inside the checkout: only a checkout's
    first run builds."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")


def _dotted_set(tree, dotted, value):
    keys = dotted.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _dotted_has(tree, dotted):
    for k in dotted.split("."):
        if not isinstance(tree, dict) or k not in tree:
            return False
        tree = tree[k]
    return True


def load_cell(name, rehearse=False):
    """(benchmark, cell entry, configuration file's tree, workload file's
    tree), the rehearsal's tiny sizes applied where asked."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit("no workload named {} in BENCHMARK.json".format(name))
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "workloads", name + ".json")) as f:
        workload = json.load(f)
    if workload["config"] != cell["config"]:
        raise SystemExit("workloads/{}.json runs {}, BENCHMARK.json says {}".format(name, workload["config"],
                                                                                  cell["config"]))
    if rehearse:
        with open(os.path.join(HERE, "rehearsal.json")) as f:
            tiny = json.load(f)
        for k, v in tiny["config"].items():
            if _dotted_has(config["run"], k):
                _dotted_set(config["run"], k, v)
        for k, v in config.get("rehearse", {}).items():
            _dotted_set(config["run"], k, v)
        for k, v in tiny["traffic"].get(workload["driver"], {}).items():
            _dotted_set(workload["traffic"], k, v)
        for k, v in workload.get("rehearse", {}).items():
            _dotted_set(workload["traffic"], k, v)
    return bench, cell, config, workload


def reader(name):
    """The module of ``metrics/<name>.py``, or else of the reader of the
    name's family, ``metrics/<the name up to its first dot>.py``: one reader
    serves ``mfu.train`` and ``mfu.serve``, whose declarations
    ``BENCHMARK.json`` alone holds."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location("bench_torch.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench, cell, kind):
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports, as BENCHMARK.json lists them."""
    if kind == "end_to_end":
        return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
    moves = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")}
    return [m for m in bench[kind] if cell in m.get("workloads", [cell] if m["moves"] in moves else [])]


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


class Ctx:
    """What a driver needs of the run."""

    def __init__(self, args, config, workload, device):
        import torch

        from bench_torch import trace

        self.torch, self.trace = torch, trace
        self.seed = args.seed
        self.config, self.workload, self.device = config["run"], workload, device
        self.model = self.config["model"]

    @functools.cached_property
    def spec(self):
        """The NGP reference's sizes (``reference.ngp.Spec``), which only
        a hash-grid configuration has: built when a driver first reads it."""
        from bench_torch.reference import ngp

        return ngp.Spec(self.model)

    @staticmethod
    def note(text):
        print(text, file=sys.stderr, flush=True)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    @staticmethod
    def clock():
        return time.perf_counter()

    def profiled(self, sink):
        return self.trace.profiled(sink)


def main(argv=None, out=None):
    out = out or sys.stdout
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rehearse", action="store_true", help="the CPU rehearsal at tiny sizes (no measurement)")
    args = parser.parse_args(argv)
    _set_caches()
    bench, cell, config, workload = load_cell(args.workload, args.rehearse)

    import torch

    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print("bench: {} needs {} CUDA device(s); found {}".format(
                args.workload, cell["chips"], torch.cuda.device_count() if torch.cuda.is_available() else 0),
                file=sys.stderr)
            return 2
        device = torch.device("cuda:0")
        torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from bench_torch import check

    ctx = Ctx(args, config, workload, device)
    card = card_line() if device.type == "cuda" else None
    if card:
        ctx.note("card: " + card)
    driver = getattr(importlib.import_module("bench_torch.drivers." + workload["driver"]), "DRIVER")(ctx)
    driver.setup()
    ctx.sync()
    setup_s = time.perf_counter() - _START
    reading, e2e = {}, {}
    if args.trace:
        attempted, failed = driver.traced(reading)
    else:
        e2e, attempted, failed = driver.window(args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    driver.free()
    numbers = driver.reference()
    correct, shown = check.verdict(numbers, workload["limits"])
    correct = correct and failed == 0
    loaded = sorted(set(REFERENCE_STACK) & {m.split(".")[0] for m in list(sys.modules)})
    if loaded:
        print("bench: the run loaded {}, not the port alone; no result".format(", ".join(loaded)), file=sys.stderr)
        return 3

    metrics = {}
    if args.trace:
        for m in cell_metrics(bench, args.workload, "per_layer"):
            value = reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                         "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu (rehearsal)",
                         "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}}
    if args.trace:
        result["device"].update(busy_s=reading["busy_s"], window_s=reading["window_s"])
        result["breakdown"] = reading["breakdown"]
    if card:
        result["card"] = card
    result["check"] = shown
    for k, v in shown.items():
        print("check {}: {} (limit {})".format(k, repr(v["value"]), repr(v["limit"])), file=sys.stderr)
    print("check correct: {}".format(correct), file=sys.stderr, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
