"""Two trees of the repository compared on one card, in turns: the serving
frame and the profiled training step of each.

Usage (from the root of a checkout, on a machine with an NVIDIA GPU):

    python -m arcnerf_torch.tools.ab_step --trees <parent> . . <parent>

Each tree is a checkout of the repository, for example the parent commit
unpacked by ``git archive`` into a git-ignored directory. The distinct trees
first build their kernel libraries, all at once. Then each listed run, in
order and in a process of its own started at its tree's root, times the host
work a launch of each kernel's wrapper (this checkout's
``chip_smoke.launch_path`` on the tree's wrappers), renders the 800x800
serving frame (this checkout's ``chip_smoke.serve``, which also captures
the compacted stream of the chunk that crosses the spheres, on which the
tree's kernel C is then held and timed from a CUDA graph), times the
tree's kernel I at 2^25 -> 2^23, W=1, from a CUDA graph beside
``index_add_`` (``chip_smoke.compare_scatter_w1``), and trains the recipe
(``chip_smoke.train(profile=True)``: 400 steps with their gates, 100 timed
steps, a profile of 4 more), then holds the tree's kernels B, C and F
against their plain versions on the streams one more training step hands
them, each timed from a CUDA graph. Every run profiles, captures those
streams and times them with this checkout's ``chip_smoke`` functions
(``profile_steps``, ``capture_training_streams``,
``compare_hash_encode_stream``, ``compare_march_stream``), so every tree's
kernels are measured the same way. Each run's output follows a header
naming it; the lines that carry the comparison are repeated at the end.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]

# builds and loads the tree's kernels: the binding module where the tree has
# one (``cuda_lib.ops``), else its ctypes library
BUILD = ("from arcnerf_torch.ops import cuda_lib; print('build seconds', cuda_lib.build()); "
         "getattr(cuda_lib, 'ops', cuda_lib.lib)()")
RUN = """
import importlib.util, os, sys
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke
spec = importlib.util.spec_from_file_location("chip_smoke_profile", {smoke!r})
profiler = importlib.util.module_from_spec(spec)
spec.loader.exec_module(profiler)
chip_smoke.profile_steps = profiler.profile_steps
torch.backends.cuda.matmul.allow_tf32 = False
for row in profiler.launch_path(torch.device("cuda:0"), torch.Generator(device="cuda:0").manual_seed(0))[1]:
    print(row)
for d in (chip_smoke.OUT_DIR, chip_smoke.WORK_DIR, profiler.OUT_DIR, profiler.WORK_DIR):
    os.makedirs(d, exist_ok=True)
_, serving = profiler.serve(torch.device("cuda:0"))
for row in profiler.compare_serving_chunk(serving)[0]:
    print(row)
del serving
print(profiler.compare_scatter_w1(torch.device("cuda:0"), torch.Generator(device="cuda:0").manual_seed(0)))
chip_smoke.capture_hash_encode_bwd_stream = profiler.capture_training_streams  # the name in trees before it
stream = chip_smoke.train(profile=True)[1]
for row in profiler.compare_hash_encode_stream(stream)[0] + profiler.compare_march_stream(stream["march"])[0]:
    print(row)
"""
# the lines of a run that the comparison reads
KEYS = ("launch path", "render 800x800", "train ", "one step,", "held-out view", "steady steps", "profile of",
        "profile per step by kernel", "B hash_encode training stream", "compositing stream",
        "C segment_march captured", "C segment_march serving", "F segment_march_bwd captured",
        "I scatter_add_rows W=1")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", required=True, help="tree roots, in the order of the runs")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_step: CUDA is not available")
    trees = [str(Path(t).resolve()) for t in args.trees]
    builds = [(tree, subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)) for tree in dict.fromkeys(trees)]
    for tree, proc in builds:
        report = proc.communicate()[0]
        print("build {}: {}".format(tree, report.strip()[-2000:]), flush=True)
        if proc.returncode != 0:
            raise SystemExit("ab_step: the build of {} failed".format(tree))
    summary = []
    for i, tree in enumerate(trees):
        print("=== run {} of {}: {}".format(i + 1, len(trees), tree), flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN.format(smoke=str(ROOT / "chip_smoke.py"))], cwd=tree,
                              capture_output=True, text=True)
        print(proc.stdout, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
            raise SystemExit("ab_step: run {} ({}) failed".format(i + 1, tree))
        summary += ["[run {} {}] {}".format(i + 1, tree, line) for line in proc.stdout.splitlines()
                    if line.startswith(KEYS)]
    print("=== summary")
    print("\n".join(summary))


if __name__ == "__main__":
    main()
