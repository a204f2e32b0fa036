"""Measurement tools of the port, each the counterpart of a TPU study in the
repo and each run as ``python -m arcnerf_torch.tools.<name> [--device D]``:

- ``roofline_hashgrid`` (``tools/roofline_hashgrid.py``): sequential read
  bandwidth, kernel B's gather rate, encode + MLP, the bf16 matmul rate and
  kernel G's row-gather rate from an L2-resident and an HBM-resident table;
- ``probe_gather`` (``scripts/probe_pallas_gather.py`` and
  ``scripts/probe_pallas_gather2.py``): every gather/scatter case of the
  two probes through kernels G, H and I, sort and cumsum;
- ``probe_scatter`` (``scripts/probe_scatter.py``): the scatter-add forms at
  kernel E's scale (kernel I, ``index_add_``, sort + segment sum) and the
  lane gathers (kernel H);
- ``probe_cons_forms`` (``scripts/probe_cons_forms.py``): the update-row
  construction forms (kernel J against the XLA forms) and their scatter
  tail (kernel I).

Beside them, ``hash_streams`` makes the point streams that kernel E (the
hash-table scatter) is tested on: ray-ordered, one cell, padded.

Each tool prints a table and returns its numbers from ``main(argv)``. The
device defaults to ``cuda:0`` and a tool raises when CUDA is missing;
``--device cpu`` runs the kernels' plain versions at whatever size the
module constants give (the tests shrink them), and its times are the host's.
"""

import argparse
import time

import torch


def parse_device(argv, description):
    """``--device`` from ``argv`` -> torch.device; raises for a CUDA device
    when CUDA is not available."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0), or cpu for the plain versions")
    dev = torch.device(parser.parse_args(argv).device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run the plain versions on the CPU")
    return dev


def device_label(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions, host clock)"


def generator(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def time_ms(fn, dev, reps):
    """Mean ms per call over ``reps`` back-to-back calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def max_abs_err(out, ref):
    return float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0


def agrees(out, ref, rel_tol):
    """``rel_tol`` 0: bit-identical. Otherwise every |out - ref| <= rel_tol *
    max|ref| (sums in another order), and finite."""
    if rel_tol == 0:
        return out.shape == ref.shape and bool(torch.equal(out, ref))
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return bool(torch.isfinite(out).all()) and max_abs_err(out, ref) <= rel_tol * scale


def print_table(header, rows):
    print("| " + " | ".join(header) + " |")
    print("|" + "---|" * len(header))
    for row in rows:
        print("| " + " | ".join(str(v) for v in row) + " |")
