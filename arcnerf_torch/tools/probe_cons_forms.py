"""Update-row construction forms on the card: the counterpart of
``scripts/probe_cons_forms.py``.

The TPU's hash-table backward built, per level, (K, 128) f32 rows holding
each update at its lane (``lane0 + off + f``) and scatter-added them into a
lane-packed table. The JAX probe timed four ways to build the rows; here:

  A  ``build_update_rows_reference``: a sum of ``torch.where(lanes ==
     lane0 + off + f, val, 0)`` terms (the XLA form ``build_A``)
  B  the same with d = lanes - lane0 computed once (``build_B``)
  C  select-free: (d == off + f) * val products summed (``build_C``)
  P  kernel J, one warp per row, each row written once (``build_P``)

for the pair geometry (K = 2^20 rows, offsets (0, 2)) and the quad geometry
(K = 2^19, offsets (0, 2, 62, 64)), F = 2, 11 levels per timed call. Each
form is timed alone ("cons") and with the scatter tail that adds the rows
into a (16384, 128) table (``+scatter``): plain ``index_add_`` after A, B
and C, kernel I after P. Every form must equal A bit for bit on the first
level, and kernel I's tail must agree with ``index_add_`` within 1e-5 x
max|ref|; ``main`` raises after printing if one does not.

Run: ``python -m arcnerf_torch.tools.probe_cons_forms [--device cuda:0]``.
"""

import sys

import torch

from . import agrees, device_label, generator, max_abs_err, parse_device, print_table, time_ms
from ..ops.gather_scatter import (LANES, build_update_rows, build_update_rows_reference, scatter_add_rows,
                                  scatter_add_rows_reference)

LH = 11  # levels a call builds
R0 = 16384  # rows of the lane-packed table
F = 2
GEOMETRIES = (("pair", 1 << 20, (0, 2)), ("quad", 1 << 19, (0, 2, 62, 64)))
TOL = 1e-5
REPS = 4


def _lane_offsets(lane0):
    return torch.arange(LANES, dtype=lane0.dtype, device=lane0.device)[None, :] - lane0[:, None]


def build_b(lane0, vals, offs, n_feat):
    d = _lane_offsets(lane0)
    out = torch.zeros(d.shape, dtype=torch.float32, device=lane0.device)
    for i, off in enumerate(offs):
        for f in range(n_feat):
            out = out + torch.where(d == off + f, vals[:, i * n_feat + f][:, None], 0.0)
    return out


def build_c(lane0, vals, offs, n_feat):
    d = _lane_offsets(lane0)
    out = torch.zeros(d.shape, dtype=torch.float32, device=lane0.device)
    for i, off in enumerate(offs):
        for f in range(n_feat):
            out = out + (d == off + f).float() * vals[:, i * n_feat + f][:, None]
    return out


FORMS = (("A", build_update_rows_reference, scatter_add_rows_reference), ("B", build_b, scatter_add_rows_reference),
         ("C", build_c, scatter_add_rows_reference), ("P", build_update_rows, scatter_add_rows))


def run_geometry(dev, k_rows, offs):
    gen = generator(dev)
    nv = len(offs) * F
    lane0s = torch.randint(0, 60, (LH, k_rows), generator=gen, device=dev, dtype=torch.int32)
    es = torch.randint(0, R0, (LH, k_rows), generator=gen, device=dev, dtype=torch.int32)
    vals = torch.rand((LH, k_rows, nv), generator=gen, device=dev)
    want = build_update_rows_reference(lane0s[0], vals[0], offs, F)
    tail_ref = scatter_add_rows_reference(torch.zeros((R0, LANES), device=dev), es[0], want)
    tail = scatter_add_rows(torch.zeros((R0, LANES), device=dev), es[0], want)
    out = {"scatter_tail": {"ok": agrees(tail, tail_ref, TOL), "max_abs_err": max_abs_err(tail, tail_ref)}}
    del tail, tail_ref
    for form, build, scatter in FORMS:
        first = build(lane0s[0], vals[0], offs, F)
        ok = agrees(first, want, 0.0)
        del first

        def cons_only():
            acc = torch.zeros((), device=dev)
            for lvl in range(LH):
                acc += build(lane0s[lvl], vals[lvl], offs, F).sum()
            return acc

        def cons_scatter():
            acc = torch.zeros((), device=dev)
            for lvl in range(LH):
                u = build(lane0s[lvl], vals[lvl], offs, F)
                acc += scatter(torch.zeros((R0, LANES), device=dev), es[lvl], u).sum()
            return acc

        out[form] = {"ok": ok, "cons_ms": time_ms(cons_only, dev, REPS),
                     "cons_scatter_ms": time_ms(cons_scatter, dev, REPS)}
    return out


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    print("device:", device_label(dev))
    results, rows = {}, []
    for name, k_rows, offs in GEOMETRIES:
        res = results[name] = run_geometry(dev, k_rows, offs)
        for form, _, _ in FORMS:
            r = res[form]
            rows.append(("{} (K={}, {} terms)".format(name, k_rows, len(offs) * F), form,
                         "OK" if r["ok"] else "WRONG", "{:.4f} ({:.4f}/lvl)".format(r["cons_ms"], r["cons_ms"] / LH),
                         "{:.4f} ({:.4f}/lvl)".format(r["cons_scatter_ms"], r["cons_scatter_ms"] / LH)))
        tail = res["scatter_tail"]
        print("{}: kernel I scatter tail vs index_add_: {} (max abs err {:.3e})".format(
            name, "OK" if tail["ok"] else "WRONG", tail["max_abs_err"]))
    print_table(("geometry", "form", "vs A", "cons ms", "+scatter ms"), rows)
    wrong = [(g, f) for g, res in results.items() for f, r in res.items() if not r["ok"]]
    if wrong:
        raise AssertionError("probe_cons_forms: disagreement in {}".format(wrong))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
