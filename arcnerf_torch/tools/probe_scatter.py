"""Scatter-add forms at the hash-grid backward's scale on the card: the
counterpart of ``scripts/probe_scatter.py``.

The NGP recipe's table gradient (kernel E) adds 2^18 points x 8 corners x
16 levels = 2^25 updates into 16 x 2^19 = 2^23 entries a feature plane.
The cases, each with the JAX script's letter:

  a   kernel I (scalar atomics, W = 1) beside plain ``index_add_`` (the
      script's ``.at[].add``)
  b   plain sort + segment sum (``torch.sort``, ``unique_consecutive``,
      ``segment_reduce``): the script's ``sort_key_val`` + ``segment_sum``
  b2  the segment sum alone on presorted keys
  d   row form: one level's 2^21 updates as (2^21, 128) rows into an
      (8192, 128) table, through kernel I (float4 atomics) and
      ``index_add_``; the rows are built once, outside the timing
  e   the lane gather (8, 2048) with a per-row index, kernel H against
      ``torch.gather``; e2 the same at (8, 2^19)
  f   the dense level: 2^18 updates into 64^3 = 262,144 entries. The JAX
      script sums them by a one-hot bf16 einsum, which in PyTorch would
      materialise a 2^18 x 262,144 matrix; the port computes the same sum
      (bf16-rounded updates, f32 accumulation) through kernel I.

Case c of the JAX script, a cost probe of an unfinished sort-merge
pipeline that builds no table, is not ported. Kernel I and the sort form
must agree with ``index_add_`` within 1e-5 x max|ref| (f32 sums in another
order), H bit for bit; ``main`` raises after printing if one does not.

Run: ``python -m arcnerf_torch.tools.probe_scatter [--device cuda:0]``.
"""

import sys

import torch

from . import agrees, device_label, generator, max_abs_err, parse_device, print_table, time_ms
from ..ops.gather_scatter import lane_gather, lane_gather_reference, scatter_add_rows, scatter_add_rows_reference

L, T = 16, 1 << 19
N = (1 << 18) * 8 * L  # 2^25 corner updates
ROW_N = (1 << 18) * 8  # case d: one level's updates
LANE_M, LANE_W = 8, 2048  # case e; e2 is (LANE_M, T)
DENSE_N, DENSE_T = 1 << 18, 64 ** 3  # case f
TOL = 1e-5
REPS = 20


def segment_sum_sorted(sk, sv, n_table):
    """Sum of ``sv`` per run of equal sorted keys ``sk``, placed into a zero
    (n_table,) table."""
    keys, counts = torch.unique_consecutive(sk, return_counts=True)
    out = torch.zeros((n_table,), dtype=sv.dtype, device=sv.device)
    out[keys.long()] = torch.segment_reduce(sv, "sum", lengths=counts)
    return out


def sort_segment_sum(idx, g, n_table):
    sk, order = torch.sort(idx)
    return segment_sum_sorted(sk, g[order], n_table)


def _case(route, run, plain, tol, dev, ref=None):
    """Run, check against ``plain()`` (or ``ref`` when there is no plain
    version to time) and time one case."""
    out, want = run(), (plain() if ref is None else ref)
    res = {"kernel": route, "ok": agrees(out, want, tol), "max_abs_err": max_abs_err(out, want),
           "ms": time_ms(run, dev, REPS)}
    if plain is not None:
        res["plain_ms"] = time_ms(plain, dev, REPS)
    return res


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    print("device:", device_label(dev))
    gen = generator(dev)
    n_table = L * T
    idx = torch.randint(0, n_table, (N,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn((N, 1), generator=gen, device=dev)
    results = {}

    def zeros(rows, w=1):
        return torch.zeros((rows, w), device=dev)

    results["a"] = _case("I", lambda: scatter_add_rows(zeros(n_table), idx, g),
                         lambda: scatter_add_rows_reference(zeros(n_table), idx, g), TOL, dev)
    ref_a = scatter_add_rows_reference(zeros(n_table), idx, g)[:, 0]
    g_flat = g[:, 0]
    results["b"] = _case("plain", lambda: sort_segment_sum(idx, g_flat, n_table), None, TOL, dev, ref=ref_a)
    sk, order = torch.sort(idx)
    sv = g_flat[order]
    results["b2"] = _case("plain", lambda: segment_sum_sorted(sk, sv, n_table), None, TOL, dev, ref=ref_a)
    del ref_a, sk, sv, order

    # d: lane = 2 * (entry % 64) of row entry // 64, the JAX script's row form
    idx_l = torch.randint(0, T, (ROW_N,), generator=gen, device=dev, dtype=torch.int32)
    g_l = torch.randn((ROW_N,), generator=gen, device=dev)
    rows = torch.div(idx_l, 64, rounding_mode="floor")
    lanes = torch.arange(128, device=dev, dtype=torch.int32)[None, :]
    updates = torch.where(lanes == ((idx_l % 64) * 2)[:, None], g_l[:, None], 0.0)
    results["d"] = _case("I", lambda: scatter_add_rows(zeros(T // 64, 128), rows, updates),
                         lambda: scatter_add_rows_reference(zeros(T // 64, 128), rows, updates), TOL, dev)
    del updates

    for name, width in (("e", LANE_W), ("e2", T)):
        src = torch.randn((LANE_M, width), generator=gen, device=dev)
        gidx = torch.randint(0, width, (LANE_M, width), generator=gen, device=dev, dtype=torch.int32)
        results[name] = _case("H", lambda: lane_gather(src, gidx), lambda: lane_gather_reference(src, gidx), 0.0,
                              dev)

    idx_f = idx_l[:DENSE_N] % DENSE_T
    g_f = g_l[:DENSE_N].to(torch.bfloat16).float()[:, None]
    results["f"] = _case("I", lambda: scatter_add_rows(zeros(DENSE_T), idx_f, g_f),
                         lambda: scatter_add_rows_reference(zeros(DENSE_T), idx_f, g_f), TOL, dev)

    what = {
        "a": "scatter-add {} -> {} entries, W=1".format(N, n_table),
        "b": "sort + segment sum, same sum",
        "b2": "segment sum alone on presorted keys",
        "d": "row form: {} rows of 128 -> ({}, 128)".format(ROW_N, T // 64),
        "e": "lane gather ({}, {}), per-row idx".format(LANE_M, LANE_W),
        "e2": "lane gather ({}, {}), per-row idx".format(LANE_M, T),
        "f": "dense level: {} bf16 updates -> {} entries".format(DENSE_N, DENSE_T),
    }
    print_table(("case", "what", "route", "vs index_add_ / gather", "max abs err", "ms", "plain ms"), [
        (k, what[k], r["kernel"], "OK" if r["ok"] else "WRONG", "{:.3e}".format(r["max_abs_err"]),
         "{:.4f}".format(r["ms"]), "{:.4f}".format(r["plain_ms"]) if "plain_ms" in r else "-")
        for k, r in results.items()])
    wrong = [k for k, r in results.items() if not r["ok"]]
    if wrong:
        raise AssertionError("probe_scatter: disagreement with the plain version in cases {}".format(wrong))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
