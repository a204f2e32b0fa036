"""Gather and scatter cases on the card: the counterpart of
``scripts/probe_pallas_gather.py`` and ``scripts/probe_pallas_gather2.py``.

The JAX probes asked which in-kernel gather/scatter forms Mosaic lowers on
the TPU. On the card every form is one of three kernels, so each case keeps
its name and runs through the kernel that computes what it computes, held
against the plain PyTorch version on the same inputs and timed beside it:

  kernel G (row gather, ``table[idx]``): case_taa0, case_ref_vec,
      case_scalar_loop (64 rows), case_onehot (the one-hot bf16 matmul is
      bf16(table)[idx] exactly, so G gathers the bf16 table and widens),
      case_a, case_c, case_e (a row permutation with repeats), case_f,
      loop_gather (2^21 rows from a (2^19, 128) f32 table, 1 GiB out)
  kernel H (lane gather, ``table_1d[:, idx]``): case_take_1d, case_taa1,
      case_b, case_d (one index row shared by the 8 rows)
  kernel I (row scatter-add): case_scatter_ref, which means
      ``np.add.at(zeros, idx, g)``; in Pallas interpret mode its body keeps
      one update per repeated index instead

G and H must be bit-identical to plain, I within 1e-5 x max|plain| (f32
atomics add in another order). The XLA parts stay plain PyTorch: the
key-value sort and the cumsum of 2^25 values, and the row gather of 2^19
rows outside any kernel (``index_select``). ``main`` raises after printing
if a case disagrees.

Run: ``python -m arcnerf_torch.tools.probe_gather [--device cuda:0]``.
"""

import sys

import torch

from . import agrees, device_label, generator, max_abs_err, parse_device, print_table, time_ms
from ..ops.gather_scatter import (lane_gather, lane_gather_reference, row_gather, row_gather_reference,
                                  scatter_add_rows, scatter_add_rows_reference)

T, N, W = 2048, 1024, 128  # the probes' table rows, indices and lanes
WIDE_ROWS = 8  # table_1d / table_wide: (8, T)
SCALAR_LOOP_ROWS = 64
LOOP_T, LOOP_N = 1 << 19, 1 << 21  # loop_gather
XLA_ROWS = 1 << 19  # the JAX script's XLA row gather
SORT_N, SORT_RANGE = (1 << 18) * 16 * 8, (1 << 19) * 16  # sort and cumsum at the hash-grid backward's size
I_TOL = 1e-5
REPS = 20


def inputs(dev):
    """The probes' tensors, drawn from a seeded generator on ``dev``."""
    gen = generator(dev)
    x = {"table": torch.randn((T, W), generator=gen, device=dev),
         "table_wide": torch.randn((WIDE_ROWS, T), generator=gen, device=dev),
         "idx": torch.randint(0, T, (N,), generator=gen, device=dev, dtype=torch.int32),
         "src": torch.randn((N, W), generator=gen, device=dev),
         "perm": torch.randint(0, N, (N,), generator=gen, device=dev, dtype=torch.int32),
         "g": torch.randn((N, W), generator=gen, device=dev),
         "big_table": torch.randn((LOOP_T, W), generator=gen, device=dev)}
    x["big_idx"] = torch.randint(0, LOOP_T, (LOOP_N,), generator=gen, device=dev, dtype=torch.int32)
    return x


def cases(x):
    """(name, JAX source, kernel, run kernel, run plain, tolerance) per case
    on the tensors of ``inputs``."""
    table, table_wide, idx = x["table"], x["table_wide"], x["idx"]
    table_bf16 = table.to(torch.bfloat16)
    p1, p2 = "scripts/probe_pallas_gather.py", "scripts/probe_pallas_gather2.py"

    def rows(tab, ids):
        return ("G", lambda: row_gather(tab, ids), lambda: row_gather_reference(tab, ids), 0.0)

    def lanes(tab, ids):
        return ("H", lambda: lane_gather(tab, ids), lambda: lane_gather_reference(tab, ids), 0.0)

    def zeros():
        return torch.zeros((T, W), device=table.device)

    return [
        ("case_take_1d", p1 + ":40") + lanes(table_wide[:1], idx[None]),
        ("case_taa0", p1 + ":55") + rows(table, idx),
        ("case_taa1", p1 + ":71") + lanes(table_wide, idx[None]),
        ("case_ref_vec", p1 + ":87") + rows(table, idx),
        ("case_scalar_loop", p1 + ":102") + rows(table, idx[:SCALAR_LOOP_ROWS]),
        ("case_onehot", p1 + ":124", "G", lambda: row_gather(table_bf16, idx).float(),
         lambda: row_gather_reference(table_bf16, idx).float(), 0.0),
        ("case_scatter_ref", p1 + ":142", "I", lambda: scatter_add_rows(zeros(), idx, x["g"]),
         lambda: scatter_add_rows_reference(zeros(), idx, x["g"]), I_TOL),
        ("case_a", p2 + ":42") + rows(table, idx),
        ("case_b", p2 + ":57") + lanes(table_wide, idx[None]),
        ("case_c", p2 + ":72") + rows(table, idx),
        ("case_d", p2 + ":88") + lanes(table_wide, idx[None]),
        ("case_e", p2 + ":104") + rows(x["src"], x["perm"]),
        ("case_f", p2 + ":123") + rows(table, idx),
        ("loop_gather", p2 + ":171") + rows(x["big_table"], x["big_idx"]),
    ]


def xla_probes(dev, big_table, big_idx):
    """The XLA parts of the probes as plain PyTorch: times only."""
    gen = generator(dev, 1)
    keys = torch.randint(0, SORT_RANGE, (SORT_N,), generator=gen, device=dev, dtype=torch.int32)
    payload = torch.randn((SORT_N,), generator=gen, device=dev)

    def sort_key_val():
        sk, order = torch.sort(keys)
        return sk, payload[order]

    head = big_idx[:XLA_ROWS]
    return {"sort_key_val": time_ms(sort_key_val, dev, REPS),
            "cumsum": time_ms(lambda: torch.cumsum(payload, 0), dev, REPS),
            "xla_row_gather": time_ms(lambda: torch.index_select(big_table, 0, head), dev, REPS)}


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    print("device:", device_label(dev))
    x = inputs(dev)
    results, table = {}, []
    for name, source, kernel, run, plain, tol in cases(x):
        out, ref = run(), plain()
        ok = agrees(out, ref, tol)
        res = {"kernel": kernel, "source": source, "ok": ok, "max_abs_err": max_abs_err(out, ref),
               "ms": time_ms(run, dev, REPS), "plain_ms": time_ms(plain, dev, REPS)}
        results[name] = res
        table.append((name, source, kernel, "OK" if ok else "WRONG", "{:.3e}".format(res["max_abs_err"]),
                      "{:.4f}".format(res["ms"]), "{:.4f}".format(res["plain_ms"])))
    xla = xla_probes(dev, x["big_table"], x["big_idx"])
    print_table(("case", "JAX source", "kernel", "vs plain", "max abs err", "kernel ms", "plain ms"), table)
    print("plain sort (key, value) of {} int32 keys: {:.4f} ms".format(SORT_N, xla["sort_key_val"]))
    print("plain cumsum of {} f32: {:.4f} ms".format(SORT_N, xla["cumsum"]))
    print("plain row gather (index_select) of {} rows x {} f32: {:.4f} ms".format(
        XLA_ROWS, W, xla["xla_row_gather"]))
    results.update({k: {"plain_ms": v} for k, v in xla.items()})
    wrong = [name for name, res in results.items() if res.get("ok") is False]
    if wrong:
        raise AssertionError("probe_gather: the kernel disagrees with its plain version in {}".format(wrong))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
