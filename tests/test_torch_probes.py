"""The gather/scatter probes and the roofline tool: the port's kernels G-J
(their plain PyTorch versions on the CPU) and tools against the JAX probes
and numpy, on the same inputs.

- update rows (kernel J): ``build_P`` of ``scripts/probe_cons_forms.py``
  in Pallas interpret mode and its XLA forms ``build_A/B/C`` against the
  port's forms, exactly;
- ``pallas_vmem_gather_attempt`` of ``tools/roofline_hashgrid.py`` in
  interpret mode;
- the gather/scatter cases (kernels G, H, I), whose Pallas kernels are
  closures inside the scripts' ``main``: held against the numpy reference
  each case compares with itself;
- ``case_scatter_ref``'s kernel body in interpret mode, which keeps one
  update per repeated index where its reference ``np.add.at`` sums them;
- each tool's ``main`` on ``--device cpu`` at reduced sizes, and its
  refusal to run without CUDA otherwise.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from arcnerf_torch.ops import gather_scatter as gs
from arcnerf_torch.tools import ab_step, probe_cons_forms, probe_gather, probe_scatter, roofline_hashgrid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GEOMETRIES = {"pair": (0, 2), "quad": (0, 2, 62, 64)}  # probe_cons_forms.py, F = 2
T, N, W = 2048, 1024, 128  # the gather probes' shapes

torch.set_num_threads(1)


def _load(rel_path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel_path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` in interpret mode, as the JAX package's own
    CPU tests run Pallas."""
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(jax.experimental.pallas.pallas_call, interpret=True))


def _update_inputs(offs, k=4096, seed=0):
    rng = np.random.default_rng(seed)
    lane0 = rng.integers(0, 60, k).astype(np.int32)
    vals = rng.random((k, len(offs) * 2), dtype=np.float32)
    return lane0, vals


@pytest.mark.parametrize("form", ["A", "B", "C", "P"])
@pytest.mark.parametrize("geometry", ["pair", "quad"])
def test_jax_update_row_forms_match_port_reference(interpret, geometry, form):
    # exact: each lane holds at most one term (lane0 < 60, offsets <= 64),
    # summed from 0 in the same order; P is the Pallas kernel in interpret mode
    probe = _load("scripts/probe_cons_forms.py", "probe_cons_forms_jax")
    assert callable(probe._pallas_kernel)
    offs = GEOMETRIES[geometry]
    lane0, vals = _update_inputs(offs)
    build = {"A": probe.build_A, "B": probe.build_B, "C": probe.build_C, "P": probe.build_P}[form]
    want = np.asarray(build(jnp.asarray(lane0), [jnp.asarray(vals[:, j]) for j in range(vals.shape[1])], offs))
    got = gs.build_update_rows_reference(torch.from_numpy(lane0), torch.from_numpy(vals), offs, 2).numpy()
    assert got.shape == (4096, 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["wrapper", "B", "C"])
@pytest.mark.parametrize("geometry", ["pair", "quad"])
def test_port_update_row_forms_match_jax_build_a(geometry, form):
    # exact, as above: kernel J's wrapper on CPU tensors, and the tool's
    # forms B and C, against the JAX XLA form build_A
    probe = _load("scripts/probe_cons_forms.py", "probe_cons_forms_jax")
    offs = GEOMETRIES[geometry]
    lane0, vals = _update_inputs(offs, seed=1)
    want = np.asarray(probe.build_A(jnp.asarray(lane0), [jnp.asarray(vals[:, j]) for j in range(vals.shape[1])],
                                    offs))
    build = {"wrapper": gs.build_update_rows, "B": probe_cons_forms.build_b, "C": probe_cons_forms.build_c}[form]
    got = build(torch.from_numpy(lane0), torch.from_numpy(vals), offs, 2).numpy()
    np.testing.assert_array_equal(got, want)


def test_update_rows_reference_sums_overlapping_terms_in_order():
    # offsets (0, 1) with F = 2 put two terms on lane lane0 + 1: summed
    lane0 = torch.tensor([0, 5, 126], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 4.0, 8.0]] * 3)
    out = gs.build_update_rows_reference(lane0, vals, (0, 1), 2)
    assert out[0, :4].tolist() == [1.0, 6.0, 8.0, 0.0]
    assert out[1, 5:8].tolist() == [1.0, 6.0, 8.0]
    assert out[2, 126:].tolist() == [1.0, 6.0]  # the term past lane 127 is dropped
    assert float(out.sum()) == 3 * 15.0 - 8.0


def test_pallas_vmem_gather_attempt_compiles_in_interpret_mode(interpret):
    probe = _load("tools/roofline_hashgrid.py", "roofline_hashgrid_jax")
    assert probe.pallas_vmem_gather_attempt().startswith("COMPILES")


def _probe_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"table": rng.standard_normal((T, W), dtype=np.float32),
            "table_wide": rng.standard_normal((8, T), dtype=np.float32),
            "idx": rng.integers(0, T, N).astype(np.int32),
            "src": rng.standard_normal((N, W), dtype=np.float32),
            "perm": rng.integers(0, N, N).astype(np.int32),
            "g": rng.standard_normal((N, W), dtype=np.float32)}


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _add_at(n_rows, idx, g):
    out = np.zeros((n_rows,) + g.shape[1:], np.float32)
    np.add.at(out, idx, g)
    return out


def _numpy_case(name, a):
    """The numpy reference a probe case compares with, on arrays ``a``."""
    table, wide, idx = a["table"], a["table_wide"], a["idx"]
    if name == "case_take_1d":
        return wide[0][idx][None]
    if name in ("case_taa1", "case_b", "case_d"):
        return wide[:, idx]
    if name == "case_scalar_loop":
        return table[idx[:probe_gather.SCALAR_LOOP_ROWS]]
    if name == "case_onehot":
        return _bf16(table)[idx]
    if name == "case_scatter_ref":
        return _add_at(table.shape[0], idx, a["g"])
    if name == "case_e":
        return a["src"][a["perm"]]
    if name == "loop_gather":
        return a["big_table"][a["big_idx"]]
    return table[idx]  # case_taa0, case_ref_vec, case_a, case_c, case_f


PROBE_GATHER_CASES = ["case_take_1d", "case_taa0", "case_taa1", "case_ref_vec", "case_scalar_loop", "case_onehot",
                      "case_scatter_ref", "case_a", "case_b", "case_c", "case_d", "case_e", "case_f", "loop_gather"]


@pytest.mark.parametrize("case", PROBE_GATHER_CASES)
def test_probe_gather_case_on_cpu_matches_numpy(monkeypatch, case):
    # the tool's case on --device cpu at the probes' own shapes (loop_gather
    # cut to a 4096-row table): gathers exact, the scatter within 1e-5 of
    # the largest sum (np.add.at and index_add_ may add in another order)
    monkeypatch.setattr(probe_gather, "LOOP_T", 4096)
    monkeypatch.setattr(probe_gather, "LOOP_N", 8192)
    x = probe_gather.inputs(CPU)
    by_name = {c[0]: c for c in probe_gather.cases(x)}
    assert sorted(by_name) == sorted(PROBE_GATHER_CASES)
    _, _, _, run, plain, tol = by_name[case]
    got = run().numpy()
    want = _numpy_case(case, {k: v.numpy() for k, v in x.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()) if tol else 0)
    np.testing.assert_array_equal(plain().numpy(), got)


@pytest.mark.parametrize("case", ["row_gather_f32", "row_gather_bf16", "row_permutation", "lane_gather_shared",
                                  "lane_gather_per_row", "scatter_rows", "scatter_w1"])
def test_plain_versions_match_numpy_at_probe_shapes(case):
    # gathers exact; scatters within 1e-5 of the largest sum (summation order)
    a = _probe_arrays()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    rng = np.random.default_rng(2)
    if case == "row_gather_f32":
        got, want = gs.row_gather_reference(t["table"], t["idx"]), a["table"][a["idx"]]
    elif case == "row_gather_bf16":
        got = gs.row_gather_reference(t["table"].to(torch.bfloat16), t["idx"]).float()
        want = _bf16(a["table"])[a["idx"]]
    elif case == "row_permutation":
        got, want = gs.row_gather_reference(t["src"], t["perm"]), a["src"][a["perm"]]
    elif case == "lane_gather_shared":
        got, want = gs.lane_gather_reference(t["table_wide"], t["idx"][None]), a["table_wide"][:, a["idx"]]
    elif case == "lane_gather_per_row":
        gidx = rng.integers(0, T, (8, T)).astype(np.int32)
        got = gs.lane_gather_reference(t["table_wide"], torch.from_numpy(gidx))
        want = np.take_along_axis(a["table_wide"], gidx, axis=1)
    elif case == "scatter_rows":
        got = gs.scatter_add_rows_reference(torch.zeros((T, W)), t["idx"], t["g"])
        want = _add_at(T, a["idx"], a["g"])
    else:
        idx = rng.integers(0, 4096, 50000).astype(np.int32)
        g = rng.standard_normal((50000, 1), dtype=np.float32)
        got = gs.scatter_add_rows_reference(torch.zeros((4096, 1)), torch.from_numpy(idx), torch.from_numpy(g))
        want = _add_at(4096, idx, g)
    tol = 1e-5 * float(np.abs(want).max()) if case.startswith("scatter") else 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _scatter_ref_kernel(i_ref, g_ref, o_ref):
    # the body of case_scatter_ref (scripts/probe_pallas_gather.py:145-147)
    o_ref[:] = jnp.zeros_like(o_ref)
    o_ref[i_ref[:, 0]] += g_ref[:]


@pytest.mark.parametrize("repeats", [False, True])
def test_case_scatter_ref_body_in_interpret_mode(repeats):
    # duplicate-free indices: the Pallas body equals np.add.at (and the
    # port). With repeats it keeps one update per index, so it differs from
    # np.add.at, the probe's own reference, which the port computes
    a = _probe_arrays(3)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, T, N) if repeats else rng.permutation(T)[:N]
    idx = idx.astype(np.int32)
    assert (len(np.unique(idx)) < N) == repeats
    call = jax.experimental.pallas.pallas_call(
        _scatter_ref_kernel, out_shape=jax.ShapeDtypeStruct((T, W), jnp.float32),
        in_specs=[jax.experimental.pallas.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=jax.experimental.pallas.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    pallas = np.asarray(call(jnp.asarray(idx)[:, None], jnp.asarray(a["g"])))
    want = _add_at(T, idx, a["g"])
    port = gs.scatter_add_rows(torch.zeros((T, W)), torch.from_numpy(idx), torch.from_numpy(a["g"])).numpy()
    np.testing.assert_allclose(port, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    if repeats:
        assert np.abs(pallas - want).max() > 1e-2
    else:
        np.testing.assert_array_equal(pallas, want)


def test_sort_segment_sum_matches_add_at():
    # 1e-5 of the largest sum: segment sums in sorted order vs np.add.at
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 3000, 40000).astype(np.int32)
    g = rng.standard_normal(40000, dtype=np.float32)
    want = _add_at(4096, idx, g)
    got = probe_scatter.sort_segment_sum(torch.from_numpy(idx), torch.from_numpy(g), 4096).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    assert not got[3000:].any()


def test_roofline_resolutions_are_the_probes():
    want = [int(np.ceil(16 * (2048 / 16) ** (i / 15) - 1)) for i in range(16)]
    assert roofline_hashgrid.resolutions() == want


SMALL = {
    roofline_hashgrid: dict(B=512, L=4, T_LOG=10, SEQ_SHAPE=(4, 64, 64), MM_N=64, MM_ITERS=2, VMEM_T=256,
                            VMEM_N=512, LOOP_T=1024, LOOP_N=2048, REPS=1),
    probe_gather: dict(T=256, N=128, LOOP_T=512, LOOP_N=1024, XLA_ROWS=256, SORT_N=4096, SORT_RANGE=1024,
                       SCALAR_LOOP_ROWS=16, REPS=1),
    probe_scatter: dict(L=2, T=1024, N=4096, ROW_N=2048, LANE_W=256, DENSE_N=1024, DENSE_T=512, REPS=1),
    probe_cons_forms: dict(LH=2, R0=256, GEOMETRIES=(("pair", 1024, (0, 2)), ("quad", 512, (0, 2, 62, 64))), REPS=1),
}
ROWS = {
    roofline_hashgrid: {"seq_read", "gather_f32", "gather_bf16", "encode_mlp", "matmul_peak", "vmem_gather",
                        "l2_gather", "loop_gather", "megakernel_savable_mb"},
    probe_gather: set(PROBE_GATHER_CASES) | {"sort_key_val", "cumsum", "xla_row_gather"},
    probe_scatter: {"a", "b", "b2", "d", "e", "e2", "f"},
    probe_cons_forms: {"pair", "quad"},
}


@pytest.mark.parametrize("tool", list(SMALL), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tool_main_on_cpu_returns_every_row(monkeypatch, capsys, tool):
    for key, value in SMALL[tool].items():
        monkeypatch.setattr(tool, key, value)
    out = tool.main(["--device", "cpu"])
    assert set(out) == ROWS[tool]
    printed = capsys.readouterr().out
    assert "device: cpu" in printed and "WRONG" not in printed
    if tool is probe_cons_forms:
        for res in out.values():
            assert set(res) == {"scatter_tail", "A", "B", "C", "P"} and all(r["ok"] for r in res.values())
    elif tool is roofline_hashgrid:
        assert out["gather_bf16"]["gbs"] > 0 and out["megakernel_savable_mb"] == 512 * 4 * 2 * 4 * 2 / 1e6
    else:
        assert all(r.get("ok", True) for r in out.values())


@pytest.mark.parametrize("tool", list(SMALL), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tool_refuses_to_run_without_cuda(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main([])


def test_ab_step_refuses_to_run_without_cuda(monkeypatch):
    # it builds and times trees on the card only: no process starts here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        ab_step.main(["--trees", ".", "."])


@pytest.mark.parametrize("name", ["row_gather", "lane_gather", "scatter_add_rows", "build_update_rows"])
def test_wrapper_takes_plain_version_on_cpu_without_launching(name):
    wrapper = getattr(gs, name)
    # fresh inputs for each call: scatter_add_rows adds in place
    args = {"row_gather": lambda: (torch.arange(64.0).reshape(16, 4), torch.tensor([3, 3, 0], dtype=torch.int32)),
            "lane_gather": lambda: (torch.arange(32.0).reshape(2, 16), torch.tensor([[1, 5, 5]], dtype=torch.int32)),
            "scatter_add_rows": lambda: (torch.zeros(8, 4), torch.tensor([1, 1, 7], dtype=torch.int32),
                                         torch.ones(3, 4)),
            "build_update_rows": lambda: (torch.tensor([0, 60], dtype=torch.int32), torch.ones(2, 4), (0, 2), 2)}[name]
    launches = wrapper.launches
    got, want = wrapper(*args()), getattr(gs, name + "_reference")(*args())
    assert torch.equal(got, want) and wrapper.launches == launches
