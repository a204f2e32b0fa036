"""Kernel J (``csrc/update_rows.cu``, the lane-packed update rows) on the
CPU: a numpy model of its lane arithmetic and of its launch plan, and its
``scatter_add_`` yardstick, each held against the plain version
``build_update_rows_reference``.

- the lane arithmetic: each of a row's 32 lanes sums its 4 floats from 0,
  term by term, adding the term's value where d = lane0 + term lane - 4 x
  lane names the float and 0 elsewhere; bit for bit the plain version, with
  overlapping terms and terms outside [0, 128);
- the launch plan: rounds of at most the rows the SMs' shared memory holds,
  a block an SM, each block's two input ranges widened to 16-byte bounds:
  every row is written once, and a block's shared memory fits its inputs
  at any 4-byte offset. The constants are read from the kernel's source;
- the yardstick (``probe_cons_forms.build_scatter_add``, which
  ``chip_smoke.py`` times beside the kernel) equals the plain version
  where each row's term lanes are distinct and in [0, 128).
"""

import re

import numpy as np
import pytest
import torch

from arcnerf_torch.ops import cuda_lib
from arcnerf_torch.ops import gather_scatter as gs
from arcnerf_torch.tools.probe_cons_forms import build_scatter_add, scatter_add_index

SOURCE = cuda_lib.CSRC / "update_rows.cu"
CONSTANTS = {name: int(value) for name, value in
             re.findall(r"^constexpr int (\w+) = (\d+);", SOURCE.read_text(), re.M)}
H100_SMS, H100_SMEM = 132, 232448  # SMs and the opt-in shared memory a block may use
# term count -> (offsets, n_feat), as the card tests take them
TERMS = {1: ((0,), 1), 2: ((0, 2), 1), 3: ((0, 5, 9), 1), 4: ((0, 2), 2), 5: ((0,), 5), 6: ((0, 2, 62), 2),
         7: ((0,), 7), 8: ((0, 2, 62, 64), 2)}

torch.set_num_threads(1)


def _inputs(k, n_terms, seed, low=0, high=60):
    rng = np.random.default_rng(seed)
    lane0 = rng.integers(low, high, k).astype(np.int32)
    vals = rng.random((k, n_terms), dtype=np.float32)
    return lane0, vals


def model_lanes(lane0, vals, offs, n_feat):
    """The kernel's sums in numpy f32: (K, 32 lanes, 4 floats) -> (K, 128)."""
    term_lanes = [off + f for off in offs for f in range(n_feat)]
    lanes = np.arange(32, dtype=np.int64)[None, :]
    acc = np.zeros((lane0.shape[0], 32, 4), np.float32)
    for t, term in enumerate(term_lanes):
        d = lane0.astype(np.int64)[:, None] + term - 4 * lanes
        for c in range(4):
            acc[:, :, c] = acc[:, :, c] + np.where(d == c, vals[:, t:t + 1], np.float32(0))
    return acc.reshape(lane0.shape[0], 128)


def launch_plan(k, n_terms, n_sm=H100_SMS, most_smem=H100_SMEM):
    """The launcher's rounds: [(begin, end, rows a block, blocks, shared
    bytes a block)], as ``launch`` in the kernel's source computes them."""
    row_bytes = 4 + 4 * n_terms
    round_rows = (most_smem - CONSTANTS["kHead"] - CONSTANTS["kSlack"]) // row_bytes * n_sm
    plan, begin = [], 0
    while begin < k:
        n = min(round_rows, k - begin)
        per_block = -(-n // n_sm)
        plan.append((begin, begin + n, per_block, -(-n // per_block),
                     CONSTANTS["kHead"] + CONSTANTS["kSlack"] + per_block * row_bytes))
        begin += n
    return plan


def widened(start, nbytes):
    """A byte range widened to 16-byte bounds, as the kernel loads it."""
    lo = start & ~15
    return lo, (start + nbytes + 15) & ~15


def test_constants_are_read_from_the_kernel():
    assert CONSTANTS["kWarps"] == 16 and CONSTANTS["kHead"] >= 8 and CONSTANTS["kSlack"] >= 2 * 2 * 15


@pytest.mark.parametrize("n_terms", sorted(TERMS))
def test_lane_model_is_the_plain_version(n_terms):
    # exact: a float of a lane adds 0 for every term that misses it, which
    # leaves an f32 sum that started at +0 unchanged, so each float is the
    # plain version's sum of its hits in term order
    offs, n_feat = TERMS[n_terms]
    lane0, vals = _inputs(3000, n_terms, 70 + n_terms, low=-70, high=200)
    want = gs.build_update_rows_reference(torch.from_numpy(lane0), torch.from_numpy(vals), offs, n_feat).numpy()
    np.testing.assert_array_equal(model_lanes(lane0, vals, offs, n_feat), want)


def test_lane_model_sums_overlapping_terms_in_order():
    # offsets (0, 1), F = 2: two terms of a row on one lane, summed in order
    lane0, vals = _inputs(3000, 4, 80, low=-3, high=130)
    vals = (vals * 1e4).astype(np.float32) + np.float32(1e-3)  # sums that round
    want = gs.build_update_rows_reference(torch.from_numpy(lane0), torch.from_numpy(vals), (0, 1), 2).numpy()
    np.testing.assert_array_equal(model_lanes(lane0, vals, (0, 1), 2), want)


@pytest.mark.parametrize("k", [1, 31, 33, 777, 1 << 19, 1 << 20, 3_000_001])
@pytest.mark.parametrize("n_terms", sorted(TERMS))
def test_launch_plan_writes_every_row_once_within_shared_memory(k, n_terms):
    plan = launch_plan(k, n_terms)
    covered = 0
    for begin, end, per_block, blocks, smem in plan:
        assert begin == covered and blocks <= H100_SMS and smem <= H100_SMEM
        covered = end
        for b in range(blocks):
            rows = min(per_block, end - begin - b * per_block)
            assert rows > 0
            for offset in (0, 4, 8, 12):  # the inputs at any 4-byte offset
                a_lo, a_hi = widened(offset + (begin + b * per_block) * 4, rows * 4)
                b_lo, b_hi = widened(offset + (begin + b * per_block) * n_terms * 4, rows * n_terms * 4)
                assert a_lo % 16 == 0 and a_hi % 16 == 0 and b_lo % 16 == 0 and b_hi % 16 == 0
                assert CONSTANTS["kHead"] + (a_hi - a_lo) + (b_hi - b_lo) <= smem
    assert covered == k
    # the probe's shapes fit one round; quad's terms at 2^20 rows take two
    if k in (1 << 19, 1 << 20) and n_terms <= 6 or k <= 777:
        assert len(plan) == 1
    if k == 1 << 20 and n_terms == 8:
        assert len(plan) == 2


@pytest.mark.parametrize("offs,n_feat", [((0, 2, 62, 64), 2), ((0, 2), 2), ((0, 1), 1)])
def test_scatter_add_yardstick_is_the_plain_version(offs, n_feat):
    # exact where a row's term lanes are distinct and in [0, 128): each
    # lane holds 0 + its one value, as the plain version's sum does
    lane0, vals = _inputs(4096, len(offs) * n_feat, 90)
    lane0, vals = torch.from_numpy(lane0), torch.from_numpy(vals)
    got = build_scatter_add(scatter_add_index(lane0, offs, n_feat), vals)
    assert torch.equal(got, gs.build_update_rows_reference(lane0, vals, offs, n_feat))
