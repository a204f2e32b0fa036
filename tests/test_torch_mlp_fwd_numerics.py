"""Kernel A (``csrc/fused_mlp.cu``) modelled on the CPU against
``fused_mlp_reference``: its index mapping, and its summation order.

(a) A numpy model of the kernel's data movement, written from the same
index expressions as the source: the m16n8k16 fragment layouts of
``mma.sync`` (which lane and register hold which row and column of A, B and
C), ``ldmatrix(.trans)`` at the kernel's addresses, the weight staging
(rows of 72 bf16, the output block padded to 8 columns), the warp tile's
run of x copied into a shared-memory buffer, the hand-off from a layer's
accumulators to the next layer's A fragments, the XOR-swizzled staging of
``pre`` in that same buffer and the masked stores, with the persistent
warps' tile order and the buffers' reuse from tile to tile. Shared memory
starts as NaN bits, so a read of anything the kernel did not write shows.
Each layer's product is formed from the operands the fragments hold,
reassembled into matrices and multiplied the plain version's way (the same
matmul), so the model must equal ``fused_mlp_reference`` bit for bit.

(b) The kernel's summation order: each MMA adds the sum of its 16 exact
bf16 products to the f32 accumulator, one k-step after the other. Emulated
with the 16-product sums in float64 (the tensor core's own adds differ from
that only in the last f32 bits, far below a bf16 ulp), it stays within
2e-2 of the plain version and of the JAX Pallas forward, and it flips the
bf16 rounding of a small share of the out and pre values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcnerf_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from arcnerf_torch.ops.fused_mlp import _pads, fused_mlp_reference, pack_weights

torch.set_num_threads(1)

# the kernel's constants (csrc/fused_mlp.cu)
KW, KM, KROWS, KSTRIDE, KWARPS = 64, 2, 32, 72, 4
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3  # groupID and thread-in-group of the mma.sync layouts
NAN16, NAN8 = 0xFFFF, 0xFF  # bf16 NaN bits; a byte of f32 NaN bits

# mma.sync.m16n8k16 fragment layouts (PTX ISA): (register, half) -> row, column
def a_row(i):
    return G + 8 * (i & 1)


def a_col(i, h):
    return 2 * T + h + 8 * (i >> 1)


def b_k(i, h):
    return 2 * T + h + 8 * i


def c_row(e):
    return G + 8 * (e >> 1)


def c_col(e):
    return 2 * T + (e & 1)


def bf16_bits(v):
    """f32 -> bf16 bits, round to nearest even (__floats2bfloat162_rn)."""
    b = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_value(bits):
    return (np.asarray(bits, dtype=np.uint32) << 16).view(np.float32)


def ldmatrix(mem, addr, n_mat, trans):
    """ldmatrix.m8n8.x{n_mat}(.trans).b16 on the bf16 array ``mem`` with the
    lanes' row addresses ``addr`` (element offsets; lanes 8i..8i+7 give the
    rows of matrix i): (32 lanes, n_mat registers, 2 halves) bits."""
    assert np.all(addr[:8 * n_mat] % 8 == 0), "ldmatrix rows must be 16-byte aligned"
    out = np.empty((32, n_mat, 2), dtype=np.uint16)
    for i in range(n_mat):
        rows = addr[8 * i:8 * i + 8]
        for h in range(2):
            # plain: row lane/4, columns 2 (lane % 4) + h; .trans: the transpose
            out[:, i, h] = mem[rows[2 * T + h] + G] if trans else mem[rows[G] + 2 * T + h]
    return out


def stage_weights(packed, din, n_hidden, dout_pad):
    """stage_weights: the block's weight rows in shared memory."""
    nout = max(dout_pad, 8)
    ws = np.full((din + n_hidden * KW) * KSTRIDE, NAN16, dtype=np.uint16)
    rows64 = din + (n_hidden - 1) * KW
    e = np.arange(rows64 * KW // 8)
    for c in range(8):  # the 16-byte copies
        ws[(e >> 3) * KSTRIDE + 8 * (e & 7) + c] = packed[8 * e + c]
    e = np.arange(KW * nout)
    k, j = e // nout, e % nout
    src = packed[rows64 * KW + k * dout_pad + np.minimum(j, dout_pad - 1)]
    ws[rows64 * KSTRIDE + k * KSTRIDE + j] = np.where(j < dout_pad, src, 0)
    return ws


def b_fragments(ws, w_off, k_in, nt):
    """The B fragments `layer` loads for a layer whose rows start at w_off:
    [kk][pair of n-tiles] -> (32, 4, 2) (or [kk][0] -> (32, 2, 2) for one n-tile)."""
    q, r = LANE >> 3, LANE & 7
    frags = []
    for kk in range(k_in // 16):
        if nt == 1:
            frags.append([ldmatrix(ws, w_off + (16 * kk + (LANE & 15)) * KSTRIDE, 2, True)])
        else:
            frags.append([ldmatrix(ws, w_off + (16 * kk + r + (q & 1) * 8) * KSTRIDE + 8 * j + (q >> 1) * 8, 4, True)
                          for j in range(0, nt, 2)])
    return frags


def b_matrix(frags, k_in, nt):
    """Reassemble the (k_in, 8 nt) B operand from its fragments."""
    b = np.full((k_in, 8 * nt), np.nan, dtype=np.float32)
    for kk, row in enumerate(frags):
        for jp, f in enumerate(row):
            for jj in range(f.shape[1] // 2):  # n-tile 2 jp + jj: registers 2 jj, 2 jj + 1
                for i in range(2):
                    for h in range(2):
                        b[16 * kk + b_k(i, h), 8 * (2 * jp + jj) + G] = bf16_value(f[:, 2 * jj + i, h])
    return b


def layer(a, bmat, k_true, n_true):
    """`layer`: the warp tile's products from its A fragments a[m][kk] ->
    accumulators [m][nt] (32, 4). The operands are reassembled and
    multiplied as the plain version multiplies them; the columns past
    k_true of A and the rows past it of B must be exact zeros."""
    amat = np.full((KROWS, 16 * len(a[0])), np.nan, dtype=np.float32)
    for m in range(KM):
        for kk, f in enumerate(a[m]):
            for i in range(4):
                for h in range(2):
                    amat[16 * m + a_row(i), 16 * kk + a_col(i, h)] = bf16_value(f[:, i, h])
    assert np.all(amat[:, k_true:] == 0) and np.all(bmat[k_true:] == 0), "padding is not zero"
    assert np.all(bmat[:, n_true:] == 0) and np.isfinite(amat).all() and np.isfinite(bmat).all()
    z = (torch.from_numpy(amat[:, :k_true].copy()) @ torch.from_numpy(bmat[:k_true, :n_true].copy())).numpy()
    zp = np.zeros((KROWS, bmat.shape[1]), dtype=np.float32)
    zp[:, :n_true] = z
    return [[np.stack([zp[16 * m + c_row(e), 8 * j + c_col(e)] for e in range(4)], axis=1)
             for j in range(bmat.shape[1] // 8)] for m in range(KM)]


def load_x(x_flat, tile, n_rows, d_in, aligned16, dst):
    """load_x: the tile's run of n_valid d_in floats into the byte buffer dst,
    each element copied once, 16-byte copies only at 16-byte offsets."""
    row0 = tile * KROWS
    n = min(KROWS, n_rows - row0) * d_in
    src = x_flat[row0 * d_in:row0 * d_in + n]
    view = dst.view(np.float32)
    copied = np.zeros(n, dtype=int)
    e4 = n & ~3 if aligned16 else 0
    for lane in range(32):
        for e in range(4 * lane, e4, 128):
            assert (row0 * d_in + e) % 4 == 0
            view[e:e + 4] = src[e:e + 4]
            copied[e:e + 4] += 1
        for e in range(e4 + lane, n, 32):
            view[e] = src[e]
            copied[e] += 1
    assert np.all(copied == 1)


def x_frags(buf, n_valid, d_in, din):
    xs = buf.view(np.float32)
    frags = []
    for m in range(KM):
        row = []
        for kk in range(din // 16):
            f = np.empty((32, 4, 2), dtype=np.uint16)
            for i in range(4):
                r = 16 * m + a_row(i)
                for h in range(2):
                    c = 16 * kk + a_col(i, h)
                    ok = (r < n_valid) & (c < d_in)
                    f[:, i, h] = bf16_bits(np.where(ok, xs[np.where(ok, r * d_in + c, 0)], 0))
            row.append(f)
        frags.append(row)
    return frags


def to_a(acc):
    """to_a: k-step kk of the next layer from n-tiles 2 kk and 2 kk + 1."""
    out = []
    for m in range(KM):
        row = []
        for kk in range(4):
            f = np.empty((32, 4, 2), dtype=np.uint16)
            for i in range(4):
                c = acc[m][2 * kk + (i >> 1)]
                for h in range(2):
                    f[:, i, h] = bf16_bits(np.maximum(c[:, 2 * (i & 1) + h], 0))
            row.append(f)
        out.append(row)
    return out


def store_pre(acc, buf, pre_layer, row0, n_valid):
    """store_pre: staging (chunk c of row r at chunk c ^ (r & 7)), then whole
    rows out in 16-byte pieces."""
    sp = buf.view(np.uint16)
    written = np.zeros(KROWS * KW, dtype=int)
    for m in range(KM):
        for j in range(8):
            for h in range(2):
                r = 16 * m + G + 8 * h
                off = r * KW + ((j ^ G) << 3) + 2 * T
                assert np.all(off % 2 == 0)
                for s in range(2):
                    sp[off + s] = bf16_bits(acc[m][j][:, 2 * h + s])
                    np.add.at(written, off + s, 1)
    assert np.all(written == 1)
    for i in range(KROWS * KW // 8 // 32):
        e = LANE + 32 * i
        r, c = e >> 3, e & 7
        src = r * KW + ((c ^ (r & 7)) << 3)
        assert np.all(src % 8 == 0)
        for lane in np.nonzero(r < n_valid)[0]:
            pre_layer[row0 + r[lane], 8 * c[lane]:8 * c[lane] + 8] = sp[src[lane]:src[lane] + 8]


def store_out(acc, out, row0, n_valid, d_out, stored):
    for m in range(KM):
        for j, f in enumerate(acc[m]):
            for h in range(2):
                r, c = 16 * m + G + 8 * h, 8 * j + 2 * T
                for s in range(2):
                    sel = (r < n_valid) & (c + s < d_out)
                    out[row0 + r[sel], c[sel] + s] = bf16_value(bf16_bits(f[sel, 2 * h + s]))
                    np.add.at(stored, (row0 + r[sel], c[sel] + s), 1)


def kernel_model(x, weights, grid, aligned16=True, hand_off=to_a):
    """Kernel A with save_pre on x (n_rows, d_in) f32 and the f32 weights:
    (out f32, pre bf16 bits), ``grid`` persistent blocks of 4 warps.
    ``hand_off`` maps a layer's accumulators to the next layer's A
    fragments."""
    n_rows, d_in = x.shape
    d_out, n_hidden = weights[-1].shape[1], len(weights) - 1
    din, dout_pad = _pads(d_in, d_out)
    packed = pack_weights([torch.from_numpy(w) for w in weights], din, dout_pad, "cpu").view(torch.int16)
    ws = stage_weights(packed.numpy().view(np.uint16), din, n_hidden, dout_pad)
    nout = max(dout_pad, 8)
    b0 = b_matrix(b_fragments(ws, 0, din, 8), din, 8)
    bh = [b_matrix(b_fragments(ws, (din + (l - 1) * KW) * KSTRIDE, KW, 8), KW, 8) for l in range(1, n_hidden)]
    bo = b_matrix(b_fragments(ws, (din + (n_hidden - 1) * KW) * KSTRIDE, KW, nout // 8), KW, nout // 8)

    out = np.full((n_rows, d_out), np.nan, dtype=np.float32)
    pre = np.full((n_hidden, n_rows, KW), NAN16, dtype=np.uint16)
    stored, done = np.zeros((n_rows, d_out), dtype=int), []
    x_flat = x.reshape(-1)
    n_tiles = -(-n_rows // KROWS)
    step = grid * KWARPS
    for warp in range(step):  # the warps run independently: one after another here
        cur, nxt = (np.full(KROWS * din * 4, NAN8, dtype=np.uint8) for _ in range(2))
        tile = warp
        if tile < n_tiles:
            load_x(x_flat, tile, n_rows, d_in, aligned16, cur)
        while tile < n_tiles:
            if tile + step < n_tiles:
                load_x(x_flat, tile + step, n_rows, d_in, aligned16, nxt)
            row0 = tile * KROWS
            n_valid = min(KROWS, n_rows - row0)
            acc = layer(x_frags(cur, n_valid, d_in, din), b0, d_in, KW)
            store_pre(acc, cur, pre[0], row0, n_valid)
            a = hand_off(acc)
            for l in range(1, n_hidden):
                acc = layer(a, bh[l - 1], KW, KW)
                store_pre(acc, cur, pre[l], row0, n_valid)
                a = hand_off(acc)
            store_out(layer(a, bo, KW, d_out), out, row0, n_valid, d_out, stored)
            done.append(tile)
            cur, nxt = nxt, cur
            tile += step
    assert sorted(done) == list(range(n_tiles)) and np.all(stored == 1)
    return out, pre


def _inputs(dims, n_rows, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, dims[0])).astype(np.float32)
    ws = [(rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32)
          for i in range(len(dims) - 1)]
    return x, ws


@pytest.mark.parametrize("dims,n_rows,grid,aligned16", [
    ([18, 64, 64, 3], 1000, 3, True),      # radiance: d_in 18 zero-padded to 32, (64, 4) out block padded to 8
    ([18, 64, 64, 3], 77, 1, False),       # ragged last tile, 4-byte copies of x
    ([32, 64, 16], 1000, 2, True),         # geo: two output n-tiles
    ([40, 64, 64, 64, 16], 333, 1, True),  # din_pad 64, three hidden layers
    ([64, 64, 1], 17, 1, True),            # one row past an m16 tile, d_out 1
])
def test_fragment_model_matches_the_plain_version_bit_for_bit(dims, n_rows, grid, aligned16):
    x, ws = _inputs(dims, n_rows, n_rows)
    out, pre = kernel_model(x, ws, grid, aligned16)
    ref, pre_ref = fused_mlp_reference(torch.from_numpy(x), [torch.from_numpy(w) for w in ws], save_pre=True)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, ref.numpy())
    np.testing.assert_array_equal(bf16_value(pre), pre_ref.float().numpy())


def test_fragment_model_sees_a_wrong_hand_off():
    # the model is not blind: swapping the two n-tiles of each k-step in the
    # accumulator -> A fragment hand-off changes the result
    x, ws = _inputs([18, 64, 64, 3], 64, 1)

    def swapped(acc):
        return to_a([[acc[m][j ^ 1] for j in range(8)] for m in range(KM)])

    out, _ = kernel_model(x, ws, 1, hand_off=swapped)
    ref = fused_mlp_reference(torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    assert not np.array_equal(out, ref.numpy())


def mma_order_forward(x, weights):
    """The plain version's forward with each layer summed as the kernel
    sums it: per k-step of 16, the exact sum of its products added to the
    f32 accumulator. Returns out and the bf16 pre-activations."""
    h = x.to(torch.bfloat16).float()
    pres = []
    for i, w in enumerate(weights):
        wb = w.to(torch.bfloat16).float()
        k_pad = -(-h.shape[1] // 16) * 16
        hp = torch.nn.functional.pad(h, (0, k_pad - h.shape[1])).double()
        wp = torch.nn.functional.pad(wb, (0, 0, 0, k_pad - wb.shape[0])).double()
        acc = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float32)
        for k0 in range(0, k_pad, 16):
            acc = (acc.double() + hp[:, k0:k0 + 16] @ wp[k0:k0 + 16]).float()
        if i < len(weights) - 1:
            pres.append(acc.to(torch.bfloat16))
            acc = torch.relu(acc)
        h = acc.to(torch.bfloat16).float()
    return h, torch.stack(pres)


# the kernel's order flips a bf16 rounding where an f32 sum lands within its
# last bits of a rounding boundary, and a flip in a hidden layer moves the
# row's later sums by a fraction of a bf16 ulp. The emulation flips ~1e-5 of
# the values here, the kernel ~1e-4 at 2^18 rows on the card (chip_smoke.py
# holds it to the same bound)
FLIP_BOUND = 1e-3
TOL = 2e-2  # a flipped value is one bf16 ulp (2^-8 relative) off, and so is what it moves


@pytest.mark.parametrize("dims", [[32, 64, 16], [18, 64, 64, 3]])
def test_mma_summation_order_stays_within_the_tolerance(dims):
    x, ws = _inputs(dims, 4096, 7)
    xt, wt = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    out, pre = mma_order_forward(xt, wt)
    ref, pre_ref = fused_mlp_reference(xt, wt, save_pre=True)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(pre.float(), pre_ref.float(), rtol=TOL, atol=TOL)
    flips = [float((out != ref).float().mean()), float((pre != pre_ref).float().mean())]
    assert max(flips) < FLIP_BOUND, flips
    assert max(flips) > 0, "another summation order that never flips a rounding: the emulation is the plain one"
    # the JAX package's Pallas forward (interpret mode) on the same inputs
    want = np.asarray(jax_fused_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws], tile=128, interpret=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
