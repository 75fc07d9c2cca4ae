"""The s8 ``wgmma`` instances of the int8 probes (``csrc/probes.cu``:
``chain_s8_kernel``, ``gemm_s8_kernel``) walked on the CPU in the kernels'
own order, and their host plans.

A kernel written in CUDA cannot run here, so what surrounds its arithmetic
is held instead: the weight operand the wrapper builds
(``probes.chain_operand``), read through the register layout of
``csrc/wgmma.cuh`` as a thread of the kernel reads it; the K slices, the
zero fill of TMA beyond the matrix, the persistent blocks' walk over the
tiles, the staging tile's swizzle and the masked stores.  Everything is
int8 with int32 sums, so every walk must equal the plain version to the
bit.  The plans (``gemm_plan``, ``chain_plan``) must pick the s8 instance
and stay inside a block's shared memory at every shape ``chip_smoke.py``
runs.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cwfa_tpu_torch.ops import probes

# the shapes chip_smoke.py's probe phase gives the two kernels
GEMM_SHAPES = [(1 << 20, 1152, 128), (1 << 20, 1152, 256),
               (1 << 20, 1152, 512), (37, 20, 5), (129, 100, 130),
               (300, 1153, 136)]
CHAIN_SHAPES = [(1 << 20, 8), (1000, 8), (37, 3), (256, 1)]


def _cvt_pack_sat(a: int, b: int, c: int) -> int:
    """PTX cvt.pack.sat.s8.s32.b32 d, a, b, c: a and b clipped to -128..127,
    b in bits 0..7, a in bits 8..15, the low 16 bits of c above them."""
    sat = lambda v: min(127, max(-128, int(v))) & 0xFF
    return ((c << 16) | (sat(a) << 8) | sat(b)) & 0xFFFFFFFF


def _requant2(hi, lo, c: int = 0) -> int:
    """csrc/probes.cu requant2: the lower clip before the shift, the upper
    one the pack's saturation."""
    return _cvt_pack_sat(max(int(hi), -16256) >> 7, max(int(lo), -16256) >> 7,
                         c)


def _requant4(a, b, c, d) -> int:
    """csrc/probes.cu requant4: four values, the first in the lowest byte."""
    return _requant2(b, a, _requant2(d, c))


def test_requant_packed_is_the_plain_requant():
    acc = [-1, -127, -128, -129, 127, 128, 255, 256, 16255, 16256, 16383,
           16384, 17000, -16256, -16257, -16384, -40000, 40000, -2 ** 31,
           2 ** 31 - 1]
    want = probes.requant(torch.tensor(acc, dtype=torch.int32)).tolist()
    got = [int(np.uint8(_requant2(0, v) & 0xFF).view(np.int8)) for v in acc]
    assert got == want
    word = _requant4(*acc[:4]).to_bytes(4, "little")
    assert list(np.frombuffer(word, np.int8)) == want[:4]


def _store_tile(acc, out, row0, col0):
    """csrc/probes.cu store_tile: the requantized sums of a warpgroup's
    64 x 128 tile (acc as the threads hold it: thread (w, g, q), register
    4 j + 2 h + e is row 16 w + g + 8 h, column 8 j + 2 q + e) through the
    swizzled staging tile, then 16-byte chunks to out, rows >= M and
    columns >= N skipped."""
    stg = np.zeros(64 * 128, np.uint8)
    for w in range(4):
        for g in range(8):
            for q in range(4):
                for j in range(16):
                    for h in range(2):
                        r, c = 16 * w + g + 8 * h, 8 * j + 2 * q
                        at = r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15)
                        v = _requant2(acc[r, c + 1], acc[r, c])
                        stg[at], stg[at + 1] = v & 0xFF, v >> 8
    m, n = out.shape
    for t in range(128):
        for i in range(4):
            idx = t + 128 * i
            r, ch = idx >> 3, idx & 7
            row, col = row0 + r, col0 + 16 * ch
            if row >= m or col >= n:
                continue
            chunk = stg[r * 128 + ((ch ^ (r & 7)) << 4):][:16]
            width = min(16, n - col)
            out[row, col:col + width] = chunk[:width].view(np.int8)


def _chain_walk(x, wt, grid):
    """chain_s8_kernel on the CPU: blocks b = 0..grid-1 take tiles of
    64 CHAIN_WGS rows b, b + grid, ...; warpgroup v of a tile its rows
    64 v ..; stage 0 from the (zero-filled) x tile, every later stage from
    A registers built as the kernel builds them, read back through
    wgmma.cuh's layout (register 2 r + h of k-step ks: row g + 8 h,
    k = 32 ks + 16 r + 4 q + byte)."""
    m, rows = x.shape[0], 64 * probes.CHAIN_WGS
    ntiles = -(-m // rows)
    xp = np.zeros((ntiles * rows, 128), np.int64)
    xp[:m] = x
    w = wt.astype(np.int64)
    out = np.zeros((m, 128), np.int8)
    seen = []
    for b in range(grid):
        for t in range(b, ntiles, grid):
            seen.append(t)
            for v in range(probes.CHAIN_WGS):
                acc = xp[t * rows + 64 * v:][:64] @ w[0].T
                for i in range(1, len(w)):
                    a = np.zeros((64, 128), np.int64)
                    for warp in range(4):
                        for g in range(8):
                            for q in range(4):
                                for ks in range(4):
                                    for r in range(2):
                                        c = 8 * (4 * ks + 2 * r) + 2 * q
                                        for h in range(2):
                                            row = 16 * warp + g + 8 * h
                                            reg = _requant4(*(acc[row, cc] for cc in
                                                              (c, c + 1, c + 8, c + 9)))
                                            k0 = 32 * ks + 16 * r + 4 * q
                                            a[row, k0:k0 + 4] = np.frombuffer(
                                                reg.to_bytes(4, "little"), np.int8)
                    acc = a @ w[i].T
                _store_tile(acc, out, t * rows + 64 * v, 0)
    assert sorted(seen) == list(range(ntiles))       # every tile once
    return out


@pytest.mark.parametrize("m", [64, 37])
@pytest.mark.parametrize("depth", [1, 3, 8])
def test_chain_pack_walked_in_fragment_order_is_the_plain_version(m, depth):
    rng = np.random.RandomState(depth * 100 + m)
    x = rng.randint(-127, 128, (m, 128)).astype(np.int8)
    ws = (rng.randint(-127, 128, (depth, 128, 128)) // 8).astype(np.int8)
    xt, wst = torch.from_numpy(x), torch.from_numpy(ws)
    plan = probes.chain_plan(m, depth, torch.int8)
    assert plan["instance"] == probes.WGMMA_S8
    wt = probes.chain_operand(wst, probes.WGMMA_S8).numpy()
    ref = probes.chained_gemm_reference(xt, wst).numpy()
    got = _chain_walk(x, wt, plan["grid"])
    assert np.array_equal(got, ref)
    assert (ref < 0).any() and (ref > 0).any()
    if depth < 8:       # deeper, the //8 weights shrink the values
        assert (np.abs(ref) == 127).any()
    if depth > 1:       # the walk needs the permutation: without it, wrong
        plain = probes.chain_operand(wst, probes.MMA_SYNC).numpy()
        assert not np.array_equal(_chain_walk(x, plain, plan["grid"]), ref)


def test_chain_operand_is_the_transpose_then_the_sum_order():
    rng = np.random.RandomState(5)
    ws = torch.from_numpy(rng.randint(-127, 128, (3, 128, 128)).astype(np.int8))
    plain = probes.chain_operand(ws, probes.MMA_SYNC)
    wt = probes.chain_operand(ws, probes.WGMMA_S8)
    assert wt.is_contiguous() and wt.shape == (3, 128, 128)
    assert torch.equal(plain, ws.transpose(1, 2))
    assert torch.equal(wt[0], plain[0])
    order = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)
    for i in (1, 2):
        for k in range(128):
            assert torch.equal(wt[i][:, k], ws[i][16 * (k // 16) + order[k % 16]])


def _gemm_walk(a, b, plan):
    """gemm_s8_kernel on the CPU: K zero-padded to the plan's slices of 128
    bytes (TMA's fill), B^T's 128-column slice resident per block, block c
    on column slice c % n_tiles and row tiles c // n_tiles + j * (grid //
    n_tiles); per tile the slices' k-steps summed in order, then the
    staging store."""
    (m, k), n = a.shape, b.shape[1]
    kp = plan["slices"] * 128
    mt, nt = plan["m_tiles"], plan["n_tiles"]
    ap = np.zeros((mt * 128, kp), np.int64)
    ap[:m, :k] = a
    btp = np.zeros((nt * 128, kp), np.int64)
    btp[:n, :k] = b.T
    out = np.zeros((m, n), np.int8)
    seen = []
    grid, step = plan["grid"], plan["grid"] // nt
    for c in range(grid):
        ns = c % nt
        bres = btp[128 * ns:][:128]
        for t in range(c // nt, mt, step):
            seen.append((t, ns))
            for v in range(2):
                rows = ap[t * 128 + 64 * v:][:64]
                acc = np.zeros((64, 128), np.int64)
                for s in range(plan["slices"]):
                    for ks in range(4):
                        k0 = 128 * s + 32 * ks
                        acc += rows[:, k0:k0 + 32] @ bres[:, k0:k0 + 32].T
                _store_tile(acc, out, t * 128 + 64 * v, 128 * ns)
    assert sorted(seen) == [(t, s) for t in range(mt) for s in range(nt)]
    return out


@pytest.mark.parametrize("m,k,n", [(37, 20, 5), (129, 100, 130),
                                   (300, 290, 136)])
def test_gemm_s8_walked_in_slice_order_is_the_plain_version(m, k, n):
    rng = np.random.RandomState(m + n)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (k, n)).astype(np.int8)
    a[0], b[:, 0] = -127, 127
    # a small card (3 SMs) so that blocks walk several row tiles
    plan = probes.gemm_plan(m, k, n, torch.int8, out8=True, sms=3)
    assert plan["instance"] == probes.WGMMA_S8
    ref = probes.tiled_gemm_reference(torch.from_numpy(a), torch.from_numpy(b),
                                      out8=True).numpy()
    assert np.array_equal(_gemm_walk(a, b, plan), ref)
    assert ref[0, 0] == -127 and (ref == 127).any()


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_plan_at_the_smoke_shapes(m, k, n):
    plan = probes.gemm_plan(m, k, n, torch.int8, out8=True)
    assert plan["instance"] == probes.WGMMA_S8
    assert plan["smem"] <= probes.SMEM_MAX and plan["ring"] >= 2
    assert plan["k_padded"] % 16 == 0 and plan["k_padded"] - k < 16
    assert plan["slices"] == -(-plan["k_padded"] // 128)
    assert (plan["m_tiles"], plan["n_tiles"]) == (-(-m // 128), -(-n // 128))
    # persistent: at most one block per SM (unless the column slices alone
    # outnumber them), every block on one column slice
    assert plan["grid"] % plan["n_tiles"] == 0
    assert plan["grid"] <= max(probes.H100_SMS, plan["n_tiles"])
    assert plan["grid"] // plan["n_tiles"] <= plan["m_tiles"]
    # the other epilogues and the unaligned or over-deep cases keep theirs
    assert probes.gemm_plan(m, k, n, torch.int8)["instance"] == probes.MMA_SYNC
    assert probes.gemm_plan(m, k, n, torch.int8, out8=True,
                            aligned=False)["instance"] == probes.MMA_SYNC
    assert probes.gemm_plan(m, k, n, torch.bfloat16)["instance"] == probes.WGMMA_BF16


def test_gemm_plan_largest_resident_k():
    """B^T's slice (128 x K bytes) and a ring of two fit up to K = 1408."""
    assert probes.gemm_plan(64, 1408, 128, torch.int8, True)["ring"] == 2
    assert probes.gemm_plan(64, 1409, 128, torch.int8,
                            True)["instance"] == probes.MMA_SYNC
    assert probes.gemm_plan(64, 1152, 128, torch.int8, True)["ring"] == 4


@pytest.mark.parametrize("m,depth", CHAIN_SHAPES)
def test_chain_plan_at_the_smoke_shapes(m, depth):
    plan = probes.chain_plan(m, depth, torch.int8)
    assert plan["instance"] == probes.WGMMA_S8
    assert plan["smem"] <= probes.SMEM_MAX and plan["ring"] >= 2
    assert plan["tiles"] == -(-m // (64 * probes.CHAIN_WGS))
    assert plan["grid"] == min(probes.H100_SMS, plan["tiles"])
    assert probes.chain_plan(m, depth, torch.bfloat16)["instance"] == probes.MMA_SYNC
    assert probes.chain_plan(m, 9, torch.int8)["instance"] == probes.MMA_SYNC
    assert probes.chain_plan(m, depth, torch.int8,
                             aligned=False)["instance"] == probes.MMA_SYNC


def test_instances_to_ask_for():
    a = torch.zeros(4, 8, dtype=torch.int8)
    b = torch.zeros(8, 4, dtype=torch.int8)
    assert set(probes.tiled_gemm.by_instance) == {
        probes.WGMMA_S8, probes.WGMMA_BF16, probes.MMA_SYNC}
    assert set(probes.chained_gemm.by_instance) == {
        probes.WGMMA_S8, probes.MMA_SYNC}
    # the older instance, where the s8 one would run: the plain version here
    assert torch.equal(probes.tiled_gemm(a, b, out8=True,
                                         instance=probes.MMA_SYNC),
                       probes.tiled_gemm_reference(a, b, out8=True))
    assert torch.equal(probes.tiled_gemm(a, b, out8=True,
                                         instance=probes.WGMMA_S8),
                       probes.tiled_gemm_reference(a, b, out8=True))
    with pytest.raises(ValueError):                 # not the plan's instance
        probes.tiled_gemm(a, b, instance=probes.WGMMA_S8)
    with pytest.raises(ValueError):                 # not an instance at all
        probes.tiled_gemm(a, b, out8=True, instance="cuBLAS")
    with pytest.raises(ValueError):                 # bf16 has no mma.sync GEMM
        probes.tiled_gemm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                          instance=probes.MMA_SYNC)
    x = torch.zeros(4, 128, dtype=torch.int8)
    ws = torch.zeros(2, 128, 128, dtype=torch.int8)
    for inst in (probes.MMA_SYNC, probes.WGMMA_S8):
        assert torch.equal(probes.chained_gemm(x, ws, instance=inst),
                           probes.chained_gemm_reference(x, ws))
    with pytest.raises(ValueError):                 # the s8 chain takes depth <= 8
        probes.chained_gemm(x, torch.zeros(9, 128, 128, dtype=torch.int8),
                            instance=probes.WGMMA_S8)
    with pytest.raises(ValueError):                 # bf16 runs mma.sync only
        probes.chained_gemm(x.to(torch.bfloat16), ws.to(torch.bfloat16),
                            instance=probes.WGMMA_S8)
    with pytest.raises(ValueError):                 # not an instance at all
        probes.chained_gemm(x, ws, instance="wgmma s8 turns")


@pytest.mark.parametrize("nres,ring,slot,nc", [
    (9, 4, 128 * 128, 2), (11, 2, 128 * 128, 2), (8, 4, 192 * 128, 3),
    (1, 4, 192 * 128, 3)])
def test_plan_lays_shared_memory_out_as_the_kernels_read_it(nres, ring, slot,
                                                            nc):
    """The plans size the ring with ``_tma_smem``; csrc/probes.cu
    ``tma_smem`` places the tiles and barriers by the same sum."""
    src = (Path(probes.__file__).parents[1] / "csrc" / "probes.cu").read_text()
    body = re.search(r"constexpr int tma_smem\(int nres, int ring, int slot, "
                     r"int nc\) \{\s*return ([^;]+);", src).group(1)
    env = {"nres": nres, "ring": ring, "slot": slot, "nc": nc,
           "kTile": 128 * 128, "kHalf": 64 * 128}
    assert eval(body, {}, env) == probes._tma_smem(nres, ring, slot, nc)
    assert probes._sms(torch.device("cpu")) == probes.H100_SMS
