"""Writes ``cwfa_tpu_torch/csrc/wgmma.cuh``: the ``wgmma`` instruction
wrappers are long operand lists that differ only in the type, N and where A
comes from, so the header is generated.

    python3 scripts/torch_gen_wgmma_header.py          # print the header
    python3 scripts/torch_gen_wgmma_header.py --write  # replace the file

To add a width, add it to ``SS_BF16``, ``SS_BF16_T``, ``RS_BF16``, ``RS_TF32``,
``SS_S8`` or ``RS_S8`` and write the header anew; ``tests/test_torch_port_probes.py`` holds the committed
header to this script's output.
"""

from __future__ import annotations

import sys
from pathlib import Path

HEADER = (Path(__file__).resolve().parents[1] / "cwfa_tpu_torch" / "csrc"
          / "wgmma.cuh")
SS_BF16 = (16, 32, 48, 64, 96, 128, 256)   # A and B from shared memory
SS_BF16_T = (16, 32, 48, 64, 80, 96, 112, 128)   # ... both MN-major (transposed)
RS_BF16 = (64,)                            # A from registers
RS_TF32 = (16, 32, 48, 64, 96)
SS_S8 = (16, 32, 48, 64, 96, 128)          # int8, int32 sums
RS_S8 = (64, 128)
# kind -> (k, PTX types, type and asm constraint of a sum)
KINDS = {"bf16": (16, "f32.bf16.bf16", "float", "+f"),
         "tf32": (8, "f32.tf32.tf32", "float", "+f"),
         "s8": (32, "s32.s8.s8", "int32_t", "+r")}


def regs(n: int, start: int = 0) -> str:
    return ", ".join(f"%{i}" for i in range(start, start + n))


def inst(kind: str, n: int, rs: bool, mn_major: bool = False) -> str:
    """One wrapper: ``kind`` "bf16" (k16), "tf32" (k8) or "s8" (k32), N =
    ``n``, A from registers (``rs``) or from shared memory; ``mn_major``
    (bf16 from shared memory only): both operands MN-major."""
    nacc = n // 2
    k, types, ctype, constraint = KINDS[kind]
    name = f"wgmma_{'rs' if rs else 'ss'}_{kind}{'_t' if mn_major else ''}"
    a_arg = "const uint32_t* a" if rs else "uint64_t da"
    # the s8 products take scale-d as an argument (0: d = A B, the old sums
    # ignored); the float ones always add
    sd_arg, sd_op = (", int scale_d", "scale_d") if kind == "s8" else ("", "1")
    a_ops = "{" + regs(4, nacc) + "}" if rs else f"%{nacc}"
    nb = nacc + (4 if rs else 1)          # operand number of B's descriptor
    # after scale-d (the predicate): for the float types scale-a, scale-b,
    # then for bf16 the transpose flags (of B only when A comes from
    # registers); the integer product has neither
    tail = {("bf16", True): "p, 1, 1, 0", ("bf16", False): "p, 1, 1, 0, 0",
            ("tf32", True): "p, 1, 1", ("s8", True): "p",
            ("s8", False): "p"}[kind, rs]
    if mn_major:
        tail = "p, 1, 1, 1, 1"
    out = ["template <>",
           f"__device__ __forceinline__ void {name}<{n}>({ctype}* d, {a_arg}, "
           f"uint64_t db{sd_arg}) {{",
           "  asm volatile(",
           f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nb + 1}, 0;\\n"',
           f'      "wgmma.mma_async.sync.aligned.m64n{n}k{k}.{types} "']
    accs = [f"%{i}" for i in range(nacc)]
    lines = [", ".join(accs[i:i + 8]) for i in range(0, nacc, 8)]
    for j, line in enumerate(lines):
        pre = "{" if j == 0 else " "
        post = "}, " if j == len(lines) - 1 else ", "
        out.append(f'      "{pre}{line}{post}"')
    out.append(f'      "{a_ops}, %{nb}, {tail};\\n}}\\n"')
    sums = [f'"{constraint}"(d[{i}])' for i in range(nacc)]
    out.append("      : " + ",\n        ".join(
        ", ".join(sums[i:i + 4]) for i in range(0, nacc, 4)))
    if rs:
        out.append('      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), '
                   f'"l"(db), "r"({sd_op}));')
    else:
        out.append(f'      : "l"(da), "l"(db), "r"({sd_op}));')
    out.append("}")
    return "\n".join(out)


HEAD = '''// Hopper (sm_90a) warpgroup matrix multiply (wgmma) building blocks: shared
// memory matrix descriptors, the fence / commit / wait instructions and the
// m64nNk16 bf16 and m64nNk8 tf32 products with f32 sums and the m64nNk32 s8
// product with s32 sums, B always from shared memory, A from shared memory
// (ss) or from registers (rs).  The float products always add to the sums in
// d (zero them first); the s8 ones add unless scale_d is 0, which writes
// d = A B.
//
// A warpgroup is four consecutive warps (128 threads, the first warp's index
// a multiple of 4); all of them execute every instruction here together.
// Both operands are K-major: a core matrix is 8 rows (M of A, N of B) of 16
// bytes of K.  The _t products (bf16, both from shared memory) take both
// operands MN-major instead: a core matrix is 8 rows of K, each 16 bytes of
// 8 consecutive M (or N) elements, 128 contiguous bytes; lbo = bytes
// between the two core matrices of one product along K, sbo = bytes between
// 8-element groups along M (N).
//
// Sum layout (d, N / 2 floats per thread), lane = 4 g + q of warp w:
//   d[4 j + 0], d[4 j + 1]: row 16 w + g,     columns 8 j + 2 q, 8 j + 2 q + 1
//   d[4 j + 2], d[4 j + 3]: row 16 w + g + 8, the same columns.
// A from registers (4 words): rows 16 w + g (a[0], a[2]) and 16 w + g + 8
// (a[1], a[3]); bf16: a[0], a[1] hold k = 2 q, 2 q + 1 and a[2], a[3]
// k = 2 q + 8, 2 q + 9; tf32: a[0], a[1] hold k = q and a[2], a[3] k = q + 4;
// s8: a[0], a[1] hold k = 4 q .. 4 q + 3 (one per byte, lowest first) and
// a[2], a[3] k = 4 q + 16 .. 4 q + 19.  The s8 sums have the layout of the
// f32 ones.  The registers of an rs product must not change until it has completed
// (wgmma_wait).
//
// The instruction wrappers differ only in N and their operand lists:
// scripts/torch_gen_wgmma_header.py writes this file.

#pragma once

#include <stdint.h>

namespace wg {

constexpr uint64_t kSwizzleNone = 0, kSwizzle128 = 1;

// Descriptor of a K-major operand without its start address.
//   no swizzle:   the 8 rows of a core matrix are 16 bytes apart (128
//                 contiguous bytes); lbo = bytes between the two core
//                 matrices of one product along K, sbo = bytes between
//                 8-row groups.  The start address needs 16-byte alignment
//                 only, so a shifted row window is a shifted address.
//   128B swizzle: a row is 128 bytes of K, its 16-byte chunk c of row r
//                 stored at chunk c ^ (r % 8); 8-row groups sbo = 1024 bytes
//                 apart, the tile 1024-byte aligned; lbo is not used; the
//                 next 32 bytes of K are the start address + 32.
__device__ __forceinline__ uint64_t desc_base(uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// base: desc_base(...); addr: shared-memory byte address (16-byte aligned).
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t addr) {
  return base | (uint64_t)((addr >> 4) & 0x3FFF);
}

// Orders the warpgroup's earlier register and shared-memory accesses before
// its next wgmma.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}

// Waits until at most N of the committed groups are still running.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(N) : "memory");
}

// Makes shared-memory writes of this thread (st.shared, cp.async) visible
// to wgmma's reads; call before the barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss_bf16(float* d, uint64_t da, uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_ss_bf16_t(float* d, uint64_t da, uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_rs_bf16(float* d, const uint32_t* a, uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float* d, const uint32_t* a, uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_ss_s8(int32_t* d, uint64_t da, uint64_t db,
                                            int scale_d = 1);
template <int N>
__device__ __forceinline__ void wgmma_rs_s8(int32_t* d, const uint32_t* a, uint64_t db,
                                            int scale_d = 1);
'''

def render() -> str:
    parts = [HEAD]
    parts += [inst("bf16", n, False) for n in SS_BF16]
    parts += [inst("bf16", n, False, mn_major=True) for n in SS_BF16_T]
    parts += [inst("bf16", n, True) for n in RS_BF16]
    parts += [inst("tf32", n, True) for n in RS_TF32]
    parts += [inst("s8", n, False) for n in SS_S8]
    parts += [inst("s8", n, True) for n in RS_S8]
    parts.append("}  // namespace wg\n")
    return "\n\n".join(parts)


def main():
    if sys.argv[1:] == ["--write"]:
        HEADER.write_text(render())
    else:
        sys.stdout.write(render())
    return 0


if __name__ == "__main__":
    sys.exit(main())
