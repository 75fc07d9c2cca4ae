// Hopper (sm_90a) Tensor Memory Accelerator (TMA) and mbarrier building
// blocks: 2-D tensor maps of byte matrices built on the host, tile loads into
// 128-byte-swizzled shared memory that complete on an mbarrier, the
// mbarrier's init / arrive / wait, and a named barrier for a subset of a
// block's warps.
//
// A tile load of a (rows, row_bytes) int8 matrix with box (box_rows, 128)
// lands in shared memory as wgmma's 128-byte swizzle reads it (wgmma.cuh:
// chunk c of row r at chunk c ^ (r % 8), the tile 1024-byte aligned); rows and
// bytes outside the matrix arrive as zeros and still count toward the bytes
// the barrier expects.
//
// The encoder (cuTensorMapEncodeTiled, a driver function) is looked up
// through the runtime, so a library that includes this links no libcuda.
// A map is passed to the kernel by value as a __grid_constant__ parameter.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major (rows, row_bytes) byte matrix at base (16-byte
// aligned, row_bytes a multiple of 16), read in boxes of box_rows x 128
// bytes with the 128-byte swizzle.  Returns a cudaError_t value.
inline int map_2d(CUtensorMap* map, const void* base, uint64_t rows,
                  uint64_t row_bytes, uint32_t box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {row_bytes, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {128, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// ---- device side; every address is a shared-memory byte address

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// After the inits, before any thread uses a barrier (then a block barrier).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also tells the barrier to expect `bytes` more from TMA.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0; waiting on parity 1 returns at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (x bytes, y rows) of the map into dst, completing on bar.
__device__ __forceinline__ void load_2d(uint32_t dst, const CUtensorMap* map,
                                        int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over COUNT threads, a
// multiple of 32: waits for all of them.
template <int COUNT>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(COUNT) : "memory");
}

}  // namespace tma
