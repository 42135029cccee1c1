// Hopper (sm_90a) building blocks shared by the two wgmma kernels of the
// port, K8's conv3x3_wgmma.cuh and K7's matmul_bn_wgmma.cuh: mbarriers (a
// wait that traps after 20 s instead of hanging the card), TMA tile loads,
// wgmma's fences, descriptors and accumulator fence, bf16 packing, the quad
// transpose behind 16-byte stores, and the encoding of TMA tensor maps on the
// host (cuTensorMapEncodeTiled, fetched from the driver through the runtime,
// so nothing links against libcuda).
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` of the barrier has completed. A
// stage that never fills is a bug: the launch fails (trap) after 20 s
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - start > 20000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// One arrival on the barrier that also expects `bytes` more from TMA copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// TMA: the box of the 2-d tensor map at (column c0, row c1) into shared
// memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler the accumulators change here (after wgmma.wait_group),
// so no read of them moves above it.
template <int N> __device__ __forceinline__ void fence_accumulators(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 values as the bits of a bf16 pair (the first in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  uint32_t r = v[0];
  r = i == 1 ? v[1] : r;
  r = i == 2 ? v[2] : r;
  return i == 3 ? v[3] : r;
}

// Lane q of a quad (lanes 4k .. 4k + 3) holds words[b] = its two columns of
// 8-column block b (b < 4); afterwards it holds block q's eight columns, from
// the quad's lanes in order. All 32 lanes must call it.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&words)[4], int q) {
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // lane q ^ r sends its columns of block q
    const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(words, q ^ r), r);
#pragma unroll
    for (int p = 0; p < 4; ++p) out[p] = p == (q ^ r) ? got : out[p];
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// wgmma descriptor of an operand tile in 128-byte-swizzled shared memory:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// TMA: the box of the 1-d tensor map at element c0 into shared memory,
// completing its bytes on the barrier.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, int c0,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

// A tiled TMA map of `rank` (1 or 2) dimensions, innermost first: `dims`
// elements, `strides` bytes between the rows (rank 2), boxes of `box`
// elements, zeros outside the tensor.
inline cudaError_t encode_tiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                const void* base, const cuuint64_t* dims,
                                const cuuint64_t* strides, const cuuint32_t* box,
                                CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return err != cudaSuccess ? err : cudaErrorNotSupported;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, steps,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
