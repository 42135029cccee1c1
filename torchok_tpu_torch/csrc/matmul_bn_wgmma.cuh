// The bf16 route of K7 (matmul_bn_fwd.cu) for Hopper (sm_90a): a 1x1 conv
// as a GEMM on wgmma, with the previous BatchNorm's affine + ReLU applied to
// A in registers and this layer's column statistics taken from the rounded
// output, on a persistent, warp-specialised kernel fed by TMA.
//
//   a  = relu?(x * scale + bias)   f32 (one FMA), rounded to bf16
//   y  = bf16(a @ w)                f32 accumulation
//   s1 = sum_m y, s2 = sum_m y*y    over the rounded y, f32; rows past M never
//                                   reach them (the affine maps x = 0 to relu(bias))
//
// Design (what bounded the FMA/wmma tile loop of gemm_tile.cuh: register-hop
// loads, products and each slab's bookkeeping added up, at about 75 TFLOP/s):
//  * one block per SM, persistent. Block b takes column tile b % tiles_n and
//    row tiles b / tiles_n, + groups, ... (groups = gridDim.x / tiles_n): the
//    blocks that read one row panel of x at the same time are neighbours and
//    share it through L2, and each block's column sums belong to one column
//    tile, so they stay in registers across its row tiles. Tiles are 128 rows
//    by BN = 64, 128 or 256 columns (ops/conv_bn.py::forward_plan: the whole
//    of N up to 256, so x is read and transformed once);
//  * warpgroups 0 and 1 consume (64 rows each); one thread of warpgroup 2
//    walks the block's tiles in slabs of 64 columns of x through a ring of
//    stages. A stage is an x tile (128 x 64, TMA, 128-byte swizzle), the
//    matching w slab (64 x BN, N-major, one TMA box per 64 columns, the
//    layout K8 reads W in), and the slab's 64 scale and bias values (1-d TMA
//    boxes). TMA fills zeros past M, K and N, so columns past K meet scale =
//    bias = 0 and give a = 0. setmaxnreg moves registers from the producer
//    to the consumers (a 64 x 256 f32 accumulator is 128 a thread);
//  * a consumer loads its x fragments with ldmatrix (the swizzle XORs the
//    16-byte chunk with the row mod 8) straight into the register layout of
//    wgmma's A operand, applies the affine in f32 and rounds to bf16 with the
//    ReLU folded into the rounding (relu(round(a)) = round(relu(a))), and
//    issues wgmma.m64nBNk16 with A from registers and w from the stage's
//    descriptor (the FlashAttention-3 form for P.V). It waits for the slab's
//    products before the next slab's prologue and frees the stage then; the
//    other warpgroup's products fill the tensor cores meanwhile;
//  * the epilogue rounds the accumulators once to bf16 and stores y in
//    16-byte pieces (quad_transpose, as K8). The column sums of the rounded
//    y, rows past M left out, are reduced in a fixed order: each thread adds
//    its two rows, a reduce-scatter over the eight lanes of a column
//    (shuffles 16, 8, 4 apart) leaves each lane one column's sums of the
//    warp's 16 rows, the eight warps' rows go through shared memory in warp
//    order, and the sum is added to the block's running sums. One partial
//    row per block; the rows are added in order by matmul_bn_reduce_kernel.
//    No atomics: two launches give the same bits.
// Builds that were measured and dropped (PERF.md): a slab's products kept
// in flight across the next prologue (ptxas serialized every wgmma, C7513);
// the prologue applied in place to the x tile in shared memory, by the
// consumers or by warps of their own (another 32 KB a slab through shared
// memory; up to 1.7 times as long at stage 5, the same over the stage-4
// chain); y staged by stmatrix and written by TMA stores (spills at BN = 256,
// no faster); one producer warp instead of a warpgroup, for 224 registers a
// thread without setmaxnreg (more spills, slower).
//
// What bounds it: at ResNet-50's 1x1 shapes at batch 256 the kernel must read
// x and write y once (0.02 to 0.15 ms at 3.35 TB/s) for 26 GFLOP (0.027 ms at
// 989 TFLOP/s): device memory bounds stages 2 to 4, the products stage 5.
#pragma once
#include "hopper_async.cuh"

// K7_RUN(phase): whether the kernel runs a phase (prologue, products, store,
// stats, and the x and w loads after a block's first tile). Always in the
// package; tools/time_conv_bn_variants.py builds this file with it defined
// to leave a phase out, for timing.
#ifndef K7_RUN
#define K7_RUN(phase) true
#endif

namespace bnwg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;               // tile rows: 64 for each consumer warpgroup
constexpr int kBK = 64;                // slab depth: 64 columns of x, 128 bytes
constexpr int kConsumerThreads = 256;  // warpgroups 0 and 1; the producer's follows
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kWarps = kConsumerThreads / 32;
// 2 x 128 x 232 + 128 x 40 registers fit the SM's 65,536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSharedLimit = 232448;   // dynamic shared memory a block may use

template <int BN> struct Config {
  static_assert(BN == 64 || BN == 128 || BN == 256, "tile widths");
  static constexpr int kXBytes = kBM * kBK * 2;          // 16 KB
  static constexpr int kWBytes = kBK * BN * 2;           // BN / 64 boxes of 8 KB
  static constexpr int kVecOffset = kXBytes + kWBytes;   // 64 scale, then 64 bias values
  static constexpr int kStageBytes = kVecOffset + 1024;  // every stage starts on 1024 bytes
  static constexpr int kRedBytes = kWarps * 2 * BN * 4;  // a tile's sums of each warp's rows
  static constexpr int kFit = (kSharedLimit - 1024 - kRedBytes - 16 * 8) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;    // 8, 6 and 4 stages
  static constexpr int kSums = (2 * BN + kConsumerThreads - 1) / kConsumerThreads;
  // the ring, the sums, the barriers, and room to align the ring to 1024
  static constexpr size_t kSharedBytes =
      1024 + (size_t)kStages * kStageBytes + kRedBytes + 2 * kStages * 8;
};

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the two consumer warpgroups (barrier 1; __syncthreads is barrier 0)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Tells the compiler the A registers are read and written here (around the
// products that read them).
__device__ __forceinline__ void fence_operands(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[ks][i])::"memory");
}

// element e (0: the low half) of a bf16 pair, as f32
__device__ __forceinline__ float bf16_at(uint32_t pair, int e) {
  return __uint_as_float(e == 0 ? pair << 16 : pair & 0xffff0000u);
}

// The prologue on a pair of x values (two columns of one row): the affine
// as one FMA each, then the rounding to bf16 with the ReLU folded into it.
template <bool kRelu, bool kAffine>
__device__ __forceinline__ uint32_t activate(uint32_t pair, float2 sc, float2 bi) {
  float lo = bf16_at(pair, 0);
  float hi = bf16_at(pair, 1);
  if (kAffine) {
    lo = fmaf(lo, sc.x, bi.x);
    hi = fmaf(hi, sc.y, bi.y);
  }
  if (!kRelu) return pack_bf16(lo, hi);
  uint32_t out;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(out) : "f"(hi), "f"(lo));
  return out;
}

// One step of a reduce-scatter between the lanes `mask` apart: of v[0 .. 2H)
// a lane keeps the half its `upper` bit selects, moved to v[0 .. H), plus its
// partner's copy of that half.
template <int H>
__device__ __forceinline__ void fold(float (&v)[16], int mask, bool upper) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// d[32] += A (64 x 16, registers) * B (16 x 64, N-major, smem); the
// first of a tile (accumulate == 0) overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d[64] += A (64 x 16, registers) * B (16 x 128, N-major, smem); the
// first of a tile (accumulate == 0) overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d[128] += A (64 x 16, registers) * B (16 x 256, N-major, smem); the
// first of a tile (accumulate == 0) overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (BN == 256) {
    wgmma_m64n256k16_rs(d, a, desc_b, accumulate);
  } else if constexpr (BN == 128) {
    wgmma_m64n128k16_rs(d, a, desc_b, accumulate);
  } else {
    wgmma_m64n64k16_rs(d, a, desc_b, accumulate);
  }
}

// x_map: x (M, K) in boxes of 64 columns by 128 rows; w_map: w (K, N) in boxes
// of 64 columns by 64 rows, both 128-byte swizzled; s_map, b_map: scale and
// bias (K,) in boxes of 64. Zeros outside each. partial: [2][groups][N].
template <int BN, bool kRelu, bool kAffine>
__global__ void __launch_bounds__(kThreads, 1)
matmul_bn_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap s_map,
                       const __grid_constant__ CUtensorMap b_map, bf16* __restrict__ y,
                       float* __restrict__ partial, int M, int K, int N, int tiles_n) {
  using Cfg = Config<BN>;
  constexpr int kStages = Cfg::kStages;
  constexpr uint32_t kTx = Cfg::kXBytes + Cfg::kWBytes + (kAffine ? 2 * kBK * 4 : 0);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  float* red = reinterpret_cast<float*>(ring_ptr + kStages * Cfg::kStageBytes);  // [8][2][BN]
  const uint32_t full = ring + kStages * Cfg::kStageBytes + Cfg::kRedBytes;  // full[s]: + 8 s
  const uint32_t empty = full + kStages * 8;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrival, with the stage's TMA bytes
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int m_tiles = (M + kBM - 1) / kBM;
  const int slabs = (K + kBK - 1) / kBK;
  const int groups = gridDim.x / tiles_n;
  const int group = blockIdx.x / tiles_n;
  const int n0 = (blockIdx.x - group * tiles_n) * BN;

  if (tid >= kConsumerThreads) {
    // ---------------- producer: one thread of the last warpgroup ----------------
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumerThreads) {
      int stage = 0;
      uint32_t phase = 0;
      for (int mt = group; mt < m_tiles; mt += groups) {
        for (int kc = 0; kc < slabs; ++kc) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t s = ring + stage * Cfg::kStageBytes;
          const uint32_t bar = full + 8 * stage;
          // (the timing builds may load x or w for the block's first tile only)
          const bool load_x = K7_RUN(x_loads) || mt == group;
          const bool load_w = K7_RUN(w_loads) || mt == group;
          mbar_arrive_expect_tx(
              bar, kTx - (load_x ? 0 : Cfg::kXBytes) - (load_w ? 0 : Cfg::kWBytes));
          if (load_x) tma_load_2d(s, &x_map, kc * kBK, mt * kBM, bar);
#pragma unroll
          for (int nb = 0; nb < BN / 64; ++nb) {
            if (load_w) {
              tma_load_2d(s + Cfg::kXBytes + nb * (kBK * 128), &w_map, n0 + 64 * nb, kc * kBK,
                          bar);
            }
          }
          if (kAffine) {
            tma_load_1d(s + Cfg::kVecOffset, &s_map, kc * kBK, bar);
            tma_load_1d(s + Cfg::kVecOffset + kBK * 4, &b_map, kc * kBK, bar);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroups 0 and 1 ----------------
  setmaxnreg_inc<kConsumerRegs>();
  const int warp = tid / 32;  // rows 16 warp .. 16 warp + 15 of the tile
  const int lane = tid % 32;
  const int q = lane % 4;
  // ldmatrix: lane l gives the address of row l % 8 + 8 ((l / 8) % 2) of its
  // warp's 16 and of 16-byte chunk l / 16 of a k16 step; the swizzle XORs the
  // chunk with the row mod 8, which is l % 8
  const int lrow = warp * 16 + (lane & 7) + (lane & 8);
  const int lchunk = lane >> 4;
  const int swz = lane & 7;
  // w (N-major): 64-column blocks kBK * 128 bytes apart (leading offset),
  // groups of 8 depth rows 1024 apart (stride), a k16 step 16 rows
  constexpr uint32_t kBLead = kBK * 128;
  constexpr uint32_t kBStep = 16 * 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float sums[Cfg::kSums];  // statistic p / BN of column p % BN, p = tid + 256 i
#pragma unroll
  for (int i = 0; i < Cfg::kSums; ++i) sums[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int mt = group; mt < m_tiles; mt += groups) {
    for (int kc = 0; kc < slabs; ++kc) {
      // A of the slab: four k16 steps of four registers (rows g and g + 8,
      // columns 2q and 2q + 8 of the step), the prologue applied
      uint32_t a[4][4];
      mbar_wait(full + 8 * stage, phase);
      const uint32_t s = ring + stage * Cfg::kStageBytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        ldmatrix_x4(a[ks], s + lrow * 128 + (((2 * ks + lchunk) ^ swz) << 4));
      }
      if ((kRelu || kAffine) && K7_RUN(prologue)) {
        const float* vec =
            reinterpret_cast<const float*>(ring_ptr + stage * Cfg::kStageBytes + Cfg::kVecOffset);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // columns 16 ks + 8 h + 2 q, + 1
            float2 sc = make_float2(1.f, 1.f);
            float2 bi = make_float2(0.f, 0.f);
            if (kAffine) {
              sc = *reinterpret_cast<const float2*>(vec + 16 * ks + 8 * h + 2 * q);
              bi = *reinterpret_cast<const float2*>(vec + kBK + 16 * ks + 8 * h + 2 * q);
            }
            a[ks][2 * h] = activate<kRelu, kAffine>(a[ks][2 * h], sc, bi);
            a[ks][2 * h + 1] = activate<kRelu, kAffine>(a[ks][2 * h + 1], sc, bi);
          }
        }
      }
      fence_operands(a);
      wgmma_fence();
      if (K7_RUN(products)) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_rs<BN>(acc, a[ks], make_desc(s + Cfg::kXBytes + ks * kBStep, kBLead, 1024),
                       (kc > 0 || ks > 0) ? 1 : 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(a);
      fence_accumulators(acc);
      if (tid % 128 == 0) mbar_arrive(empty + 8 * stage);  // the products are done with it
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and
    // columns 8 i + 2 (l % 4) (+ 1) of the tile, acc[4 i .. 4 i + 3]
    const int row0 = mt * kBM + warp * 16 + lane / 4;
    const bool ok0 = row0 < M;
    const bool ok1 = row0 + 8 < M;
#pragma unroll
    for (int grp = 0; grp < BN / 32; ++grp) {
      uint32_t top[4], bot[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * grp + b;
        top[b] = pack_bf16(acc[4 * i], acc[4 * i + 1]);
        bot[b] = pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
      }
      if (K7_RUN(store)) {
        // the four lanes of a quad exchange their pairs: each stores 16 bytes
        const uint4 c0 = quad_transpose(top, q);
        const uint4 c1 = quad_transpose(bot, q);
        const int col = n0 + 8 * (4 * grp + q);
        if (col < N) {
          if (ok0) *reinterpret_cast<uint4*>(y + (long long)row0 * N + col) = c0;
          if (ok1) *reinterpret_cast<uint4*>(y + (long long)(row0 + 8) * N + col) = c1;
        }
      }
      if (K7_RUN(stats)) {
        // v[4 b + 2 e + st]: statistic st of column 8 (4 grp + b) + 2 q + e
        // over this thread's two rows
        float v[16];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float t = ok0 ? bf16_at(top[b], e) : 0.f;
            const float u = ok1 ? bf16_at(bot[b], e) : 0.f;
            v[4 * b + 2 * e] = t + u;
            v[4 * b + 2 * e + 1] = fmaf(u, u, t * t);
          }
        }
        // over the eight lanes of a column: lane bits 4, 3, 2 pick b / 2, b % 2, e
        fold<8>(v, 16, (lane & 16) != 0);
        fold<4>(v, 8, (lane & 8) != 0);
        fold<2>(v, 4, (lane & 4) != 0);
        const int g = lane / 4;
        const int col = 32 * grp + 8 * (g >> 1) + 2 * q + (g & 1);
        red[(2 * warp) * BN + col] = v[0];
        red[(2 * warp + 1) * BN + col] = v[1];
      }
    }
    if (K7_RUN(stats)) {
      consumers_sync();
#pragma unroll
      for (int i = 0; i < Cfg::kSums; ++i) {
        const int p = tid + i * kConsumerThreads;
        if (p < 2 * BN) {
          const int st = p / BN;
          const int col = p - st * BN;
          float t = red[st * BN + col];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) t += red[(2 * w + st) * BN + col];
          sums[i] += t;
        }
      }
      consumers_sync();  // red is written again by the next tile
    }
  }
#pragma unroll
  for (int i = 0; i < Cfg::kSums; ++i) {
    const int p = tid + i * kConsumerThreads;
    if (p < 2 * BN) {
      const int st = p / BN;
      const int n = n0 + p - st * BN;
      if (n < N) partial[((size_t)st * groups + group) * N + n] = sums[i];
    }
  }
}

template <int BN, bool kRelu, bool kAffine>
cudaError_t launch_tiles(const bf16* x, const bf16* w, const float* scale, const float* bias,
                         bf16* y, float* partial, int M, int K, int N, int groups,
                         cudaStream_t stream) {
  using Cfg = Config<BN>;
  auto kernel = matmul_bn_wgmma_kernel<BN, kRelu, kAffine>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg::kSharedBytes);
  if (err != cudaSuccess) return err;
  CUtensorMap x_map, w_map, s_map, b_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_rows[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t x_box[2] = {kBK, kBM};
  const cuuint64_t w_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t w_rows[1] = {(cuuint64_t)N * sizeof(bf16)};
  const cuuint32_t w_box[2] = {64, kBK};
  const cuuint64_t v_dims[1] = {(cuuint64_t)K};
  const cuuint64_t v_rows[1] = {0};  // a vector has no rows
  const cuuint32_t v_box[1] = {kBK};
  if ((err = encode_tiled(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_rows, x_box,
                          CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = encode_tiled(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_dims, w_rows, w_box,
                          CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = encode_tiled(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, scale, v_dims, v_rows,
                          v_box, CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess ||
      (err = encode_tiled(&b_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, bias, v_dims, v_rows,
                          v_box, CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess) {
    return err;
  }
  const int tiles_n = (N + BN - 1) / BN;
  kernel<<<tiles_n * groups, kThreads, Cfg::kSharedBytes, stream>>>(
      x_map, w_map, s_map, b_map, y, partial, M, K, N, tiles_n);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_flags(bool relu, bool affine, const bf16* x, const bf16* w,
                         const float* scale, const float* bias, bf16* y, float* partial, int M,
                         int K, int N, int groups, cudaStream_t st) {
  if (relu && affine) return launch_tiles<BN, true, true>(x, w, scale, bias, y, partial, M, K, N, groups, st);
  if (relu) return launch_tiles<BN, true, false>(x, w, scale, bias, y, partial, M, K, N, groups, st);
  if (affine) return launch_tiles<BN, false, true>(x, w, scale, bias, y, partial, M, K, N, groups, st);
  return launch_tiles<BN, false, false>(x, w, scale, bias, y, partial, M, K, N, groups, st);
}

// One launch of tile width tile_n (64, 128 or 256) over tiles_n * groups
// blocks; writes y and partial ([2][groups][N]).
inline cudaError_t launch(int tile_n, bool relu, bool affine, const bf16* x, const bf16* w,
                          const float* scale, const float* bias, bf16* y, float* partial, int M,
                          int K, int N, int groups, cudaStream_t st) {
  if (tile_n == 256) return launch_flags<256>(relu, affine, x, w, scale, bias, y, partial, M, K, N, groups, st);
  if (tile_n == 128) return launch_flags<128>(relu, affine, x, w, scale, bias, y, partial, M, K, N, groups, st);
  if (tile_n == 64) return launch_flags<64>(relu, affine, x, w, scale, bias, y, partial, M, K, N, groups, st);
  return cudaErrorInvalidValue;
}

}  // namespace bnwg
