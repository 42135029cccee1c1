// The bf16 main loop of K8 (conv3x3_gemm.cu) for Hopper (sm_90a): a 3x3,
// stride 1, zero-padded convolution as an implicit GEMM on wgmma, fed by an
// asynchronous ring of shared-memory stages.
//
//   y (M = N*H*W, Cout) = A (M, 9*Cin) @ W (9*Cin, Cout),  f32 accumulation,
// where row m of A is the nine 3x3 neighbours of output pixel m, never built
// in memory, and W is the HWIO weight read as the (9*Cin, Cout) matrix it is.
//
// Design (why the first version was slow: loads, products and bookkeeping
// added up; see gemm_tile.cuh):
//  * warp specialisation, one block per SM, persistent over the output tiles
//    (tile t, t + gridDim.x, ...; Cout tiles fastest, so the gathered rows of
//    x are shared through L2 by neighbouring blocks): NC consumer warpgroups,
//    then one producer warpgroup. Tiles are 192 x 128 (three consumers, one
//    64-row block each) or, at Cout <= 64, 256 x 64 (two consumers, two
//    blocks each): taller tiles read W less often per product;
//  * the producer walks each tile's depth in slabs of 64 channels of one tap
//    (channel chunk outer, tap inner) through a ring of four stages. A is
//    gathered with 16-byte cp.async copies, zero-filled (source size 0) at
//    the image border, past Cin and past M; each producer thread works out
//    once per tile its rows' pixel addresses and a 9-bit mask of the taps
//    inside the image, so a copy in the inner loop is a bit test, an add and
//    the copy (no division). W comes by TMA (one box of 64 depth rows x 64
//    output channels per 64 columns, issued by one thread, zeros outside the
//    matrix). A stage is full when the producer's 128 cp.async arrivals
//    (cp.async.mbarrier.arrive) and W's TMA bytes have reached its mbarrier;
//  * each consumer warpgroup issues wgmma.m64nBNk16 (bf16 operands straight
//    from shared memory, f32 accumulators in registers), four per slab and
//    row block, keeps one slab's products in flight and frees a stage
//    through an mbarrier once its products are done. Operands sit in the
//    128-byte-swizzled layout the descriptors read: A K-major (a 128-byte
//    row of 64 channels per pixel), W N-major (a 128-byte row of 64 output
//    channels per depth row, two such column blocks for BN = 128);
//  * the epilogue rounds the f32 tile once to bf16; the four lanes that share
//    a row exchange their pairs with shuffles so that each stores 16 bytes,
//    while the producer already fills the ring for the next tile.
// The sums run in a fixed order: bit-identical results from run to run.
// Variants timed in one process on an NVIDIA H100 80GB HBM3, 700.00 W
// (PERF.md): the cp.async gathers bound it (with the products compiled out it
// ran nearly as long); TMA for W, the tap masks, three consumers and the
// 16-byte stores each took 5% to 17% off; a deeper ring and bypassing L1 for
// A changed nothing.
//
// What bounds it: ResNet-50's four 3x3 shapes at batch 256 are 59.2 GFLOP
// each against at most 0.2 GB that must move, so the tensor cores bound it
// (0.060 ms at 989 TFLOP/s); in practice the gathers into shared memory
// (every x element nine times) come first.
#pragma once
#include "hopper_async.cuh"

namespace convwg {

using namespace hopper;

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                 // depth per slab: 64 channels of one tap, 128 bytes
constexpr int kProducerThreads = 128;   // one warpgroup, after the consumers

// A tile is BM = 64 NC MW output pixels by BN output channels: NC consumer
// warpgroups each own MW blocks of 64 rows. Taller tiles read W less often
// per product.
template <int BN, int NC, int MW> struct Config {
  static_assert((BN == 64 || BN == 128) && (NC == 2 || NC == 3) && (MW == 1 || MW == 2),
                "tile shapes");
  static constexpr int kConsumerThreads = 128 * NC;
  static constexpr int kThreads = kConsumerThreads + kProducerThreads;
  static constexpr int kBM = 64 * NC * MW;
  static constexpr int kABytes = kBM * kBK * 2;  // 16 or 32 KB
  static constexpr int kBBytes = kBK * BN * 2;   // 8 or 16 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = 4;
  static constexpr int kARows = kBM * 8 / kProducerThreads;  // A rows a producer thread fills
  static constexpr int kAccum = MW * BN / 2;     // f32 accumulators a consumer thread holds
  // the ring, its barriers, and room to align the ring to 1024 bytes
  static constexpr size_t kSharedBytes = 1024 + (size_t)kStages * kStageBytes + 2 * kStages * 8;
};

// The barrier's pending count drops by one when this thread's earlier
// cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// 16 bytes from device memory to shared memory; src_bytes 0 writes zeros
// and reads nothing. .ca keeps the line in L1 (the nine taps of a gathered
// pixel).
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// d[32] += A (64 x 16, K-major, smem) * B (16 x 64, N-major, smem); the first
// of a tile (accumulate == 0) overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64] += A (64 x 16, K-major, smem) * B (16 x 128, N-major, smem); the first
// of a tile (accumulate == 0) overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
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
      "}, %64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 128) {
    wgmma_m64n128k16(d, da, db, acc);
  } else {
    wgmma_m64n64k16(d, da, db, acc);
  }
}

// w_map: the TMA map of W as the (9*Cin, Cout) matrix, boxes of 64 rows by
// 64 columns, 128-byte swizzle, zeros outside (make_weight_map).
template <int BN, int NC, int MW>
__global__ void __launch_bounds__(Config<BN, NC, MW>::kThreads, 1)
conv3x3_wgmma_kernel(const bf16* __restrict__ x, const __grid_constant__ CUtensorMap w_map,
                     bf16* __restrict__ y, int M, int H, int W, int Cin, int Cout, int tiles_n,
                     int tiles) {
  using Cfg = Config<BN, NC, MW>;
  constexpr int kConsumerThreads = Cfg::kConsumerThreads;
  constexpr int kStages = Cfg::kStages;
  constexpr int kBM = Cfg::kBM;
  constexpr int kARows = Cfg::kARows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * Cfg::kStageBytes;  // full[s] at full + 8 s
  const uint32_t empty = full + kStages * 8;                // empty[s] at empty + 8 s
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // one cp.async arrival per producer thread, one with W's TMA bytes
      mbar_init(full + 8 * s, kProducerThreads + 1);
      mbar_init(empty + 8 * s, NC);               // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int kchunks = (Cin + kBK - 1) / kBK;
  const int HW = H * W;

  if (tid >= kConsumerThreads) {
    // ---------------- producer: the last warpgroup ----------------
    const int t = tid - kConsumerThreads;
    const int ac = t % 8;  // the 16-byte chunk (8 channels) of its A rows
    const int ar = t / 8;  // A rows ar + 16 i
    // swizzled offset within the A stage; row ar + 16 i adds 2048 i bytes
    const uint32_t a_off = ar * 128 + ((ac ^ (ar & 7)) * 16);
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM;
      const int n0 = (tile % tiles_n) * BN;
      // once per tile: each A row's own 16-byte chunk, and a bit for each of
      // the nine taps that falls inside the image (none past M)
      const bf16* arow[kARows];
      uint32_t taps[kARows];
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const int m = m0 + ar + 16 * i;
        arow[i] = x;
        taps[i] = 0;
        if (m < M) {
          const int rem = m % HW;
          const int yy = rem / W;
          const int xx = rem - yy * W;
          arow[i] = x + (long long)m * Cin + 8 * ac;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const bool in = (unsigned)(yy + tap / 3 - 1) < (unsigned)H &&
                            (unsigned)(xx + tap % 3 - 1) < (unsigned)W;
            taps[i] |= (uint32_t)in << tap;
          }
        }
      }
      for (int kc = 0; kc < kchunks; ++kc) {
        const int c0 = kc * kBK;
        const bool a_chan = c0 + 8 * ac < Cin;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const long long tap_off = (long long)((tap / 3 - 1) * W + tap % 3 - 1) * Cin + c0;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t sa = ring + stage * Cfg::kStageBytes;
          const uint32_t sb = sa + Cfg::kABytes;
          if (t == 0) {
            // W rows tap * Cin + c0 .. + 63, one box per 64 columns: N-major
            // blocks of 64 columns, 128-byte rows, the layout the descriptor
            // reads. Rows past Cin belong to the next tap and meet zero A
            // channels; rows past 9 Cin and columns past Cout are zeros.
            mbar_arrive_expect_tx(full + 8 * stage, Cfg::kBBytes);
#pragma unroll
            for (int nb = 0; nb < BN / 64; ++nb) {
              tma_load_2d(sb + nb * (kBK * 128), &w_map, n0 + 64 * nb, tap * Cin + c0,
                          full + 8 * stage);
            }
          }
#pragma unroll
          for (int i = 0; i < kARows; ++i) {
            const bool ok = a_chan && ((taps[i] >> tap) & 1u);
            cp_async_ca(sa + a_off + i * 2048, ok ? arow[i] + tap_off : x, ok ? 16u : 0u);
          }
          cp_async_arrive(full + 8 * stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---------------- consumers: warpgroups 0 to NC - 1 ----------------
    const int wg = tid / 128;  // row blocks MW wg .. MW wg + MW - 1 (64 rows each) of the tile
    const int slabs = 9 * kchunks;
    // W descriptor (N-major): 64-column blocks kBK * 128 bytes apart (leading
    // offset), groups of 8 depth rows 1024 apart (stride), a k16 step 16 rows;
    // A (K-major): groups of 8 rows 1024 apart, a k16 step 32 bytes
    constexpr uint32_t kBLead = kBK * 128;
    constexpr uint32_t kBStride = 1024;
    constexpr uint32_t kBStep = 16 * 128;
    float acc[MW][BN / 2];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM;
      const int n0 = (tile % tiles_n) * BN;
      int prev = 0;
      for (int j = 0; j < slabs; ++j) {
        mbar_wait(full + 8 * stage, phase);
        // the copies landed through the generic proxy; wgmma reads through the async one
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t sa = ring + stage * Cfg::kStageBytes + wg * MW * 64 * 128;
        const uint32_t sb = ring + stage * Cfg::kStageBytes + Cfg::kABytes;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            wgmma_tile<BN>(acc[mi], make_desc(sa + mi * 64 * 128 + ks * 32, 16, 1024),
                                    make_desc(sb + ks * kBStep, kBLead, kBStride),
                                    (j > 0 || ks > 0) ? 1 : 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slab's products are done with their stage
        if (j > 0 && tid % 128 == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) fence_accumulators(acc[mi]);
      if (tid % 128 == 0) mbar_arrive(empty + 8 * prev);

      // epilogue: thread (warp w, lane l) of the warpgroup holds rows
      // 16 w + l / 4 (+ 8) and columns 8 i + 2 (l % 4) (+ 1) of each 64 x BN
      // block: the four lanes of a quad share a row. Over four 8-column blocks
      // they exchange their bf16 pairs (quad_transpose), so that each lane
      // stores 16 bytes, one block of its row.
      const int lane = tid % 32;
      const int q = lane % 4;
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        const int rbase = m0 + (wg * MW + mi) * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = rbase + 8 * half;
#pragma unroll
          for (int g = 0; g < BN / 32; ++g) {
            uint32_t words[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int i = 4 * g + b;
              words[b] = pack_bf16(acc[mi][4 * i + 2 * half], acc[mi][4 * i + 2 * half + 1]);
            }
            const uint4 chunk = quad_transpose(words, q);
            const int col = n0 + 8 * (4 * g + q);
            if (row < M && col < Cout) {
              *reinterpret_cast<uint4*>(y + (long long)row * Cout + col) = chunk;
            }
          }
        }
      }
    }
  }
}

// The TMA map of W (HWIO, read as the (9*Cin, Cout) matrix): boxes of 64
// rows by 64 columns, 128-byte swizzle, zeros outside.
inline cudaError_t make_weight_map(CUtensorMap* map, const bf16* w, int Cin, int Cout) {
  const cuuint64_t dims[2] = {(cuuint64_t)Cout, (cuuint64_t)9 * Cin};
  const cuuint64_t strides[1] = {(cuuint64_t)Cout * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)kBK};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// Persistent grid: one block per SM, at most one per tile.
template <int BN, int NC, int MW>
cudaError_t launch(const bf16* x, const bf16* w, bf16* y, int M, int H, int W, int Cin, int Cout,
                   int sms, cudaStream_t stream) {
  using Cfg = Config<BN, NC, MW>;
  auto kernel = conv3x3_wgmma_kernel<BN, NC, MW>;
  constexpr size_t bytes = Cfg::kSharedBytes;
  constexpr int kBM = Cfg::kBM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles_n = (Cout + BN - 1) / BN;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * tiles_n;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  CUtensorMap w_map;
  err = make_weight_map(&w_map, w, Cin, Cout);
  if (err != cudaSuccess) return err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, Cfg::kThreads, bytes, stream>>>(x, w_map, y, M, H, W, Cin, Cout, tiles_n,
                                                 (int)tiles);
  return cudaGetLastError();
}

}  // namespace convwg
