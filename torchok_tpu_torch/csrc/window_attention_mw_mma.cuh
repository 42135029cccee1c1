// K6 in bf16 on Hopper's tensor cores: SwinV2 cosine window attention on
// pre-partitioned, head-major windows, forward, with the f32 numerics of the
// Pallas kernel it replaces, torchok_tpu/ops/window_attention.py::
// _wa_kernel_mw (:88; its pallas_call :134). Entered from
// window_attention_mw_fwd.cu for bf16 q, k, v at head dim 32 and L = 16 or
// 64 (window_attention_mw_fwd_route); f32, and bf16 at head dim 8, stay on
// the FMA template there.
//
// The contract: q, k, v (B_, H, L, 32) bf16, logit_scale (H,) f32, bias (H,
// L, L) f32, mask (n_mask, L, L) f32 or null, window i taking mask row
// i % n_mask;
//   out = softmax(qn kn^T * exp(min(logit_scale_h, ln 100)) + bias_h + mask) v
// with qn = q rsqrt(sum q^2 + 1e-12) (kn likewise), everything f32 from the
// loads to the one rounding of the output. K1's bf16 kernel rounds qn, kn and
// the weights to bf16; at a temperature of up to 100 that moves the logits by
// tenths, so this kernel does neither. Two exact rewrites put both products
// on mma.sync.m16n8k16 (bf16 operands, f32 accumulators) all the same:
//  * QK^T on the raw q and k, which are bf16 values: the products are exact
//    and sum in f32; then logit = fma(q.k, rq rk s, bias) + mask with rq =
//    rsqrt(sum q^2 + 1e-12) from the f32 squares of the A fragments in
//    registers and rk from the B fragments of the same product (summed over
//    the quad, then fetched by shuffles for the accumulator's columns). The
//    plain version rounds qn and kn to f32 before the product and adds
//    (x s) + bias: here the scale and the bias add in one fma, then the mask,
//    as the plain version adds it, last. Differences: f32 roundings.
//  * PV with a32 = e / l split as hi = bf16(a32), lo = bf16(a32 - hi): two
//    products against v (exact in bf16) into the same f32 accumulators leave
//    at most 2^-17 |a32| of each weight out, against bf16(a32)'s 2^-9.
// One key tile (L <= 64): the row max, e = exp(logit - m) (base 2), l and
// a32 come from one QK^T held in registers (one sweep).
//
// Grid by what is shared: a block per (mask row w, head h, slice of the
// windows w, w + n_mask, w + 2 n_mask, ...), all of which take mask row w
// (no mask: every window shares the bias, one row). It loads its f32 bias
// tile h and mask tile w once, 16 bytes a thread by cp.async, their 8-float
// chunks swizzled by row so that the float2 reads of a warp's accumulator
// layout hit 32 banks, then walks its slice: each window's q, k and v rows
// (contiguous 64-byte rows) come through a two-stage cp.async ring into
// 80-byte shared rows (ldmatrix without bank conflicts), the next window
// loading while the current one computes; one barrier a step. Four warps, a
// warp per 16 query rows: one window a step at L = 64, four at L = 16. The
// output is rounded once, staged in the warp's own q rows and stored 16
// bytes a lane. The slices are sized by ops.window_attention.forward_plan
// to about one wave of blocks.
//
// What bounds it: q, k, v in and the output out are 8 bytes per token and
// channel (1.91 GB at swinv2_tiny's 12 blocks at bs 128: 0.57 ms at
// 3.35 TB/s); per logit it does 3 x 64 FLOPs on the tensor cores and some
// 35 instructions a thread (the logit, the exponential, the split, the
// norms, the addresses: about 1,500 in the L = 64 kernel's SASS). On the
// H100 it takes about twice the bytes' time, bound by neither alone but by
// the instructions around the products and the loads' latency: builds with
// a phase left out (tools/time_window_mw_variants.py) saved 13 to 15%
// without the q, k, v loads, 2 to 8% without the norms, 3 to 5% without
// the lo product, 0 to 3% without the exponentials (the spread is the
// calls'). The keys' inverse norms once a block into shared memory (a
// second barrier a step) and the mask summed into the bias tile once a
// block gained 0 to 3% and were dropped (PERF.md).
#pragma once
#include "swin_mma_common.cuh"

namespace mw_mma {

using namespace swin_mma;

constexpr int kThreads = 128;    // four warps, each 16 query rows
constexpr int kRingRows = 64;    // rows of q (and of k, of v) in a ring stage: 64 / L windows
constexpr float kLn100 = 4.605170185988092f;

// The block's shared memory: the bias tile and the mask tile (f32 L x L),
// then two ring stages of q, k and v rows.
__host__ __device__ constexpr size_t shared_bytes(int L, bool has_mask) {
  return (size_t)(has_mask ? 2 : 1) * L * L * sizeof(float) +
         (size_t)2 * 3 * kRingRows * kRow * sizeof(bf16);
}

// Column c of row r of an f32 L x L tile: chunk (c / 8) ^ swizzle(r) of its
// row, so that the float2 reads of rows g (g < 4 in a half warp), columns
// 8 n + 2 t hit 32 different banks.
template <int L>
__device__ __forceinline__ int tile_at(int r, int c) {
  constexpr int kChunks = L / 8;
  const int swizzle = L == 64 ? r : r >> 1;
  return r * L + ((((c >> 3) ^ swizzle) & (kChunks - 1)) << 3) + (c & 7);
}

template <int L>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src) {
  for (int idx = threadIdx.x; idx < L * L / 4; idx += kThreads) {
    const int r = idx / (L / 4);
    const int c = (idx - r * (L / 4)) * 4;
    cp_async16(dst + tile_at<L>(r, c), src + r * L + c, true);
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

// acc (16 rows x 32 channels) += (hi + lo) v over the window's keys: hi =
// bf16(a32), lo = bf16(a32 - hi) of the accumulator-layout weights p,
// repacked in registers as the A operand; each v fragment feeds both.
template <int kPairs>
__device__ __forceinline__ void pv_split(float (&acc)[4][4], const float (&p)[2 * kPairs][4],
                                         const bf16* sv) {
  const int lane = threadIdx.x & 31;
  const int off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kRow + (lane >> 4) * 8;
#pragma unroll
  for (int kp = 0; kp < kPairs; ++kp) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = p[2 * kp + (i >> 1)][2 * (i & 1)];
      const float x1 = p[2 * kp + (i >> 1)][2 * (i & 1) + 1];
      hi[i] = pack_bf16(x0, x1);
      const float2 h = unpack_bf16(hi[i]);
      lo[i] = pack_bf16(x0 - h.x, x1 - h.y);
    }
#pragma unroll
    for (int nc = 0; nc < 2; ++nc) {
      uint32_t f[4];
      ldsm_x4_trans(f, sv + off + 16 * kp * kRow + 16 * nc);
      mma16816(acc[2 * nc], hi, f[0], f[1]);
      mma16816(acc[2 * nc + 1], hi, f[2], f[3]);
      mma16816(acc[2 * nc], lo, f[0], f[1]);
      mma16816(acc[2 * nc + 1], lo, f[2], f[3]);
    }
  }
}

// One window for the warp's 16 query rows r0 .. r0 + 15: sq, sk, sv are the
// window's rows in the ring, tb and tm the bias and mask tiles; the output
// rows go to dst (the window's (h) slab, row r0) through the warp's q rows.
template <int L, bool kHasMask>
__device__ __forceinline__ void window(bf16* sq, const bf16* sk, const bf16* sv, const float* tb,
                                       const float* tm, float s, int r0, bf16* __restrict__ dst) {
  constexpr int kPairs = L / 16;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  uint32_t aq[2][4];
  load_a(aq, sq, r0);
  // rq s of rows gr and gr + 8 from the f32 squares of the A fragments
  float qs[2] = {0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = unpack_bf16(aq[ks][i]);
      qs[i & 1] = fmaf(x.y, x.y, fmaf(x.x, x.x, qs[i & 1]));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qs[r] += __shfl_xor_sync(0xffffffffu, qs[r], 1);
    qs[r] += __shfl_xor_sync(0xffffffffu, qs[r], 2);
    qs[r] = rsqrtf(qs[r] + kNormEps) * s;
  }
  // q k^T on the raw rows, and rk of the accumulator's columns 8 n + 2 tc + e
  float sc[2 * kPairs][4], rk[2 * kPairs][2];
  const int koff = ((lane & 7) + (lane >> 4) * 8) * kRow + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    float ss[2] = {0.f, 0.f};  // keys 16 p + gr and 16 p + 8 + gr, this lane's channels
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[2 * p][e] = sc[2 * p + 1][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t fx[4];
      ldsm_x4(fx, sk + koff + 16 * p * kRow + 16 * ks);
      mma16816(sc[2 * p], aq[ks], fx[0], fx[1]);
      mma16816(sc[2 * p + 1], aq[ks], fx[2], fx[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack_bf16(fx[i]);
        ss[i >> 1] = fmaf(x.y, x.y, fmaf(x.x, x.x, ss[i >> 1]));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 1);
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 2);
      const float rn = rsqrtf(ss[i] + kNormEps);  // key 16 p + 8 i + gr
#pragma unroll
      for (int e = 0; e < 2; ++e) rk[2 * p + i][e] = __shfl_sync(0xffffffffu, rn, 4 * (2 * tc + e));
    }
  }
  // logits, row max, e = exp(logit - m), l, a32 = e / l
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = tile_at<L>(r0 + gr + 8 * r, 8 * n + 2 * tc);
      const float2 bv = *reinterpret_cast<const float2*>(tb + at);
      float x0 = fmaf(sc[n][2 * r], qs[r] * rk[n][0], bv.x);
      float x1 = fmaf(sc[n][2 * r + 1], qs[r] * rk[n][1], bv.y);
      if (kHasMask) {
        const float2 mv = *reinterpret_cast<const float2*>(tm + at);
        x0 += mv.x;
        x1 += mv.y;
      }
      sc[n][2 * r] = x0;
      sc[n][2 * r + 1] = x1;
      m2[r] = fmaxf(m2[r], fmaxf(x0, x1));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m2[r] = fmaxf(m2[r], __shfl_xor_sync(0xffffffffu, m2[r], 1));
    m2[r] = fmaxf(m2[r], __shfl_xor_sync(0xffffffffu, m2[r], 2));
    m2[r] *= kLog2e;
  }
#pragma unroll
  for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = exp_minus(sc[n][e], m2[e >> 1]);
      l[e >> 1] += sc[n][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
#pragma unroll
  for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] *= l[e >> 1];
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  pv_split<kPairs>(acc, sc, sv);
  // round once; the warp's q rows (read only by this warp, into aq) hold
  // its 16 x 32 outputs, which leave 16 bytes a lane
  bf16* stage = sq + r0 * kRow;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<uint32_t*>(stage + (gr + 8 * r) * kRow + 8 * n + 2 * tc) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = lane + 32 * i;
    const int row = idx >> 2, part = idx & 3;
    *reinterpret_cast<uint4*>(dst + row * kD + part * 8) =
        *reinterpret_cast<const uint4*>(stage + row * kRow + part * 8);
  }
}

// A block per (mask row w, head h, slice of `windows` of the windows w +
// j n_mask); without a mask (kHasMask false) n_mask is 1. B: windows (B_).
template <int L, bool kHasMask>
__global__ void __launch_bounds__(kThreads)
mw_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ logit_scale,
              const float* __restrict__ bias, const float* __restrict__ mask,
              bf16* __restrict__ out, int B, int H, int n_mask, int windows) {
  static_assert(L == 16 || L == 64, "L is 16 or 64");
  constexpr int kWarpsPerWindow = L / 16;
  constexpr int kWindowsPerStep = kRingRows / L;
  constexpr int kStage = 3 * kRingRows * kRow;  // bf16 of a ring stage: q, k, v rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tb = reinterpret_cast<float*>(smem_raw);  // [L * L] bias of head h
  float* tm = tb + L * L;                          // [L * L] mask row w (with a mask)
  bf16* ring = reinterpret_cast<bf16*>(tb + (kHasMask ? 2 : 1) * L * L);  // [2][3][64][kRow]
  const int w = blockIdx.x % n_mask;
  const int j0 = (blockIdx.x / n_mask) * windows;
  const int nwin = min(windows, B / n_mask - j0);  // the last slice may be shorter
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int slot = warp / kWarpsPerWindow;  // the warp's window in a step
  const int r0 = 16 * (warp % kWarpsPerWindow);
  const float s = expf(fminf(logit_scale[h], kLn100));
  const size_t slab = (size_t)L * kD;  // bf16 of one (window, head)
  // window j of the slice: w + (j0 + j) n_mask; its (h) slab
  auto slab_of = [&](int j) { return ((size_t)(w + (size_t)(j0 + j) * n_mask) * H + h) * slab; };
  // the q, k and v rows of step `step`'s windows into ring stage st: thread
  // t takes 16-byte part t % 4 of ring rows t / 4 and t / 4 + 32 (slot *
  // L + the row of the slot's window)
  static_assert(kThreads / 2 == kRingRows, "two ring rows a thread quad");
  auto load_step = [&](int st, int step) {
    const int part = threadIdx.x & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (threadIdx.x >> 2) + half * (kThreads / 4);
      const int j = step * kWindowsPerStep + row / L;
      if (j < nwin) {
        const size_t src = slab_of(j) + (size_t)(row % L) * kD + part * 8;
        bf16* dst = ring + st * kStage + row * kRow + part * 8;
        cp_async16(dst, q + src, true);
        cp_async16(dst + kRingRows * kRow, k + src, true);
        cp_async16(dst + 2 * kRingRows * kRow, v + src, true);
      }
    }
  };

  load_tile<L>(tb, bias + (size_t)h * L * L);
  if (kHasMask) load_tile<L>(tm, mask + (size_t)w * L * L);
  load_step(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int steps = (nwin + kWindowsPerStep - 1) / kWindowsPerStep;
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const bool prefetch = step + 1 < steps;
    if (prefetch) {
      load_step(cur ^ 1, step + 1);
      cp_async_commit();
    }
    const int j = step * kWindowsPerStep + slot;
    if (j < nwin) {
      bf16* rows = ring + cur * kStage + slot * L * kRow;
      window<L, kHasMask>(rows, rows + kRingRows * kRow, rows + 2 * kRingRows * kRow, tb, tm, s,
                          r0, out + slab_of(j) + (size_t)r0 * kD);
    }
    if (prefetch) cp_async_wait_all();
    __syncthreads();  // stage cur is free; the next step's rows have landed
  }
}

// mask null: no mask (n_mask not read). windows: a block's slice (>= 1).
template <int L>
inline cudaError_t launch(const void* q, const void* k, const void* v, const void* logit_scale,
                          const void* bias, const void* mask, void* out, int B, int H, int n_mask,
                          int windows, cudaStream_t st) {
  const bool masked = mask != nullptr;
  const int rows = masked ? n_mask : 1;
  if (windows < 1 || rows < 1 || B % rows != 0) return cudaErrorInvalidValue;
  const long long gx = (long long)rows * ((B / rows + windows - 1) / windows);
  if (gx > 0x7fffffffLL || H > 65535) return cudaErrorInvalidValue;
  auto kernel = masked ? mw_fwd_kernel<L, true> : mw_fwd_kernel<L, false>;
  const size_t bytes = shared_bytes(L, masked);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, H), kThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(logit_scale), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), B, H, rows, windows);
  return cudaGetLastError();
}

}  // namespace mw_mma
