// The window attention forward on Hopper's tensor cores, for bf16 inputs,
// in three modes (template flags <kCosine, kHasBias, kGlobal> of
// swin_fwd_kernel; valid_mode with kShifted false):
//  * kCosine: the SwinV2 cosine window attention (K1; every window size, L =
//    ws*ws up to 576; the shift mask is a run-time argument). Entered from
//    swin_attention_fwd.cu. qn and kn are rounded to bf16, then QK^T * scale
//    + bias (+ mask).
//  * plain, local (K3a; GCViT local and DaViT spatial blocks, L up to 256,
//    with or without a bias): logits = (q k^T) * scale (+ bias), q and k as
//    they come. Entered from window_attention_fwd.cu. Without a bias no bias
//    tile is read and none is in the ring.
//  * plain, global queries (K4; GCViT global blocks): the same with the
//    query rows taken from qg (B, L, C), shared by an image's windows.
//    Entered from window_attention_global_fwd.cu. Up to L = 64 (one key
//    tile) global_fwd_kernel takes it: a block per (slice of the image's
//    windows, head, image) holds its q tile as mma operands in registers and
//    its bias tile in shared memory, and walks its windows in order, the
//    next window's pixel table, k and v loading while the current one
//    computes. Above it (L = 196) the mode is the local one with q from qg.
// The f32 launches of all three stay on the FMA templates. In every mode
// QK^T accumulates in f32, a32 = exp(logit - m) / l with the row's final max
// m and sum l, a = bf16(a32), PV accumulates in f32 and the output is
// rounded once.
//
// Both products are mma.sync.m16n8k16 (bf16 operands from ldmatrix, f32
// accumulators): a warp owns 16 query rows, head dim 32 is two k16 steps,
// and the f32 weights are repacked in registers as the bf16 A operand of PV.
// L is cut into ceil(L / 64) tiles of one height, a multiple of 16 (64, or
// 48 at L = 36 and 144; swin_mma::tile_rows), padded to a multiple of 16
// inside the last tile: a padded key has logit -inf and weight 0, a padded
// query row is zero and never stored.
//
// The cosine mode makes three launches (swin_attention_fwd.cu), no atomics:
//  * combine_bias_mask (shifted blocks only): bias + mask once per launch
//    into an (nW, H, L, L) f32 scratch, as the logits add them;
//  * normalize_k: kn of every pixel and head into a (B, Hp, Wp, C) bf16
//    scratch, once per launch rather than once per query tile;
//  * swin_fwd_kernel, a block per (window position, query tile, head, two
//    images), a warp per 16 query rows, which it takes for each image in
//    turn. The key tiles (kn and v of each image, and the 64-wide f32 tile
//    of bias rows that both images share) stream through a two-stage
//    cp.async ring twice: the first sweep takes qn kn^T to the row
//    statistics (max and sum in flash form, base-2 exponentials), the second
//    takes qn kn^T again to a32 with the final statistics and adds bf16(a32)
//    v into the output's accumulators. A single sweep that rounds
//    exp(logit - m_running) and divides by l at the end would not round the
//    reference's bf16(a32), so the statistics come first. Rows arrive by
//    16-byte cp.async from the unpartitioned layout through the window's
//    pixel table into 80-byte shared rows that ldmatrix reads without bank
//    conflicts; the bias reaches the block as tiles by cp.async (rows of 64
//    floats, their 8-float chunks swizzled by row), never element by element
//    from device memory. The tile height is a template argument (64, or 48
//    at L = 36 and 144), and a tile whose keys are all real (every tile but
//    the last at L = 36) takes no per-column tests.
//
// What bounds it: per logit 3 * 64 FLOPs on the tensor cores, 2
// exponentials and about 16 instructions a thread, and about 10 bytes moved
// from L2 into shared memory (the bias tiles, 4 bytes a sweep for two
// images, and the kn and v tiles, which every query tile reads again). On
// the H100 the loads' instructions and latency cost about a third of its time
// (with the ring's loads compiled out it ran 28 to 36% faster at L >= 144),
// the barriers 2 to 6%, the exponentials up to 4% and the QK^T products up
// to 7%: neither the tensor cores nor device memory nor L2 bandwidth bound
// it (two images a block halved the bias bytes and gained up to 4%).
// PERF.md has the variants and their times.
//
// The plain modes launch no normalize_k and no combine_bias_mask; at L = 49
// the bias rows (196 bytes) are not 16-byte aligned, so pad_bias first copies
// them into rows of 52 floats, as the backward does, except for the window
// walk, which loads its one bias tile per slice of windows 4 bytes a thread
// from the unpadded rows (the two ways measured: PERF.md). With one key
// tile (L <= 64) they take the statistics, bf16(a32) and PV from one QK^T
// held in registers (single_sweep; the same bits as two sweeps); two sweeps
// only where there is more than one key tile (L = 196).
#pragma once
#include "swin_mma_common.cuh"

namespace swin_fwd {

using namespace swin_mma;

constexpr int kBiasRow = kTile;  // f32 per shared bias row, 8-float chunks swizzled by row

// The kernel's tile height: tile_rows(L) (48 or 64 when L > 64), and 48
// for the few L <= 32 whose tile would be shorter (none is a SwinV2 window).
__host__ __device__ constexpr int fwd_tile_rows(int L) { return tile_rows(L) > 48 ? 64 : 48; }

// A block's shared memory in the cosine mode for kImages images: for each
// of the two ring stages, a tile's bias rows (f32, shared by the images)
// and each image's kn and v rows (bf16); the q rows wait in stage 1's bias
// rows until the loop starts. Two images: 74 KB at L = 256 and 576 (three
// blocks an SM), 55 KB at L = 36 and 144 (four).
__host__ __device__ constexpr size_t shared_bytes(int L, int images) {
  return (size_t)2 * fwd_tile_rows(L) *
             (kBiasRow * sizeof(float) + 2 * images * kRow * sizeof(bf16)) +  // the ring
         (size_t)L * sizeof(int);                                               // pixel table
}

// Rows i0 .. i0 + kRows and columns j0 .. j0 + kRows of the (L, L) f32
// matrix src, whose rows lie ld floats apart (ld >= L), into dst by cp.async,
// zeros outside the matrix. Column c of row
// r lands in 8-float chunk (c / 8) ^ (r % 8) of the row, so that the float2
// reads of a warp's accumulator layout (rows g, columns 2t in each chunk)
// hit 32 different banks. The block's 2 kRows threads take 8 chunks of 16
// bytes each, at fixed columns (4-byte copies when ld is not a multiple of 4).
__device__ __forceinline__ int bias_at(int r, int c) {
  return r * kBiasRow + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

template <int kRows>
__device__ __forceinline__ void load_bias_rows(float* dst, const float* __restrict__ src, int i0,
                                               int j0, int L, int ld) {
  if ((ld & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int c = (threadIdx.x & 15) * 4;
    if (c < kRows) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = (threadIdx.x >> 4) + k * (kRows / 8);
        const bool valid = i0 + r < L && j0 + c < L;
        cp_async16(dst + bias_at(r, c), src + (valid ? (size_t)(i0 + r) * ld + j0 + c : 0),
                   valid);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * kTile; idx += blockDim.x) {
      const int r = idx >> 6;
      const int c = idx & 63;
      const bool valid = c < kRows && i0 + r < L && j0 + c < L;
      cp_async4(dst + bias_at(r, c), src + (valid ? (size_t)(i0 + r) * ld + j0 + c : 0), valid);
    }
  }
}

// The bias of each (window, head) in shifted blocks: out (nW, H, L, L) =
// bias (H, L, L) + mask (nW, L, L), in f32 as the logits add them.
__global__ void combine_bias_mask(const float* __restrict__ bias, const float* __restrict__ mask,
                                  float* __restrict__ out, int nheads, int nw, int ll) {
  const size_t n = (size_t)nw * nheads * ll;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t e = idx % ll;
    const size_t wh = idx / ll;
    out[idx] = bias[(wh % nheads) * ll + e] + mask[(wh / nheads) * ll + e];
  }
}

// kn of every pixel and head, with the arithmetic of normalize_rows, into
// kn (B, Hp, Wp, C): four threads a row of 32 channels.
__global__ void normalize_k(const bf16* __restrict__ qkv, bf16* __restrict__ kn, size_t npix,
                            int nheads) {
  const int C = nheads * kD;
  const size_t n = npix * nheads * 4;
  for (size_t i0 = (size_t)blockIdx.x * blockDim.x; i0 < n; i0 += (size_t)gridDim.x * blockDim.x) {
    const size_t idx = i0 + threadIdx.x;
    const bool on = idx < n;  // whole groups of four: n is a multiple of 4
    const size_t row = idx >> 2;  // pixel * nheads + head
    const int part = (int)(idx & 3);
    const size_t pix = row / nheads;
    const int h = (int)(row - pix * nheads);
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (on) raw = *reinterpret_cast<const uint4*>(qkv + pix * 3 * C + C + h * kD + part * 8);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    float v[8];
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = __bfloat162float(x[c]);
      ss = fmaf(v[c], v[c], ss);
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    const float rn = rsqrtf(ss + kNormEps);
    uint4 out;
    out.x = pack_bf16(v[0] * rn, v[1] * rn);
    out.y = pack_bf16(v[2] * rn, v[3] * rn);
    out.z = pack_bf16(v[4] * rn, v[5] * rn);
    out.w = pack_bf16(v[6] * rn, v[7] * rn);
    if (on) *reinterpret_cast<uint4*>(kn + row * kD + part * 8) = out;
  }
}

// s = A x^T for the warp's 16 rows (A: its operand over the head dim)
// against rows 0 .. 16 np of the shared array x (np <= kPairs pairs of
// 8-column n-tiles); the other n-tiles are zero.
template <int kPairs>
__device__ __forceinline__ void qk_product(const uint32_t (&a)[2][4], const bf16* x, int np,
                                           float (&s)[2 * kPairs][4]) {
  const int lane = threadIdx.x & 31;
  const int off = ((lane & 7) + (lane >> 4) * 8) * kRow + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * p][e] = s[2 * p + 1][e] = 0.f;
    if (p < np) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t fx[4];
        ldsm_x4(fx, x + off + 16 * p * kRow + 16 * ks);
        mma16816(s[2 * p], a[ks], fx[0], fx[1]);
        mma16816(s[2 * p + 1], a[ks], fx[2], fx[3]);
      }
    }
  }
}

// One key tile of one sweep for the warp's 16 rows: the logits qn kn^T * s
// + bias (-inf past L), then in the first sweep the row statistics (max m
// and sum l in flash form), in the second acc += bf16(a32) v with a32 =
// exp(logit - m) / l from the final statistics (m2 = m log2 e, linv = 1 / l).
// kPairs: pairs of 8-key n-tiles in a tile (tile rows / 16); kFull: every
// key of the tile is real (all tiles but the last at L = 36), so no column
// needs a test; !kHasBias: the logits are q k^T * s, no bias tile is read.
template <int kPairs, bool kFull, bool kHasBias = true>
__device__ __forceinline__ void key_tile(const uint32_t (&aq)[2][4], const bf16* sk,
                                         const bf16* sv, const float* tb, float s, int r0, int k0,
                                         int np, int L, bool statistics, float (&m)[2],
                                         float (&l)[2], const float (&m2)[2],
                                         const float (&linv)[2], float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  if (kFull) np = kPairs;
  float sc[2 * kPairs][4];
  qk_product<kPairs>(aq, sk, np, sc);
#pragma unroll
  for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = k0 + 8 * n + 2 * tc;
      const bool in = kFull || n < 2 * np;  // a column of this tile
      if constexpr (kHasBias) {
        const float2 bv =
            in ? *reinterpret_cast<const float2*>(tb + bias_at(r0 + gr + 8 * r, 8 * n + 2 * tc))
               : make_float2(0.f, 0.f);
        sc[n][2 * r] = kFull || (in && j < L) ? fmaf(sc[n][2 * r], s, bv.x) : -INFINITY;
        sc[n][2 * r + 1] =
            kFull || (in && j + 1 < L) ? fmaf(sc[n][2 * r + 1], s, bv.y) : -INFINITY;
      } else {
        sc[n][2 * r] = kFull || (in && j < L) ? sc[n][2 * r] * s : -INFINITY;
        sc[n][2 * r + 1] = kFull || (in && j + 1 < L) ? sc[n][2 * r + 1] * s : -INFINITY;
      }
    }
  if (statistics) {
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[n][e]);
    float tm2[2], rescale[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mnew = fmaxf(m[r], tmax[r]);  // key k0 is real: finite
      tm2[r] = mnew * kLog2e;
      rescale[r] = exp_minus(m[r], tm2[r]);
      m[r] = mnew;
    }
#pragma unroll
    for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += exp_minus(sc[n][e], tm2[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * rescale[r] + sum[r];
    }
  } else {
#pragma unroll
    for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = exp_minus(sc[n][e], m2[e >> 1]) * linv[e >> 1];
    product_into<kPairs>(acc, sc, sv, 0, np);
  }
}

// The plain modes' only key tile (L <= 64) for the warp's 16 rows, in one
// sweep: the logits q k^T * s (+ bias; -inf past L) stay in registers
// through the row max, the sum of e = exp(logit - m) and a32 = e / l, and
// acc += bf16(a32) v. With one key tile the two sweeps of key_tile give
// these bits too (its rescale is exp(-inf) = 0 and its second sweep
// recomputes the same e), so only a second key tile needs them.
template <int kPairs, bool kHasBias>
__device__ __forceinline__ void single_sweep(const uint32_t (&aq)[2][4], const bf16* sk,
                                             const bf16* sv, const float* tb, float s, int r0,
                                             int np, int L, float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  float sc[2 * kPairs][4];
  qk_product<kPairs>(aq, sk, np, sc);
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = 8 * n + 2 * tc;
      const bool in = n < 2 * np;  // a column of the tile
      float2 bv = make_float2(0.f, 0.f);
      if (kHasBias && in) {
        bv = *reinterpret_cast<const float2*>(tb + bias_at(r0 + gr + 8 * r, j));
      }
      sc[n][2 * r] = in && j < L ? (kHasBias ? fmaf(sc[n][2 * r], s, bv.x) : sc[n][2 * r] * s)
                                 : -INFINITY;
      sc[n][2 * r + 1] = in && j + 1 < L ? (kHasBias ? fmaf(sc[n][2 * r + 1], s, bv.y)
                                                     : sc[n][2 * r + 1] * s)
                                         : -INFINITY;
      m2[r] = fmaxf(m2[r], fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m2[r] = fmaxf(m2[r], __shfl_xor_sync(0xffffffffu, m2[r], 1));
    m2[r] = fmaxf(m2[r], __shfl_xor_sync(0xffffffffu, m2[r], 2));
    m2[r] *= kLog2e;  // key 0 is real: finite
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
  product_into<kPairs>(acc, sc, sv, 0, np);
}

// The warp's output rows, rounded once, through the window's pixel table.
__device__ __forceinline__ void store_output(bf16* __restrict__ image, int C, int h,
                                             const int* pix, int i0, int L,
                                             const float (&acc)[4][4]) {
  uint32_t packed[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n) packed[r][n] = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  store_rows(image, C, h * kD, pix, i0, L, packed);
}

// Modes <kCosine, kHasBias, kGlobal> (valid_mode with kShifted false): K1 is
// <true, true, false> and takes its shift at run time (shifted: bias is (nW,
// H, L, L) with the mask added), K3a <false, bias?, false>, K4 at L > 64
// <false, true, true>. proj: qkv (B, Hp, Wp, 3C), or kv (B, Hp, Wp, 2C) in
// global mode with qg (B, L, C); kn: the cosine mode's (B, Hp, Wp, C)
// scratch; bias rows lie ldb floats apart in the plain modes (L in the
// cosine one). kPairs = tile rows / 16: 4, or 3 at L = 36 and 144. The
// block takes images blockIdx.z * kImages .. (those below B); each warp
// takes its 16 rows of each in turn, so one bias tile of the ring serves them
// all. A plain mode with one key tile (L <= 64) needs no ring: its one step
// loads the keys, v and bias once (stage 0; stage 1 of k holds q).
template <int kPairs, int kImages, bool kCosine, bool kHasBias, bool kGlobal>
__global__ void __launch_bounds__(128, 3)
swin_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ kn,
                const float* __restrict__ scale, const float* __restrict__ bias,
                bf16* __restrict__ out, Geometry g, int shifted, const bf16* __restrict__ qg,
                int ldb) {
  static_assert(valid_mode<kCosine, false, kHasBias, kGlobal>(), "no such mode");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int tr = 16 * kPairs;         // rows of a tile; the block has kPairs warps
  constexpr int per = tr * kRow;          // bf16 of one image's rows of a tile
  const int L = g.L, C = g.C, width = (kGlobal ? 2 : 3) * C;
  const int ntiles = tiles_of(L);
  const bool one_sweep = !kCosine && ntiles == 1;
  const int stages = one_sweep ? 1 : 2;   // ring stages of the bias and v tiles
  float* sb = reinterpret_cast<float*>(smem_raw);                       // [stages][tr][kBiasRow]
  bf16* sk = reinterpret_cast<bf16*>(sb + (kHasBias ? stages * tr * kBiasRow : 0));
  bf16* sv = sk + 2 * kImages * per;                            // [stages][kImages][tr][kRow]
  int* spix = reinterpret_cast<int*>(sv + stages * kImages * per);  // [L] pixel table
  // [kImages][tr][kRow] q (cosine: qn) in stage 1 of the bias rows (cosine)
  // or of sk [2][kImages][tr][kRow] (plain: k, or kn)
  bf16* sq = kCosine ? reinterpret_cast<bf16*>(sb + tr * kBiasRow) : sk + kImages * per;
  const int win = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x - win * ntiles) * tr;
  const int h = blockIdx.y;
  const int l16 = (L + 15) & ~15;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's first row in the tile
  const bool active = q0 + r0 < L;         // the same for the whole warp
  const int b0 = blockIdx.z * kImages;
  const int nimg = min(kImages, g.B - b0);  // the last block may have fewer
  const float s = scale[h];
  const int ld = kCosine ? L : ldb;
  const float* bias_w =
      kHasBias ? bias + (size_t)(shifted ? win * g.nheads + h : h) * L * ld : nullptr;
  // the key tiles twice (statistics, then the output), or once
  const int nsteps = one_sweep ? 1 : 2 * ntiles;
  const size_t pixels = (size_t)g.Hp * g.Wp;

  fill_pixels(g, win, spix);
  // step's key tile (kn or k, bias; v in the second sweep) into ring stage st
  auto load_keys = [&](int st, int step) {
    const int k0 = (step < ntiles ? step : step - ntiles) * tr;
    for (int i = 0; i < nimg; ++i) {
      const size_t base = (b0 + i) * pixels;
      if (kCosine) {
        load_rows(sk + (st * kImages + i) * per, kn + base * C, C, h * kD, spix, k0, tr, L);
      } else {
        load_rows(sk + (st * kImages + i) * per, qkv + base * width, width,
                  (kGlobal ? 0 : C) + h * kD, spix, k0, tr, L);
      }
      if (ntiles == 1 || step >= ntiles) {
        load_rows(sv + (st * kImages + i) * per, qkv + base * width, width,
                  (kGlobal ? C : 2 * C) + h * kD, spix, k0, tr, L);
      }
    }
    if (kHasBias) load_bias_rows<tr>(sb + st * tr * kBiasRow, bias_w, q0, k0, L, ld);
  };
  __syncthreads();  // spix is ready
  for (int i = 0; i < nimg; ++i) {
    if (kGlobal) {
      load_dense_rows(sq + i * per, qg + (size_t)(b0 + i) * L * C, C, h * kD, q0, tr, L);
    } else {
      load_rows(sq + i * per, qkv + (b0 + i) * pixels * width, width, h * kD, spix, q0, tr, L);
    }
  }
  load_keys(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (kCosine) {
    normalize_rows(sq, sq, nimg * tr, nullptr);
    __syncthreads();
  }

  uint32_t aq[kImages][2][4];
  float m[kImages][2], l[kImages][2], m2[kImages][2], linv[kImages][2], acc[kImages][4][4];
#pragma unroll
  for (int i = 0; i < kImages; ++i) {
    if (active && i < nimg) load_a(aq[i], sq + i * per, r0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = -INFINITY;
      l[i][r] = m2[i][r] = linv[i][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }
  __syncthreads();  // sq is read: ring stage 1 is free

  for (int step = 0; step < nsteps; ++step) {
    const int k0 = (step < ntiles ? step : step - ntiles) * tr;
    const int cur = ntiles == 1 ? 0 : step & 1;
    const bool prefetch = ntiles > 1 && step + 1 < nsteps;
    if (prefetch) {
      load_keys(cur ^ 1, step + 1);
      cp_async_commit();
    }
    if (active) {
      const float* tb = sb + cur * tr * kBiasRow;
      const bool statistics = step < ntiles;
      const bool full = k0 + tr <= L;
      const int np = min(tr, l16 - k0) >> 4;
#pragma unroll
      for (int i = 0; i < kImages; ++i) {
        if (i < nimg) {
          const bf16* ck = sk + (cur * kImages + i) * per;
          const bf16* cv = sv + (cur * kImages + i) * per;
          if (one_sweep) {
            single_sweep<kPairs, kHasBias>(aq[i], ck, cv, tb, s, r0, np, L, acc[i]);
            continue;
          }
          if (full) {
            key_tile<kPairs, true, kHasBias>(aq[i], ck, cv, tb, s, r0, k0, kPairs, L, statistics,
                                             m[i], l[i], m2[i], linv[i], acc[i]);
          } else {
            key_tile<kPairs, false, kHasBias>(aq[i], ck, cv, tb, s, r0, k0, np, L, statistics,
                                              m[i], l[i], m2[i], linv[i], acc[i]);
          }
          if (step == ntiles - 1) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              m2[i][r] = m[i][r] * kLog2e;
              linv[i][r] = 1.f / l[i][r];
            }
          }
        }
      }
    }
    if (prefetch) cp_async_wait_all();
    __syncthreads();  // this stage's readers are done; the next one has landed
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kImages; ++i) {
      if (i < nimg) store_output(out + (b0 + i) * pixels * C, C, h, spix, q0 + r0, L, acc[i]);
    }
  }
}

// K4 with one key tile (L <= 64): a block per (slice of `windows` windows of
// an image, head, image), a warp per 16 query rows. Its q tile (from qg) and
// the head's bias tile are loaded once; the warp keeps q as mma A fragments
// in registers across the windows, which it takes in order in one sweep each.
// A window's k and v come through a two-stage ring and its pixel table
// through a ring of three, so that window w + 1's rows load and window w +
// 2's table fills while window w computes: one barrier a window.
template <int kPairs>
__host__ __device__ constexpr size_t walk_shared_bytes(int L) {
  return (size_t)16 * kPairs * (kBiasRow * sizeof(float) + 5 * kRow * sizeof(bf16)) +
         (size_t)3 * L * sizeof(int);
}

template <int kPairs>
__global__ void __launch_bounds__(128, 4)
global_fwd_kernel(const bf16* __restrict__ kv, const bf16* __restrict__ qg,
                  const float* __restrict__ scale, const float* __restrict__ bias, int ldb,
                  bf16* __restrict__ out, Geometry g, int windows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int tr = 16 * kPairs;
  constexpr int per = tr * kRow;
  float* sb = reinterpret_cast<float*>(smem_raw);          // [tr][kBiasRow] the head's bias
  bf16* sq = reinterpret_cast<bf16*>(sb + tr * kBiasRow);  // [tr][kRow] the image's q tile
  bf16* sk = sq + per;                                     // [2][tr][kRow]
  bf16* sv = sk + 2 * per;                                 // [2][tr][kRow]
  int* spix = reinterpret_cast<int*>(sv + 2 * per);        // [3][L] pixel tables
  const int L = g.L, C = g.C, width = 2 * C;
  const int h = blockIdx.y, b = blockIdx.z;
  const int w0 = blockIdx.x * windows;
  const int nwin = min(windows, g.nW - w0);
  const int np = (L + 15) >> 4;            // pairs of n-tiles with keys
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's first row
  const bool active = r0 < L;
  const float s = scale[h];
  const size_t pixels = (size_t)g.Hp * g.Wp;
  const bf16* image = kv + b * pixels * width;
  // window wi's k and v into ring stage st (its pixel table is ready)
  auto load_keys = [&](int st, int wi) {
    const int* pix = spix + (wi % 3) * L;
    load_rows(sk + st * per, image, width, h * kD, pix, 0, tr, L);
    load_rows(sv + st * per, image, width, C + h * kD, pix, 0, tr, L);
  };

  fill_pixels(g, w0, spix);
  if (nwin > 1) fill_pixels(g, w0 + 1, spix + L);
  __syncthreads();  // the first two tables are ready
  load_dense_rows(sq, qg + (size_t)b * L * C, C, h * kD, 0, tr, L);
  load_bias_rows<tr>(sb, bias + (size_t)h * L * ldb, 0, 0, L, ldb);
  load_keys(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t aq[2][4];
  if (active) load_a(aq, sq, r0);

  for (int wi = 0; wi < nwin; ++wi) {
    const int cur = wi & 1;
    const bool prefetch = wi + 1 < nwin;
    if (prefetch) {
      load_keys(cur ^ 1, wi + 1);
      cp_async_commit();
    }
    // table wi + 2 was window wi - 1's, whose stores are behind the barrier
    if (wi + 2 < nwin) fill_pixels(g, w0 + wi + 2, spix + ((wi + 2) % 3) * L);
    if (active) {
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      single_sweep<kPairs, true>(aq, sk + cur * per, sv + cur * per, sb, s, r0, np, L, acc);
      store_output(out + b * pixels * C, C, h, spix + (wi % 3) * L, r0, L, acc);
    }
    if (prefetch) cp_async_wait_all();
    __syncthreads();  // stage cur and table wi are free; window wi + 1 has landed
  }
}

// images a block of the plain modes' swin_fwd_kernel takes (the last block
// of an odd batch one)
constexpr int kPlainImages = 2;

// A block's shared memory in the plain modes: with more than one key tile
// two ring stages of bias rows (f32, shared by the images) and of each
// image's k and v rows, else one; k has two stages in any case, the second
// holding q until the loop starts.
template <bool kHasBias>
__host__ __device__ constexpr size_t plain_shared_bytes(int L) {
  return (size_t)(tiles_of(L) > 1 ? 2 : 1) * fwd_tile_rows(L) *
             ((kHasBias ? kBiasRow * sizeof(float) : 0) + kPlainImages * kRow * sizeof(bf16)) +
         (size_t)2 * fwd_tile_rows(L) * kPlainImages * kRow * sizeof(bf16) +
         (size_t)L * sizeof(int);
}

// The plain modes (K3a: qg null; K4: kGlobal, qg (B, L, C)): proj, scale,
// bias (H, L, L) or null without kHasBias, out (B, Hp, Wp, C). work (H, L,
// ld) f32 scratch with a bias and L not a multiple of 4 (ld = L rounded up
// to 4), else unused; windows: windows a block of global_fwd_kernel walks
// (global mode, L <= 64).
template <bool kHasBias, bool kGlobal>
inline cudaError_t launch_plain(const void* proj, const void* qg, const void* scale,
                                const void* bias, void* out, void* work, const Geometry& g,
                                int windows, cudaStream_t st) {
  static_assert(valid_mode<false, false, kHasBias, kGlobal>(), "no such mode");
  const int tr = fwd_tile_rows(g.L);
  const bool walk = kGlobal && tiles_of(g.L) == 1;
  const int z = (g.B + kPlainImages - 1) / kPlainImages;
  if ((kHasBias && bias == nullptr) || (kGlobal && qg == nullptr) ||
      (walk && (windows < 1 || g.B > 65535)) || z > 65535 || g.nheads > 65535) {
    return cudaErrorInvalidValue;
  }
  const float* bi = static_cast<const float*>(bias);
  int ldb = g.L;
  cudaError_t err;
  // the walk loads its bias tile once per slice of windows, 4 bytes a
  // thread from unpadded rows; elsewhere a tile per block: pad
  if (kHasBias && !walk && (g.L & 3) != 0) {
    if (work == nullptr) return cudaErrorInvalidValue;
    ldb = (g.L + 3) & ~3;
    const size_t want = ((size_t)g.nheads * g.L * ldb + 255) / 256;
    pad_bias<<<(int)(want < 4096 ? want : 4096), 256, 0, st>>>(
        bi, static_cast<float*>(work), g.nheads * g.L, g.L, ldb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bi = static_cast<const float*>(work);
  }
  const bf16* p = static_cast<const bf16*>(proj);
  const bf16* q = static_cast<const bf16*>(qg);
  const float* sc = static_cast<const float*>(scale);
  bf16* o = static_cast<bf16*>(out);
  if constexpr (kGlobal) {  // K3a's library holds no window walk
    if (walk) {
      auto kernel = tr == 64 ? global_fwd_kernel<4> : global_fwd_kernel<3>;
      const size_t bytes = tr == 64 ? walk_shared_bytes<4>(g.L) : walk_shared_bytes<3>(g.L);
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return err;
      kernel<<<dim3((g.nW + windows - 1) / windows, g.nheads, g.B), 2 * tr, bytes, st>>>(
          p, q, sc, bi, ldb, o, g, windows);
      return cudaGetLastError();
    }
  }
  auto kernel = tr == 64 ? swin_fwd_kernel<4, kPlainImages, false, kHasBias, kGlobal>
                         : swin_fwd_kernel<3, kPlainImages, false, kHasBias, kGlobal>;
  const size_t bytes = plain_shared_bytes<kHasBias>(g.L);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.nW * tiles_of(g.L), g.nheads, z), 2 * tr, bytes, st>>>(p, nullptr, sc, bi, o,
                                                                          g, 0, q, ldb);
  return cudaGetLastError();
}

}  // namespace swin_fwd
