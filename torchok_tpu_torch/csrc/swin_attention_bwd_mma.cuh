// The window attention backward on Hopper's tensor cores, for bf16 inputs,
// in three modes (template flags <kCosine, kShifted, kHasBias, kGlobal>):
//  * kCosine: the SwinV2 cosine window attention (K2; every window size, L =
//    ws*ws up to 576; kShifted adds the shift mask). Entered from
//    swin_attention_bwd.cu. qn and kn are rounded to bf16, a = bf16(a32),
//    dls = bf16(dl s), dq and dk go back through the f32 row normalisation,
//    dbias and dscale are f32 sums.
//  * plain, local (K3b; GCViT local and DaViT spatial blocks, L up to 256,
//    with or without a bias): logits = (q k^T) s (+ bias) in f32, a =
//    bf16(a32), dl = a32 (da - rowsum(da a32)), dls = bf16(dl s), dq = dls k,
//    dk = dls^T q, dbias the f32 sum of dl; no dscale. Entered from
//    window_attention_bwd.cu. Without a bias no bias tile is read, no dbias
//    column is kept and no slab is written.
//  * plain, global queries (K5; GCViT global blocks): the same arithmetic
//    with the query rows taken from qg (B, L, C), shared by an image's
//    windows; dq is summed over the image's windows, in window order, in f32
//    registers of one block and written once to dqg (B, L, C) f32. Entered
//    from window_attention_global_bwd.cu.
// The f32 launches of all three stay on the FMA templates.
//
// Every product is mma.sync.m16n8k16 (bf16 operands from ldmatrix, f32
// accumulators): a warp owns 16 rows, head dim 32 is two k16 steps, and the
// f32 accumulator of one product is repacked in registers as the bf16
// operand of the next (a32 -> a, dl -> dls). L is cut into ceil(L / 64)
// tiles of one height, a multiple of 16 (64, or 48 at L = 36 and 144) and
// padded to a multiple of 16 inside the last tile (a padded key has logit
// -inf and weight 0, a padded query row is zero and its statistics are zero,
// so it adds nothing to any sum). The PTX wrappers, tile heights, row
// loaders and the PV product are shared with the forward
// (swin_mma_common.cuh).
// Rows of 32 bf16 channels sit in shared memory at a stride of 80 bytes, so
// ldmatrix reads them without bank conflicts, and arrive by 16-byte
// cp.async from the unpartitioned (B, Hp, Wp, 3C) (global: kv (B, Hp, Wp,
// 2C)) layout through the window's pixel table. In cosine mode k is
// normalised once per launch (normalize_k, into the dv channels of dqkv
// before dv is written), not in every key tile.
//
// The bias (plus, in shifted blocks, the mask, added once per launch into an
// (nW, H, L, L) scratch by combine_bias_mask) is read as 64 x 64 f32 tiles
// by cp.async into the same double-buffered rings as the rows, one tile
// ahead of the products, never element by element from device memory: a
// first version that read it so spent half its time there (twice that in
// shifted blocks; PERF.md). Where L is not a multiple of 4 (GCViT's and
// DaViT's L = 49) the rows of the bias are not 16-byte aligned, so pad_bias
// first copies it into rows of ld = L rounded up to 4 floats.
//
// Two kernels, no atomics:
//  1. dq pass, a warp per 16 rows of a (window position, query tile, head,
//     image) (global: of a (query tile, head, image), walking the image's
//     windows in order). The key tiles (k, v, bias) stream through a
//     two-stage ring twice per window: first q k^T and do v^T
//     give the row statistics in flash form (max m, sum l, dsum = sum
//     exp(logit - m) da, rescaled when m grows), stored to a small f32
//     scratch (3, B, H, nW, L) as m log2(e), 1 / l and rowsum(a32 da) =
//     dsum / l; then the same two products give dls, and dq += dls k stays
//     in registers (global: across the windows; the next window's pixel
//     table, do rows and first key tile are loaded during its last step).
//  2. dk/dv pass, two warps per 16 keys of a (window position, key tile,
//     head, slice of the images). Per image the key tile's k and v are register
//     operands; the query tiles (q, do, statistics, bias) stream through a
//     two-stage ring, each warp taking 16 keys and one half (up to 32
//     queries) of every tile: k q^T and v do^T give a32 and dl with the statistics of
//     pass 1, dv += a^T do and dk += dls^T q stay in registers, and the two
//     halves' sums are added in a fixed order at the end of the image. The
//     block's (L, 64) f32 column of dbias stays in shared memory across all
//     its images (each entry belongs to one thread, added in image order)
//     and is written once, as is its dscale sum: one slot per block, added in
//     slot order by the entry's reduce kernel, so the results are
//     bit-identical from run to run.
// Nine products in all (q k^T and do v^T three times, dq, dv, dk).
//
// What bounds it: 9 * 2 * 32 FLOPs per logit on the tensor cores, but per
// logit also three exponentials (MUFU) and some thirty f32 instructions of
// softmax and gradient arithmetic, with ldmatrix and shared-memory traffic
// between them: the elementwise work and its latency, not the products or
// device memory, set its time (PERF.md). At L = 576 the dbias column (157 KB)
// leaves room for one dk/dv block per SM.
#pragma once
#include "swin_mma_common.cuh"

namespace swin_mma {

constexpr int kDqBiasRow = kTile + 8;   // f32 per bias row in pass 1 (float2 along rows)
constexpr int kDkvBiasRow = kTile + 4;  // f32 per bias / dbias row in pass 2 (down columns)

template <bool kCosine, bool kHasBias>
__host__ __device__ constexpr size_t dq_shared_bytes(int L) {
  return (kHasBias ? (size_t)2 * kTile * kDqBiasRow * sizeof(float) : 0) +  // bias ring
         (size_t)(4 + (kCosine ? 3 : 2)) * kTile * kRow * sizeof(bf16) +  // k, v ring; q, (qn,) do
         (kCosine ? kTile * sizeof(float) : 0) + (size_t)L * sizeof(int);  // 1 / |q|; pixels
}

template <bool kCosine, bool kHasBias>
__host__ __device__ constexpr size_t dkdv_shared_bytes(int L) {
  return (kHasBias ? (size_t)tiles_of(L) * tile_rows(L) * kDkvBiasRow * sizeof(float) +  // dbias
                         (size_t)2 * kTile * kDkvBiasRow * sizeof(float)  // bias ring
                   : 0) +
         (size_t)(2 * 3 * kTile + kTile + 8) * sizeof(float) +  // statistics, 1 / |k|, sums
         (size_t)((kCosine ? 3 : 2) + 4) * kTile * kRow * sizeof(bf16) +  // (k,) kn, v; q, do ring
         (size_t)L * sizeof(int);
}

// s = A x^T and d = B y^T for the warp's 16 rows (A, B: its operands over
// the head dim) against rows n0 .. n0 + 16 np of the shared arrays x and y
// (np <= kPairs pairs of 8-column n-tiles); the other n-tiles are zero.
template <int kPairs>
__device__ __forceinline__ void two_products(const uint32_t (&a)[2][4], const uint32_t (&b)[2][4],
                                             const bf16* x, const bf16* y, int n0, int np,
                                             float (&s)[2 * kPairs][4],
                                             float (&d)[2 * kPairs][4]) {
  const int lane = threadIdx.x & 31;
  const int off = (n0 + (lane & 7) + (lane >> 4) * 8) * kRow + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * p][e] = s[2 * p + 1][e] = d[2 * p][e] = d[2 * p + 1][e] = 0.f;
    if (p < np) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t fx[4], fy[4];
        ldsm_x4(fx, x + off + 16 * p * kRow + 16 * ks);
        ldsm_x4(fy, y + off + 16 * p * kRow + 16 * ks);
        mma16816(s[2 * p], a[ks], fx[0], fx[1]);
        mma16816(s[2 * p + 1], a[ks], fx[2], fx[3]);
        mma16816(d[2 * p], b[ks], fy[0], fy[1]);
        mma16816(d[2 * p + 1], b[ks], fy[2], fy[3]);
      }
    }
  }
}

// Rows i0.. and columns j0.. (n x n, n a multiple of 16) of the (L, L) f32
// matrix src, whose rows lie ld floats apart (ld >= L), into dst (rows
// `stride` floats apart) by cp.async, zeros outside the matrix.
__device__ __forceinline__ void load_bias_tile(float* dst, int stride,
                                               const float* __restrict__ src, int ld, int i0,
                                               int j0, int n, int L) {
  // 16 chunks (64 columns) a row, so that no index is divided; columns
  // from n on are zeros, never read
  if ((ld & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int idx = threadIdx.x; idx < n * 16; idx += blockDim.x) {
      const int r = idx >> 4;
      const int c = (idx & 15) * 4;
      const bool valid = c < n && i0 + r < L && j0 + c < L;
      cp_async16(dst + r * stride + c, src + (valid ? (size_t)(i0 + r) * ld + j0 + c : 0), valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * kTile; idx += blockDim.x) {
      const int r = idx >> 6;
      const int c = idx & 63;
      const bool valid = c < n && i0 + r < L && j0 + c < L;
      cp_async4(dst + r * stride + c, src + (valid ? (size_t)(i0 + r) * ld + j0 + c : 0), valid);
    }
  }
}

// dx = r dxn - r^3 x rowsum(x dxn) for the two rows (g, g + 8) of a warp's
// accumulator (16 rows x 32 channels); x from rows r0.. of a shared array
// of the raw rows, r the rows' 1 / |x|. Returns the packed bf16 pairs.
__device__ __forceinline__ void normalize_backward(const float (&d)[4][4], const bf16* raw,
                                                   int r0, const float* rinv,
                                                   uint32_t (&out)[2][4]) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  float x[4][4];
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[n][e] = __bfloat162float(raw[(r0 + gr + 8 * (e >> 1)) * kRow + 8 * n + 2 * tc + (e & 1)]);
      dot[e >> 1] = fmaf(x[n][e], d[n][e], dot[e >> 1]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
    dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
    const float rn = rinv[r0 + gr + 8 * r];
    const float r3 = rn * rn * rn;
#pragma unroll
    for (int n = 0; n < 4; ++n)
      out[r][n] = pack_bf16(rn * d[n][2 * r] - r3 * x[n][2 * r] * dot[r],
                            rn * d[n][2 * r + 1] - r3 * x[n][2 * r + 1] * dot[r]);
  }
}

// The plain modes' dq or dk: the warp's accumulator rounded to bf16 pairs.
__device__ __forceinline__ void pack_rows(const float (&d)[4][4], uint32_t (&out)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n) out[r][n] = pack_bf16(d[n][2 * r], d[n][2 * r + 1]);
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

// The plain modes' bias (rows of L floats) into rows of ld floats, the
// columns from L on zero, so that its tiles load 16 bytes a thread.
__global__ void pad_bias(const float* __restrict__ bias, float* __restrict__ out, int rows, int L,
                         int ld) {
  const size_t n = (size_t)rows * ld;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t r = idx / ld;
    const int c = (int)(idx - r * ld);
    out[idx] = c < L ? bias[r * L + c] : 0.f;
  }
}

// kn of every pixel and head with the arithmetic of normalize_rows (so with
// the same bits), into the dv channels of dqkv (B, Hp, Wp, 3C) before any
// dv is written there, and its f32 1 / |k| into rk (B, Hp, Wp, H). Pass 1
// reads kn there; in pass 2 the block of a key tile reads its kn at an
// image's start and later writes that image's dv over the same slots, which
// no other block reads.
__global__ void normalize_k(const bf16* __restrict__ qkv, bf16* __restrict__ dqkv,
                            float* __restrict__ rk, size_t npix, int nheads) {
  const int C = nheads * kD;
  const size_t n = npix * nheads * 4;  // four threads a row of 32 channels
  for (size_t i0 = (size_t)blockIdx.x * blockDim.x; i0 < n; i0 += (size_t)gridDim.x * blockDim.x) {
    const size_t idx = i0 + threadIdx.x;
    const bool on = idx < n;  // whole groups of four: n is a multiple of 4
    const size_t row = idx >> 2;
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
    if (on) {
      *reinterpret_cast<uint4*>(dqkv + pix * 3 * C + 2 * C + h * kD + part * 8) = out;
      if (part == 0) rk[pix * nheads + h] = rn;
    }
  }
}

// 1 / |k| of rows r0 .. r0 + rows of the window (rk of one image) into dst
// by cp.async, zeros beyond L
__device__ __forceinline__ void load_rinv(float* dst, const float* __restrict__ rk_image,
                                          int nheads, int h, const int* pix, int r0, int rows,
                                          int L) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const bool valid = r0 + r < L;
    cp_async4(dst + r, rk_image + (valid ? (size_t)pix[r0 + r] * nheads + h : 0), valid);
  }
}

template <bool kCosine, bool kShifted, bool kHasBias, bool kGlobal>
__host__ __device__ constexpr bool valid_mode() {
  return kCosine ? kHasBias && !kGlobal : !kShifted && (kHasBias || !kGlobal);
}

// ---- pass 1: row statistics and dq ---------------------------------------

// proj: qkv (B, Hp, Wp, 3C), global kv (B, Hp, Wp, 2C); qg (B, L, C) in
// global mode, else null. bias: (H, L, L) with rows ldb floats apart, or
// (nW, H, L, L) with the mask added when kShifted. dproj: dqkv (cosine: kn in
// its dv channels) or, in global mode, dkv (not written here: dq goes to dqg
// (B, L, C) f32).
template <bool kCosine, bool kShifted, bool kHasBias, bool kGlobal>
__global__ void __launch_bounds__(128, 3)
bwd_dq_kernel(const bf16* __restrict__ proj, const bf16* __restrict__ qg,
              const float* __restrict__ scale, const float* __restrict__ bias, int ldb,
              const bf16* __restrict__ dout, bf16* __restrict__ dproj, float* __restrict__ dqg,
              float* __restrict__ stats, Geometry g) {
  static_assert(valid_mode<kCosine, kShifted, kHasBias, kGlobal>(), "no such mode");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw);  // [2][kTile][kDqBiasRow] bias ring
  // [2][kTile][kRow] k (cosine: kn)
  bf16* sk = reinterpret_cast<bf16*>(sb + (kHasBias ? 2 * kTile * kDqBiasRow : 0));
  bf16* sv = sk + 2 * kTile * kRow;                          // [2][kTile][kRow]
  bf16* sq = sv + 2 * kTile * kRow;                          // [kTile][kRow] q, raw
  bf16* sqn = kCosine ? sq + kTile * kRow : sq;              // [kTile][kRow] qn
  bf16* sdo = sqn + kTile * kRow;                            // [kTile][kRow]
  float* srq = reinterpret_cast<float*>(sdo + kTile * kRow);  // cosine: [kTile] 1 / |q|
  int* spix = reinterpret_cast<int*>(srq + (kCosine ? kTile : 0));  // [L] pixel table

  const int L = g.L, C = g.C, width = (kGlobal ? 2 : 3) * C;
  const int koff = kGlobal ? 0 : C;       // k's channels in a row of proj; v's from koff + C
  const int ntiles = tiles_of(L);
  const int tr = tile_rows(L);            // rows of a tile; the block has tr / 16 warps
  const int win0 = kGlobal ? 0 : blockIdx.x / ntiles;
  const int q0 = (kGlobal ? blockIdx.x : blockIdx.x - win0 * ntiles) * tr;
  const int h = blockIdx.y;
  const int l16 = (L + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int r0 = 16 * warp;               // the warp's first row in the tile
  const bool active = q0 + r0 < L;        // the same for the whole warp
  const float s = scale[h];
  const float* bias_w =
      kHasBias ? bias + (size_t)(kShifted ? win0 * g.nheads + h : h) * L * ldb : nullptr;
  const size_t nstat = (size_t)g.B * g.nheads * g.nW * L;
  const int per_window = 2 * ntiles;     // the key tiles twice: statistics, then dq
  const int nsteps = (kGlobal ? g.nW : 1) * per_window;
  const int b = blockIdx.z;       // the image

  fill_pixels(g, win0, spix);
  const size_t base = (size_t)b * g.Hp * g.Wp;  // the image's first pixel
  const bf16* image = proj + base * width;
  bf16* dimage = dproj + base * width;
  // key tile k0's k (cosine: kn, in dqkv's dv channels), v and bias into
  // ring stage st
  auto load_keys = [&](int st, int k0) {
    load_rows(sk + st * kTile * kRow, kCosine ? dimage : image, width,
              (kCosine ? 2 * C : koff) + h * kD, spix, k0, tr, L);
    load_rows(sv + st * kTile * kRow, image, width, koff + C + h * kD, spix, k0, tr, L);
    if (kHasBias) {
      load_bias_tile(sb + st * kTile * kDqBiasRow, kDqBiasRow, bias_w, ldb, q0, k0, tr, L);
    }
  };
  __syncthreads();  // spix is ready
  if (kGlobal) {
    load_dense_rows(sq, qg + (size_t)b * L * C, C, h * kD, q0, tr, L);
  } else {
    load_rows(sq, image, width, h * kD, spix, q0, tr, L);
  }
  load_rows(sdo, dout + base * C, C, h * kD, spix, q0, tr, L);
  load_keys(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (kCosine) {
    normalize_rows(sq, sqn, tr, srq);
    __syncthreads();
  }

  uint32_t aq[2][4], ado[2][4];
  if (active) load_a(aq, sqn, r0);
  float m[2], l[2], dsum[2];
  float m2[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
  float dq[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int win = win0, within = 0, cur = 0;  // the step's window, its step in it, ring stage
  for (int step = 0; step < nsteps; ++step) {
    const int k0 = (within < ntiles ? within : within - ntiles) * tr;
    // global mode: the next window's pixel table, do rows and first key
    // tile are loaded during this window's last step
    const bool next_window = kGlobal && within == per_window - 1 && step + 1 < nsteps;
    const bool prefetch = step + 1 < nsteps && (ntiles > 1 || next_window);
    if (within == 0) {  // a window's first step: its do rows have landed
      if (active) load_a(ado, sdo, r0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = -INFINITY;
        l[r] = dsum[r] = 0.f;
      }
    }
    if (next_window) {
      // every warp holds this window's do in registers, and the loads that
      // read the pixel table were issued before the last barrier
      fill_pixels(g, win + 1, spix);
      __syncthreads();
      load_rows(sdo, dout + base * C, C, h * kD, spix, q0, tr, L);
    }
    if (prefetch) {
      load_keys(cur ^ 1, ((within + 1) % ntiles) * tr);
      cp_async_commit();
    }
    if (active) {
      const int np = min(tr, l16 - k0) >> 4;  // pairs of n-tiles with keys of this tile
      const float* tb = sb + cur * kTile * kDqBiasRow;
      float sc[8][4], dp[8][4];
      two_products<4>(aq, ado, sk + cur * kTile * kRow, sv + cur * kTile * kRow, 0, np, sc, dp);
      if (within < ntiles) {  // row statistics
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = k0 + 8 * n + 2 * tc;
            const bool in = n < 2 * np;  // a column of this tile
            if (kHasBias) {
              const float2 bv = in ? *reinterpret_cast<const float2*>(
                                         tb + (r0 + gr + 8 * r) * kDqBiasRow + 8 * n + 2 * tc)
                                   : make_float2(0.f, 0.f);
              sc[n][2 * r] = in && j < L ? fmaf(sc[n][2 * r], s, bv.x) : -INFINITY;
              sc[n][2 * r + 1] = in && j + 1 < L ? fmaf(sc[n][2 * r + 1], s, bv.y) : -INFINITY;
            } else {
              sc[n][2 * r] = in && j < L ? sc[n][2 * r] * s : -INFINITY;
              sc[n][2 * r + 1] = in && j + 1 < L ? sc[n][2 * r + 1] * s : -INFINITY;
            }
            tmax[r] = fmaxf(tmax[r], fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
          }
        float tm2[2], rescale[2], sum[2] = {0.f, 0.f}, dsm[2] = {0.f, 0.f};
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
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = exp_minus(sc[n][e], tm2[e >> 1]);
            sum[e >> 1] += x;
            dsm[e >> 1] = fmaf(x, dp[n][e], dsm[e >> 1]);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          dsm[r] += __shfl_xor_sync(0xffffffffu, dsm[r], 1);
          dsm[r] += __shfl_xor_sync(0xffffffffu, dsm[r], 2);
          l[r] = l[r] * rescale[r] + sum[r];
          dsum[r] = dsum[r] * rescale[r] + dsm[r];
        }
        if (within == ntiles - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = q0 + r0 + gr + 8 * r;
            m2[r] = m[r] * kLog2e;
            linv[r] = 1.f / l[r];
            dot[r] = dsum[r] * linv[r];
            if (tc == 0 && i < L) {
              const size_t at = (((size_t)b * g.nheads + h) * g.nW + win) * L + i;
              stats[at] = m2[r];
              stats[nstat + at] = linv[r];
              stats[2 * nstat + at] = dot[r];
            }
          }
        }
      } else {  // dq += dls k
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = k0 + 8 * n + 2 * tc;
            const bool in = n < 2 * np;
            float bj[2] = {0.f, 0.f};
            if (kHasBias && in) {
              const float2 bv = *reinterpret_cast<const float2*>(
                  tb + (r0 + gr + 8 * r) * kDqBiasRow + 8 * n + 2 * tc);
              bj[0] = bv.x;
              bj[1] = bv.y;
            }
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const int e = 2 * r + o;
              float dls = 0.f;
              if (in && j + o < L) {
                const float logit = kHasBias ? fmaf(sc[n][e], s, bj[o]) : sc[n][e] * s;
                const float a32 = exp_minus(logit, m2[r]) * linv[r];
                dls = a32 * (dp[n][e] - dot[r]) * s;
              }
              sc[n][e] = dls;
            }
          }
        product_into<4>(dq, sc, sk + cur * kTile * kRow, 0, np);
      }
    }
    if (prefetch) cp_async_wait_all();
    __syncthreads();  // this stage's readers are done; the next one has landed
    if (prefetch) cur ^= 1;
    if (++within == per_window) {
      within = 0;
      ++win;
    }
  }
  if (active) {
    if (kGlobal) {  // the sum over the image's windows, in f32
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = q0 + r0 + gr + 8 * r;
        if (i < L) {
          float* dst = dqg + ((size_t)b * L + i) * C + h * kD + 2 * tc;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
        }
      }
    } else {
      uint32_t out[2][4];
      if (kCosine) {
        normalize_backward(dq, sq, r0, srq, out);
      } else {
        pack_rows(dq, out);
      }
      store_rows(dimage, width, h * kD, spix, q0 + r0, L, out);
    }
  }
}

// ---- pass 2: dk, dv, dbias and dscale -------------------------------------

// Arguments as pass 1; rk (B, Hp, Wp, H) is 1 / |k| (cosine only), partial
// the (slots, H, L, L) dbias slabs (with a bias), partial_scale the dscale
// slots (cosine only).
template <bool kCosine, bool kShifted, bool kHasBias, bool kGlobal>
__global__ void __launch_bounds__(256, 1)
bwd_dkdv_kernel(const bf16* __restrict__ proj, const bf16* __restrict__ qg,
                const float* __restrict__ rk, const float* __restrict__ scale,
                const float* __restrict__ bias, int ldb, const bf16* __restrict__ dout,
                bf16* __restrict__ dproj, const float* __restrict__ stats,
                float* __restrict__ partial, float* __restrict__ partial_scale, Geometry g,
                int images_per_block) {
  static_assert(valid_mode<kCosine, kShifted, kHasBias, kGlobal>(), "no such mode");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = g.L, C = g.C, width = (kGlobal ? 2 : 3) * C;
  const int koff = kGlobal ? 0 : C;       // k's channels in a row of proj; v's from koff + C
  const int ntiles = tiles_of(L);
  const int tr = tile_rows(L);            // rows of a tile
  const int lk = ntiles * tr;
  float* sdb = reinterpret_cast<float*>(smem_raw);  // [lk][kDkvBiasRow] dbias column
  float* sb = sdb + (kHasBias ? lk * kDkvBiasRow : 0);  // [2][kTile][kDkvBiasRow] bias ring
  float* sst = sb + (kHasBias ? 2 * kTile * kDkvBiasRow : 0);  // [2][3][kTile] statistics ring
  float* srk = sst + 2 * 3 * kTile;                // [kTile] 1 / |k|
  float* sred = srk + kTile;                       // [8]
  bf16* skr = reinterpret_cast<bf16*>(sred + 8);   // cosine: [kTile][kRow] k, raw
  bf16* skn = skr + (kCosine ? kTile * kRow : 0);  // [kTile][kRow] kn (plain: k)
  bf16* sv = skn + kTile * kRow;                   // [kTile][kRow]
  bf16* sq = sv + kTile * kRow;                    // [2][kTile][kRow] qn (plain: q) ring
  bf16* sdo = sq + 2 * kTile * kRow;               // [2][kTile][kRow] do ring
  int* spix = reinterpret_cast<int*>(sdo + 2 * kTile * kRow);  // [L] pixel table

  const int win = blockIdx.x / ntiles;
  const int k0 = (blockIdx.x - win * ntiles) * tr;
  const int h = blockIdx.y;
  const int l16 = (L + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int groups = tr / 16;             // key groups; the block has two warps per group
  const int kw = warp % groups;           // keys 16 kw .. 16 kw + 15 of the tile
  const int half = warp / groups;         // query columns 32 half .. 32 half + 31 of each tile
  const int r0 = 16 * kw;
  const int c0 = 32 * half;
  const bool active = k0 + r0 < L;        // the same for the whole warp
  const float s = scale[h];
  const float* bias_w =
      kHasBias ? bias + (size_t)(kShifted ? win * g.nheads + h : h) * L * ldb : nullptr;
  const size_t nstat = (size_t)g.B * g.nheads * g.nW * L;
  const int b1 = min(g.B, (int)(blockIdx.z + 1) * images_per_block);
  float dsc = 0.f;  // cosine: this thread's share of dscale

  if (kHasBias) {
    for (int idx = threadIdx.x; idx < lk * kDkvBiasRow; idx += blockDim.x) sdb[idx] = 0.f;
  }
  fill_pixels(g, win, spix);

  for (int b = blockIdx.z * images_per_block; b < b1; ++b) {
    const size_t base = (size_t)b * g.Hp * g.Wp;
    const bf16* image = proj + base * width;
    const bf16* dimage = dout + base * C;
    bf16* gimage = dproj + base * width;  // cosine: kn in its dv channels until dv is written
    const float* srow = stats + (((size_t)b * g.nheads + h) * g.nW + win) * L;
    // query tile q0's q (cosine: normalised in place once landed), do,
    // statistics and bias into ring stage st, zeros beyond L
    auto load_queries = [&](int st, int q0) {
      if (kGlobal) {
        load_dense_rows(sq + st * kTile * kRow, qg + (size_t)b * L * C, C, h * kD, q0, tr, L);
      } else {
        load_rows(sq + st * kTile * kRow, image, width, h * kD, spix, q0, tr, L);
      }
      load_rows(sdo + st * kTile * kRow, dimage, C, h * kD, spix, q0, tr, L);
      for (int idx = threadIdx.x; idx < 3 * kTile; idx += blockDim.x) {
        const int part = idx >> 6;
        const int r = idx & 63;
        const bool valid = r < tr && q0 + r < L;
        cp_async4(sst + (st * 3 + part) * kTile + r, srow + part * nstat + (valid ? q0 + r : 0),
                  valid);
      }
      if (kHasBias) {
        load_bias_tile(sb + st * kTile * kDkvBiasRow, kDkvBiasRow, bias_w, ldb, q0, k0, tr, L);
      }
    };
    __syncthreads();  // spix and sdb are ready; the last image's readers are done
    if (kCosine) load_rows(skr, image, width, C + h * kD, spix, k0, tr, L);
    load_rows(skn, kCosine ? gimage : image, width, (kCosine ? 2 * C : koff) + h * kD, spix, k0,
              tr, L);
    load_rows(sv, image, width, koff + C + h * kD, spix, k0, tr, L);
    if (kCosine) load_rinv(srk, rk + base * g.nheads, g.nheads, h, spix, k0, tr, L);
    load_queries(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (kCosine) {
      normalize_rows(sq, sq, tr, nullptr);
      __syncthreads();
    }

    uint32_t akn[2][4], av[2][4];
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    if (active) {
      load_a(akn, skn, r0);
      load_a(av, sv, r0);
    }
    for (int qt = 0; qt < ntiles; ++qt) {
      const int cur = qt & 1;
      const int q0 = qt * tr;
      if (qt + 1 < ntiles) {
        load_queries(cur ^ 1, q0 + tr);
        cp_async_commit();
      }
      const int np = min(2, (min(tr, l16 - q0) - c0) >> 4);  // pairs of the warp's half
      if (active && np > 0) {
        const bf16* cq = sq + cur * kTile * kRow;
        const bf16* cdo = sdo + cur * kTile * kRow;
        const float* cst = sst + cur * 3 * kTile;
        const float* tb = sb + cur * kTile * kDkvBiasRow;
        float sc[4][4], dp[4][4];
        // transposed: rows are the warp's keys, columns its queries
        two_products<2>(akn, av, cq, cdo, c0, np, sc, dp);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (n < 2 * np) {
            const int c = c0 + 8 * n + 2 * tc;  // the first of the thread's two columns
            const float2 m2 = *reinterpret_cast<const float2*>(cst + c);
            const float2 linv = *reinterpret_cast<const float2*>(cst + kTile + c);
            const float2 dot = *reinterpret_cast<const float2*>(cst + 2 * kTile + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int odd = e & 1;
              const int kr = r0 + gr + 8 * (e >> 1);  // the key's row in the tile
              float a32 = 0.f, dls = 0.f;
              if (k0 + kr < L) {
                const float cosv = sc[n][e];
                const float logit =
                    kHasBias ? fmaf(cosv, s, tb[(c + odd) * kDkvBiasRow + kr]) : cosv * s;
                a32 = exp_minus(logit, odd ? m2.y : m2.x) * (odd ? linv.y : linv.x);
                const float dl = a32 * (dp[n][e] - (odd ? dot.y : dot.x));
                if (kCosine) dsc = fmaf(dl, cosv, dsc);
                if (kHasBias) sdb[(q0 + c + odd) * kDkvBiasRow + kr] += dl;
                dls = dl * s;
              }
              sc[n][e] = a32;
              dp[n][e] = dls;
            }
          }
        }
        product_into<2>(dv, sc, cdo, c0, np);  // dv += a^T do
        product_into<2>(dk, dp, cq, c0, np);   // dk += dls^T qn
      }
      if (qt + 1 < ntiles) {
        cp_async_wait_all();
        if (kCosine) {
          __syncthreads();  // the next tile has landed
          normalize_rows(sq + (cur ^ 1) * kTile * kRow, sq + (cur ^ 1) * kTile * kRow, tr,
                         nullptr);
        }
      }
      __syncthreads();  // this stage's readers are done; the next one is ready
    }
    // the two query halves' sums, added in a fixed order through an idle
    // ring ([key group][value][lane]): the bias ring, or without a bias the
    // query and do ring (20 KB for the 16 KB)
    float* sx = kHasBias ? sb : reinterpret_cast<float*>(sq);
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sx[(kw * 32 + 4 * n + e) * 32 + lane] = dk[n][e];
          sx[(kw * 32 + 16 + 4 * n + e) * 32 + lane] = dv[n][e];
        }
    }
    __syncthreads();
    if (half == 0 && active) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[n][e] += sx[(kw * 32 + 4 * n + e) * 32 + lane];
          dv[n][e] += sx[(kw * 32 + 16 + 4 * n + e) * 32 + lane];
        }
      uint32_t out[2][4];
      if (kCosine) {
        normalize_backward(dk, skr, r0, srk, out);
      } else {
        pack_rows(dk, out);
      }
      store_rows(gimage, width, koff + h * kD, spix, k0 + r0, L, out);
      pack_rows(dv, out);
      store_rows(gimage, width, koff + C + h * kD, spix, k0 + r0, L, out);
    }
  }

  if (kHasBias) {
    // the block's dbias column into its slab
    __syncthreads();
    const size_t slot = (size_t)win * gridDim.z + blockIdx.z;
    float* pb = partial + (slot * g.nheads + h) * L * L;
    for (int idx = threadIdx.x; idx < L * tr; idx += blockDim.x) {
      const int i = idx / tr;
      const int j = idx - i * tr;
      if (k0 + j < L) pb[(size_t)i * L + k0 + j] = sdb[i * kDkvBiasRow + j];
    }
  }
  if (kCosine) {
    // its dscale share into its slot
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dsc += __shfl_xor_sync(0xffffffffu, dsc, off);
    if (lane == 0) sred[warp] = dsc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < (int)(blockDim.x / 32); ++w) total += sred[w];
      partial_scale[((size_t)blockIdx.x * gridDim.z + blockIdx.z) * g.nheads + h] = total;
    }
  }
}

// Both passes. proj, qg, dproj, dqg as pass 1 (qg and dqg null but in
// global mode). partial (slots, H, L, L) with slots = nW * ceil(B /
// images_per_block) (with a bias), partial_scale (slots * ceil(L / 64), H)
// (cosine), stats (3, B, H, nW, L), all f32 scratch; work (f32) holds, in
// cosine mode, the shifted blocks' bias + mask (nW, H, L, L), padded to 16
// bytes, then 1 / |k| (B, Hp, Wp, H); in the plain modes with a bias and L
// not a multiple of 4, the bias in rows of L rounded up to 4 floats (H, L,
// ld); else it may be null. The slabs are left for the entry to add.

template <bool kCosine, bool kShifted, bool kHasBias, bool kGlobal>
cudaError_t launch(const void* proj, const void* qg, const void* scale, const void* bias,
                   const void* mask, const void* dout, void* dproj, void* dqg, void* partial,
                   void* partial_scale, void* stats, void* work, const Geometry& g,
                   int images_per_block, cudaStream_t st) {
  const int ntiles = tiles_of(g.L);
  const int warps = tile_rows(g.L) / 16;  // per 16 rows of a tile (pass 2: two)
  const size_t bytes_dq = dq_shared_bytes<kCosine, kHasBias>(g.L);
  const size_t bytes_dkdv = dkdv_shared_bytes<kCosine, kHasBias>(g.L);
  const int z = (g.B + images_per_block - 1) / images_per_block;
  const bool padded = !kCosine && kHasBias && (g.L & 3) != 0;
  if (stats == nullptr || ((kCosine || padded) && work == nullptr) ||
      (kGlobal && (qg == nullptr || dqg == nullptr)) || (kHasBias && partial == nullptr) ||
      images_per_block < 1 || g.B > 65535 || z > 65535 || g.nheads > 65535) {
    return cudaErrorInvalidValue;
  }
  auto dq_kernel = bwd_dq_kernel<kCosine, kShifted, kHasBias, kGlobal>;
  auto dkdv_kernel = bwd_dkdv_kernel<kCosine, kShifted, kHasBias, kGlobal>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes_dkdv);
  if (err != cudaSuccess) return err;
  const bf16* q = static_cast<const bf16*>(proj);
  const float* bi = static_cast<const float*>(bias);
  int ldb = g.L;
  float* wk = static_cast<float*>(work);
  const size_t npix = (size_t)g.B * g.Hp * g.Wp;
  if (kShifted) {
    const size_t n = (size_t)g.nW * g.nheads * g.L * g.L;
    const size_t want = (n + 255) / 256;
    combine_bias_mask<<<(int)(want < 4096 ? want : 4096), 256, 0, st>>>(
        bi, static_cast<const float*>(mask), wk, g.nheads, g.nW, g.L * g.L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bi = wk;
    wk += (n + 3) / 4 * 4;
  }
  if (padded) {
    ldb = (g.L + 3) & ~3;
    const size_t want = ((size_t)g.nheads * g.L * ldb + 255) / 256;
    pad_bias<<<(int)(want < 4096 ? want : 4096), 256, 0, st>>>(bi, wk, g.nheads * g.L, g.L, ldb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bi = wk;
  }
  bf16* dp = static_cast<bf16*>(dproj);
  if (kCosine) {
    const size_t rows = npix * g.nheads * 4;
    const size_t want = (rows + 255) / 256;
    normalize_k<<<(int)(want < 8192 ? want : 8192), 256, 0, st>>>(q, dp, wk, npix, g.nheads);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const bf16* qgp = static_cast<const bf16*>(qg);
  const float* sc = static_cast<const float*>(scale);
  const bf16* d = static_cast<const bf16*>(dout);
  float* rs = static_cast<float*>(stats);
  const dim3 dq_grid = kGlobal ? dim3(ntiles, g.nheads, g.B) : dim3(g.nW * ntiles, g.nheads, g.B);
  dq_kernel<<<dq_grid, 32 * warps, bytes_dq, st>>>(q, qgp, sc, bi, ldb, d, dp,
                                                   static_cast<float*>(dqg), rs, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3(g.nW * ntiles, g.nheads, z), 64 * warps, bytes_dkdv, st>>>(
      q, qgp, kCosine ? wk : nullptr, sc, bi, ldb, d, dp, rs, static_cast<float*>(partial),
      static_cast<float*>(partial_scale), g, images_per_block);
  return cudaGetLastError();
}

}  // namespace swin_mma
