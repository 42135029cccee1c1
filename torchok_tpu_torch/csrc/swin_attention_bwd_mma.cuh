// The SwinV2 cosine window attention backward on Hopper's tensor cores, for
// bf16 inputs at every window size (L = ws*ws up to 576). Used by
// swin_attention_bwd.cu for every bf16 launch; f32 stays on the FMA
// templates. Same contract and rounding points as there: qn and kn are
// rounded to bf16, a = bf16(a32), dls = bf16(dl s), dq and dk go back
// through the f32 row normalisation, dbias and dscale are f32 sums.
//
// Every product is mma.sync.m16n8k16 (bf16 operands from ldmatrix, f32
// accumulators): a warp owns 16 rows, head dim 32 is two k16 steps, and the
// f32 accumulator of one product is repacked in registers as the bf16
// operand of the next (a32 -> a, dl -> dls). L is cut into ceil(L / 64)
// tiles of one height, a multiple of 16 (64, or 48 at L = 36 and 144) and
// padded to a multiple of 16 inside the last tile (a padded key has logit
// -inf and weight 0, a padded query row is zero, so it adds nothing to any
// sum). The PTX wrappers, tile heights, row loaders and the PV product are
// shared with the forward (swin_mma_common.cuh).
// Rows of 32 bf16 channels sit in shared memory at a stride of 80 bytes, so
// ldmatrix reads them without bank conflicts, and arrive by 16-byte
// cp.async from the unpartitioned (B, Hp, Wp, 3C) layout through the
// window's pixel table. k is normalised once per launch (normalize_k, into
// the dv channels of dqkv before dv is written), not in every key tile.
//
// The bias (plus, in shifted blocks, the mask, added once per launch into an
// (nW, H, L, L) scratch by combine_bias_mask) is read as 64 x 64 f32 tiles
// by cp.async into the same double-buffered rings as the rows, one tile
// ahead of the products, never element by element from device memory: a
// first version that read it so spent half its time there (twice that in
// shifted blocks; PERF.md).
//
// Two kernels, no atomics:
//  1. dq pass, a warp per 16 rows of a (window position, query tile, head,
//     image). The key tiles (kn, v, bias) stream through a two-stage ring
//     twice: first qn kn^T and do v^T
//     give the row statistics in flash form (max m, sum l, dsum = sum
//     exp(logit - m) da, rescaled when m grows), stored to a small f32
//     scratch (3, B, H, nW, L) as m log2(e), 1 / l and rowsum(a32 da) =
//     dsum / l; then the same two products give dls, and dq += dls kn stays
//     in registers.
//  2. dk/dv pass, two warps per 16 keys of a (window position, key tile,
//     head, slice of the images). Per image the key tile's kn and v are register
//     operands; the query tiles (qn, do, statistics, bias) stream through a
//     two-stage ring, each warp taking 16 keys and one half (up to 32
//     queries) of every tile: kn qn^T and v do^T give a32 and dl with the statistics of
//     pass 1, dv += a^T do and dk += dls^T qn stay in registers, and the two
//     halves' sums are added in a fixed order at the end of the image. The
//     block's (L, 64) f32 column of dbias stays in shared memory across all
//     its images (each entry belongs to one thread, added in image order)
//     and is written once, as is its dscale sum: one slot per block, added in
//     slot order by swin_attention_bwd_reduce, so the results are
//     bit-identical from run to run.
// Nine products in all (qn kn^T and do v^T three times, dq, dv, dk).
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

__host__ __device__ constexpr size_t dq_shared_bytes(int L) {
  return (size_t)2 * kTile * kDqBiasRow * sizeof(float) +   // bias ring
         (size_t)(4 + 3) * kTile * kRow * sizeof(bf16) +   // k, v ring; q, qn, do
         kTile * sizeof(float) + (size_t)L * sizeof(int);   // 1 / |q|; pixel table
}

__host__ __device__ constexpr size_t dkdv_shared_bytes(int L) {
  return (size_t)tiles_of(L) * tile_rows(L) * kDkvBiasRow * sizeof(float) +  // dbias
         (size_t)2 * kTile * kDkvBiasRow * sizeof(float) +  // bias ring
         (size_t)(2 * 3 * kTile + kTile + 8) * sizeof(float) +  // statistics, 1 / |k|, sums
         (size_t)(3 + 4) * kTile * kRow * sizeof(bf16) +   // k, kn, v; qn, do ring
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
// matrix src into dst (rows `stride` floats apart) by cp.async, zeros
// outside the matrix.
__device__ __forceinline__ void load_bias_tile(float* dst, int stride,
                                               const float* __restrict__ src, int i0, int j0,
                                               int n, int L) {
  // 16 chunks (64 columns) a row, so that no index is divided; columns
  // from n on are zeros, never read
  if ((L & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int idx = threadIdx.x; idx < n * 16; idx += blockDim.x) {
      const int r = idx >> 4;
      const int c = (idx & 15) * 4;
      const bool valid = c < n && i0 + r < L && j0 + c < L;
      cp_async16(dst + r * stride + c, src + (valid ? (size_t)(i0 + r) * L + j0 + c : 0), valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * kTile; idx += blockDim.x) {
      const int r = idx >> 6;
      const int c = idx & 63;
      const bool valid = c < n && i0 + r < L && j0 + c < L;
      cp_async4(dst + r * stride + c, src + (valid ? (size_t)(i0 + r) * L + j0 + c : 0), valid);
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

// ---- pass 1: row statistics and dq ---------------------------------------

// bias: (H, L, L), or (nW, H, L, L) with the mask added when kShifted
template <bool kShifted>
__global__ void __launch_bounds__(128, 3)
swin_bwd_dq_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                   const float* __restrict__ bias, const bf16* __restrict__ dout,
                   bf16* __restrict__ dqkv, float* __restrict__ stats, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw);           // [2][kTile][kDqBiasRow]
  bf16* sk = reinterpret_cast<bf16*>(sb + 2 * kTile * kDqBiasRow);  // [2][kTile][kRow] kn
  bf16* sv = sk + 2 * kTile * kRow;                          // [2][kTile][kRow]
  bf16* sq = sv + 2 * kTile * kRow;                          // [kTile][kRow] q, raw
  bf16* sqn = sq + kTile * kRow;                             // [kTile][kRow] qn
  bf16* sdo = sqn + kTile * kRow;                            // [kTile][kRow]
  float* srq = reinterpret_cast<float*>(sdo + kTile * kRow);  // [kTile] 1 / |q|
  int* spix = reinterpret_cast<int*>(srq + kTile);            // [L] pixel table

  const int L = g.L, C = g.C, width = 3 * C;
  const int ntiles = tiles_of(L);
  const int tr = tile_rows(L);            // rows of a tile; the block has tr / 16 warps
  const int win = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x - win * ntiles) * tr;
  const int h = blockIdx.y;
  const int l16 = (L + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int r0 = 16 * warp;               // the warp's first row in the tile
  const bool active = q0 + r0 < L;        // the same for the whole warp
  const float s = scale[h];
  const float* bias_w = bias + (size_t)(kShifted ? win * g.nheads + h : h) * L * L;
  const size_t nstat = (size_t)g.B * g.nheads * g.nW * L;
  const int nsteps = 2 * ntiles;  // the key tiles twice: statistics, then dq
  const int b = blockIdx.z;       // the image

  fill_pixels(g, win, spix);
  const size_t base = (size_t)b * g.Hp * g.Wp;  // the image's first pixel
  const bf16* image = qkv + base * width;
  bf16* dimage = dqkv + base * width;  // kn in its dv channels (normalize_k)
  // key tile k0's kn, v and bias into ring stage st
  auto load_keys = [&](int st, int k0) {
    load_rows(sk + st * kTile * kRow, dimage, width, 2 * C + h * kD, spix, k0, tr, L);
    load_rows(sv + st * kTile * kRow, image, width, 2 * C + h * kD, spix, k0, tr, L);
    load_bias_tile(sb + st * kTile * kDqBiasRow, kDqBiasRow, bias_w, q0, k0, tr, L);
  };
  __syncthreads();  // spix is ready
  load_rows(sq, image, width, h * kD, spix, q0, tr, L);
  load_rows(sdo, dout + base * C, C, h * kD, spix, q0, tr, L);
  load_keys(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  normalize_rows(sq, sqn, tr, srq);
  __syncthreads();

  uint32_t aq[2][4], ado[2][4];
  if (active) {
    load_a(aq, sqn, r0);
    load_a(ado, sdo, r0);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float m2[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
  float dq[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    const int k0 = (step < ntiles ? step : step - ntiles) * tr;
    const int cur = ntiles == 1 ? 0 : step & 1;
    const bool prefetch = ntiles > 1 && step + 1 < nsteps;
    if (prefetch) {
      load_keys(cur ^ 1, ((step + 1) % ntiles) * tr);
      cp_async_commit();
    }
    if (active) {
      const int np = min(tr, l16 - k0) >> 4;  // pairs of n-tiles with keys of this tile
      const float* tb = sb + cur * kTile * kDqBiasRow;
      float sc[8][4], dp[8][4];
      two_products<4>(aq, ado, sk + cur * kTile * kRow, sv + cur * kTile * kRow, 0, np, sc, dp);
      if (step < ntiles) {  // row statistics
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = k0 + 8 * n + 2 * tc;
            const bool in = n < 2 * np;  // a column of this tile
            const float2 bv = in ? *reinterpret_cast<const float2*>(
                                       tb + (r0 + gr + 8 * r) * kDqBiasRow + 8 * n + 2 * tc)
                                 : make_float2(0.f, 0.f);
            sc[n][2 * r] = in && j < L ? fmaf(sc[n][2 * r], s, bv.x) : -INFINITY;
            sc[n][2 * r + 1] = in && j + 1 < L ? fmaf(sc[n][2 * r + 1], s, bv.y) : -INFINITY;
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
        if (step == ntiles - 1) {
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
      } else {  // dq += dls kn
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = k0 + 8 * n + 2 * tc;
            const bool in = n < 2 * np;
            const float2 bv = in ? *reinterpret_cast<const float2*>(
                                       tb + (r0 + gr + 8 * r) * kDqBiasRow + 8 * n + 2 * tc)
                                 : make_float2(0.f, 0.f);
            const float bj[2] = {bv.x, bv.y};
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const int e = 2 * r + o;
              float dls = 0.f;
              if (in && j + o < L) {
                const float a32 = exp_minus(fmaf(sc[n][e], s, bj[o]), m2[r]) * linv[r];
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
  }
  if (active) {
    uint32_t out[2][4];
    normalize_backward(dq, sq, r0, srq, out);
    store_rows(dimage, width, h * kD, spix, q0 + r0, L, out);
  }
}

// ---- pass 2: dk, dv, dbias and dscale -------------------------------------

template <bool kShifted>
__global__ void __launch_bounds__(256, 1)
swin_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ rk,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, const bf16* __restrict__ dout,
                     bf16* __restrict__ dqkv, const float* __restrict__ stats,
                     float* __restrict__ partial, float* __restrict__ partial_scale, Geometry g,
                     int images_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = g.L, C = g.C, width = 3 * C;
  const int ntiles = tiles_of(L);
  const int tr = tile_rows(L);            // rows of a tile
  const int lk = ntiles * tr;
  float* sdb = reinterpret_cast<float*>(smem_raw);  // [lk][kDkvBiasRow] dbias column
  float* sb = sdb + lk * kDkvBiasRow;              // [2][kTile][kDkvBiasRow] bias ring
  float* sst = sb + 2 * kTile * kDkvBiasRow;       // [2][3][kTile] statistics ring
  float* srk = sst + 2 * 3 * kTile;                // [kTile] 1 / |k|
  float* sred = srk + kTile;                       // [8]
  bf16* skr = reinterpret_cast<bf16*>(sred + 8);   // [kTile][kRow] k, raw
  bf16* skn = skr + kTile * kRow;                  // [kTile][kRow] kn
  bf16* sv = skn + kTile * kRow;                   // [kTile][kRow]
  bf16* sq = sv + kTile * kRow;                    // [2][kTile][kRow] qn ring
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
  const float* bias_w = bias + (size_t)(kShifted ? win * g.nheads + h : h) * L * L;
  const size_t nstat = (size_t)g.B * g.nheads * g.nW * L;
  const int b1 = min(g.B, (int)(blockIdx.z + 1) * images_per_block);
  float dsc = 0.f;  // this thread's share of dscale

  for (int idx = threadIdx.x; idx < lk * kDkvBiasRow; idx += blockDim.x) sdb[idx] = 0.f;
  fill_pixels(g, win, spix);

  for (int b = blockIdx.z * images_per_block; b < b1; ++b) {
    const size_t base = (size_t)b * g.Hp * g.Wp;
    const bf16* image = qkv + base * width;
    const bf16* dimage = dout + base * C;
    bf16* gimage = dqkv + base * width;  // kn in its dv channels until dv is written
    const float* srow = stats + (((size_t)b * g.nheads + h) * g.nW + win) * L;
    // query tile q0's q (normalised in place once landed), do, statistics
    // and bias into ring stage st, zeros beyond L
    auto load_queries = [&](int st, int q0) {
      load_rows(sq + st * kTile * kRow, image, width, h * kD, spix, q0, tr, L);
      load_rows(sdo + st * kTile * kRow, dimage, C, h * kD, spix, q0, tr, L);
      for (int idx = threadIdx.x; idx < 3 * kTile; idx += blockDim.x) {
        const int part = idx >> 6;
        const int r = idx & 63;
        const bool valid = r < tr && q0 + r < L;
        cp_async4(sst + (st * 3 + part) * kTile + r, srow + part * nstat + (valid ? q0 + r : 0),
                  valid);
      }
      load_bias_tile(sb + st * kTile * kDkvBiasRow, kDkvBiasRow, bias_w, q0, k0, tr, L);
    };
    __syncthreads();  // spix and sdb are ready; the last image's readers are done
    load_rows(skr, image, width, C + h * kD, spix, k0, tr, L);
    load_rows(skn, gimage, width, 2 * C + h * kD, spix, k0, tr, L);
    load_rows(sv, image, width, 2 * C + h * kD, spix, k0, tr, L);
    load_rinv(srk, rk + base * g.nheads, g.nheads, h, spix, k0, tr, L);
    load_queries(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    normalize_rows(sq, sq, tr, nullptr);
    __syncthreads();

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
                a32 = exp_minus(fmaf(cosv, s, tb[(c + odd) * kDkvBiasRow + kr]),
                                odd ? m2.y : m2.x) *
                      (odd ? linv.y : linv.x);
                const float dl = a32 * (dp[n][e] - (odd ? dot.y : dot.x));
                dsc = fmaf(dl, cosv, dsc);
                sdb[(q0 + c + odd) * kDkvBiasRow + kr] += dl;
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
        __syncthreads();  // the next tile has landed
        normalize_rows(sq + (cur ^ 1) * kTile * kRow, sq + (cur ^ 1) * kTile * kRow, tr, nullptr);
      }
      __syncthreads();  // this stage's readers are done; the next one is normalised
    }
    // the two query halves' sums, added in a fixed order through the idle
    // bias ring ([key group][value][lane])
    float* sx = sb;
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
      normalize_backward(dk, skr, r0, srk, out);
      store_rows(gimage, width, C + h * kD, spix, k0 + r0, L, out);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < 4; ++n) out[r][n] = pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      store_rows(gimage, width, 2 * C + h * kD, spix, k0 + r0, L, out);
    }
  }

  // the block's dbias column into its slab, its dscale share into its slot
  __syncthreads();
  const size_t slot = (size_t)win * gridDim.z + blockIdx.z;
  float* pb = partial + (slot * g.nheads + h) * L * L;
  for (int idx = threadIdx.x; idx < L * tr; idx += blockDim.x) {
    const int i = idx / tr;
    const int j = idx - i * tr;
    if (k0 + j < L) pb[(size_t)i * L + k0 + j] = sdb[i * kDkvBiasRow + j];
  }
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

// Both passes. partial (slots, H, L, L) with slots = nW * ceil(B /
// images_per_block), partial_scale (slots * ceil(L / 64), H), stats (3, B,
// H, nW, L), all f32 scratch; work (f32) holds the shifted blocks' bias +
// mask (nW, H, L, L), padded to 16 bytes, then 1 / |k| (B, Hp, Wp, H).

template <bool kShifted>
cudaError_t launch(const void* qkv, const void* scale, const void* bias, const void* mask,
                   const void* dout, void* dqkv, void* partial, void* partial_scale, void* stats,
                   void* work, const Geometry& g, int images_per_block, cudaStream_t st) {
  const int ntiles = tiles_of(g.L);
  const int warps = tile_rows(g.L) / 16;  // per 16 rows of a tile (pass 2: two)
  const size_t bytes_dq = dq_shared_bytes(g.L);
  const size_t bytes_dkdv = dkdv_shared_bytes(g.L);
  const int z = (g.B + images_per_block - 1) / images_per_block;
  if (stats == nullptr || work == nullptr || g.B > 65535 || z > 65535 || g.nheads > 65535) {
    return cudaErrorInvalidValue;
  }
  auto dq_kernel = swin_bwd_dq_kernel<kShifted>;
  auto dkdv_kernel = swin_bwd_dkdv_kernel<kShifted>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes_dkdv);
  if (err != cudaSuccess) return err;
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* bi = static_cast<const float*>(bias);
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
  bf16* dq = static_cast<bf16*>(dqkv);
  const size_t rows = npix * g.nheads * 4;
  const size_t want = (rows + 255) / 256;
  normalize_k<<<(int)(want < 8192 ? want : 8192), 256, 0, st>>>(q, dq, wk, npix, g.nheads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* sc = static_cast<const float*>(scale);
  const bf16* d = static_cast<const bf16*>(dout);
  float* rs = static_cast<float*>(stats);
  dq_kernel<<<dim3(g.nW * ntiles, g.nheads, g.B), 32 * warps, bytes_dq, st>>>(
      q, sc, bi, d, dq, rs, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3(g.nW * ntiles, g.nheads, z), 64 * warps, bytes_dkdv, st>>>(
      q, wk, sc, bi, d, dq, rs, static_cast<float*>(partial),
      static_cast<float*>(partial_scale), g, images_per_block);
  return cudaGetLastError();
}

}  // namespace swin_mma
