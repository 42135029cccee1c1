// The SwinV2 cosine window attention forward on Hopper's tensor cores, for
// bf16 inputs at every window size (L = ws*ws up to 576). Used by
// swin_attention_fwd.cu for every bf16 launch; f32 stays on the FMA
// templates. Same contract and rounding points as there: qn and kn are
// rounded to bf16, QK^T accumulates in f32, then * scale + bias (+ mask),
// a32 = exp(logit - m) / l with the row's final max m and sum l, a =
// bf16(a32), PV accumulates in f32 and the output is rounded once.
//
// Both products are mma.sync.m16n8k16 (bf16 operands from ldmatrix, f32
// accumulators): a warp owns 16 query rows, head dim 32 is two k16 steps,
// and the f32 weights are repacked in registers as the bf16 A operand of PV.
// L is cut into ceil(L / 64) tiles of one height, a multiple of 16 (64, or
// 48 at L = 36 and 144; swin_mma::tile_rows), padded to a multiple of 16
// inside the last tile: a padded key has logit -inf and weight 0, a padded
// query row is zero and never stored.
//
// Three launches, no atomics:
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
#pragma once
#include "swin_mma_common.cuh"

namespace swin_fwd {

using namespace swin_mma;

constexpr int kBiasRow = kTile;  // f32 per shared bias row, 8-float chunks swizzled by row

// The kernel's tile height: tile_rows(L) (48 or 64 when L > 64), and 48
// for the few L <= 32 whose tile would be shorter (none is a SwinV2 window).
__host__ __device__ constexpr int fwd_tile_rows(int L) { return tile_rows(L) > 48 ? 64 : 48; }

// A block's shared memory for kImages images: for each of the two ring
// stages, a tile's bias rows (f32, shared by the images) and each image's kn
// and v rows (bf16); the q rows wait in stage 1's bias rows until the loop
// starts. Two images: 74 KB at L = 256 and 576 (three blocks an SM), 55 KB
// at L = 36 and 144 (four).
__host__ __device__ constexpr size_t shared_bytes(int L, int images) {
  return (size_t)2 * fwd_tile_rows(L) *
             (kBiasRow * sizeof(float) + 2 * images * kRow * sizeof(bf16)) +  // the ring
         (size_t)L * sizeof(int);                                               // pixel table
}

// Rows i0 .. i0 + kRows and columns j0 .. j0 + kRows of the (L, L) f32
// matrix src into dst by cp.async, zeros outside the matrix. Column c of row
// r lands in 8-float chunk (c / 8) ^ (r % 8) of the row, so that the float2
// reads of a warp's accumulator layout (rows g, columns 2t in each chunk)
// hit 32 different banks. The block's 2 kRows threads take 8 chunks of 16
// bytes each, at fixed columns (4-byte copies when L is not a multiple of 4).
__device__ __forceinline__ int bias_at(int r, int c) {
  return r * kBiasRow + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

template <int kRows>
__device__ __forceinline__ void load_bias_rows(float* dst, const float* __restrict__ src, int i0,
                                               int j0, int L) {
  if ((L & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int c = (threadIdx.x & 15) * 4;
    if (c < kRows) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = (threadIdx.x >> 4) + k * (kRows / 8);
        const bool valid = i0 + r < L && j0 + c < L;
        cp_async16(dst + bias_at(r, c), src + (valid ? (size_t)(i0 + r) * L + j0 + c : 0),
                   valid);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * kTile; idx += blockDim.x) {
      const int r = idx >> 6;
      const int c = idx & 63;
      const bool valid = c < kRows && i0 + r < L && j0 + c < L;
      cp_async4(dst + bias_at(r, c), src + (valid ? (size_t)(i0 + r) * L + j0 + c : 0), valid);
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
// needs a test.
template <int kPairs, bool kFull>
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
      const float2 bv =
          in ? *reinterpret_cast<const float2*>(tb + bias_at(r0 + gr + 8 * r, 8 * n + 2 * tc))
             : make_float2(0.f, 0.f);
      sc[n][2 * r] = kFull || (in && j < L) ? fmaf(sc[n][2 * r], s, bv.x) : -INFINITY;
      sc[n][2 * r + 1] = kFull || (in && j + 1 < L) ? fmaf(sc[n][2 * r + 1], s, bv.y) : -INFINITY;
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

// bias: (H, L, L), or (nW, H, L, L) with the mask added when shifted.
// kPairs = tile rows / 16: 4, or 3 at L = 36 and 144. The block takes
// images blockIdx.z * kImages .. (those below B); each warp takes its 16
// rows of each in turn, so one bias tile of the ring serves them all.
template <int kPairs, int kImages>
__global__ void __launch_bounds__(128, 3)
swin_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ kn,
                const float* __restrict__ scale, const float* __restrict__ bias,
                bf16* __restrict__ out, Geometry g, int shifted) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int tr = 16 * kPairs;         // rows of a tile; the block has kPairs warps
  constexpr int per = tr * kRow;          // bf16 of one image's rows of a tile
  float* sb = reinterpret_cast<float*>(smem_raw);               // [2][tr][kBiasRow]
  bf16* sk = reinterpret_cast<bf16*>(sb + 2 * tr * kBiasRow);   // [2][kImages][tr][kRow] kn
  bf16* sv = sk + 2 * kImages * per;                            // [2][kImages][tr][kRow]
  int* spix = reinterpret_cast<int*>(sv + 2 * kImages * per);   // [L] pixel table
  bf16* sq = reinterpret_cast<bf16*>(sb + tr * kBiasRow);       // [kImages][tr][kRow] q, qn
  const int L = g.L, C = g.C, width = 3 * C;
  const int ntiles = tiles_of(L);
  const int win = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x - win * ntiles) * tr;
  const int h = blockIdx.y;
  const int l16 = (L + 15) & ~15;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's first row in the tile
  const bool active = q0 + r0 < L;         // the same for the whole warp
  const int b0 = blockIdx.z * kImages;
  const int nimg = min(kImages, g.B - b0);  // the last block may have fewer
  const float s = scale[h];
  const float* bias_w = bias + (size_t)(shifted ? win * g.nheads + h : h) * L * L;
  const int nsteps = 2 * ntiles;  // the key tiles twice: statistics, then the output
  const size_t pixels = (size_t)g.Hp * g.Wp;

  fill_pixels(g, win, spix);
  // step's key tile (kn, bias; v in the second sweep) into ring stage st
  auto load_keys = [&](int st, int step) {
    const int k0 = (step < ntiles ? step : step - ntiles) * tr;
    for (int i = 0; i < nimg; ++i) {
      const size_t base = (b0 + i) * pixels;
      load_rows(sk + (st * kImages + i) * per, kn + base * C, C, h * kD, spix, k0, tr, L);
      if (ntiles == 1 || step >= ntiles) {
        load_rows(sv + (st * kImages + i) * per, qkv + base * width, width, 2 * C + h * kD,
                  spix, k0, tr, L);
      }
    }
    load_bias_rows<tr>(sb + st * tr * kBiasRow, bias_w, q0, k0, L);
  };
  __syncthreads();  // spix is ready
  for (int i = 0; i < nimg; ++i) {
    load_rows(sq + i * per, qkv + (b0 + i) * pixels * width, width, h * kD, spix, q0, tr, L);
  }
  load_keys(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  normalize_rows(sq, sq, nimg * tr, nullptr);
  __syncthreads();

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
          if (full) {
            key_tile<kPairs, true>(aq[i], ck, cv, tb, s, r0, k0, kPairs, L, statistics, m[i],
                                   l[i], m2[i], linv[i], acc[i]);
          } else {
            key_tile<kPairs, false>(aq[i], ck, cv, tb, s, r0, k0, np, L, statistics, m[i], l[i],
                                    m2[i], linv[i], acc[i]);
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
      if (i < nimg) {
        uint32_t packed[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            packed[r][n] = pack_bf16(acc[i][n][2 * r], acc[i][n][2 * r + 1]);
          }
        store_rows(out + (b0 + i) * pixels * C, C, h * kD, spix, q0 + r0, L, packed);
      }
    }
  }
}

// The three launches. kn: (B, Hp, Wp, C) bf16 scratch; bias_mask: (nW, H,
// L, L) f32 scratch when mask is not null (unused otherwise); images: images
// a block takes, 1 or 2.
inline cudaError_t launch(const void* qkv, const void* scale, const void* bias, const void* mask,
                          void* out, void* kn, void* bias_mask, const Geometry& g, int images,
                          cudaStream_t st) {
  const bool shifted = mask != nullptr;
  const int z = (g.B + images - 1) / images;
  if (kn == nullptr || (shifted && bias_mask == nullptr) || images < 1 || images > 2 ||
      z > 65535 || g.nheads > 65535) {
    return cudaErrorInvalidValue;
  }
  const int tr = fwd_tile_rows(g.L);
  const size_t bytes = shared_bytes(g.L, images);
  auto kernel = tr == 64 ? (images == 2 ? swin_fwd_kernel<4, 2> : swin_fwd_kernel<4, 1>)
                         : (images == 2 ? swin_fwd_kernel<3, 2> : swin_fwd_kernel<3, 1>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const float* bi = static_cast<const float*>(bias);
  if (shifted) {
    const size_t n = (size_t)g.nW * g.nheads * g.L * g.L;
    const size_t want = (n + 255) / 256;
    combine_bias_mask<<<(int)(want < 4096 ? want : 4096), 256, 0, st>>>(
        bi, static_cast<const float*>(mask), static_cast<float*>(bias_mask), g.nheads, g.nW,
        g.L * g.L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bi = static_cast<const float*>(bias_mask);
  }
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* k = static_cast<bf16*>(kn);
  const size_t npix = (size_t)g.B * g.Hp * g.Wp;
  const size_t want = (npix * g.nheads * 4 + 255) / 256;
  normalize_k<<<(int)(want < 8192 ? want : 8192), 256, 0, st>>>(q, k, npix, g.nheads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.nW * tiles_of(g.L), g.nheads, z), 2 * tr, bytes, st>>>(
      q, k, static_cast<const float*>(scale), bi, static_cast<bf16*>(out), g, shifted ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace swin_fwd
