// The key-tiled path of the window attention, forward and backward, for
// windows of more than 256 tokens: SwinV2's ws 24 (L = 576, the windows of
// swinv2_{base,large}_window12to24_192to384_22kft1k's first three stages).
// Used by swin_attention_{fwd,bwd}.cu: the cosine mode with the bias and
// optionally the shift mask (kHasMask); see window_attention_common.cuh for
// the layout and the thread grid.
//
// Why a second path: the register-tile kernels of window_attention_{fwd,bwd}
// .cuh hold all L keys of a window. At L = 576 that is 36 key columns a
// thread, 144 f32 logits in registers; a 64-row tile's f32 logits against 576
// keys take 147 KB of shared memory before q, k and v; and the backward's
// dk/dv accumulators for 576 keys do not fit a block's registers. So here
// the keys are walked in tiles of kTileK = 64 (4 key columns a thread), with
// the arithmetic and the rounding points of the register-tile kernels:
//
// Forward, one block per (window, 64-query tile, head, image): pass 1 walks
// the key tiles and keeps an online max m and sum l = sum exp(logit - m) per
// query row (the flash form: l rescaled by exp(m_old - m_new) when the max
// grows); pass 2 walks them again, recomputes the logits, rounds
// a = T(exp(logit - m) / l) into shared memory (the weights are rounded to T
// before they meet v, as in the Pallas kernel and the plain version) and
// accumulates a v in f32. QK^T is computed twice: three products, not two.
//
// Backward, one block per (window position, head, slice of the images), per
// image:
//   1. statistics: for every query tile, over all key tiles, s = qn kn^T and
//      da = do v^T give m, l and dsum = sum exp(logit - m) da (rescaled like
//      l); dot = dsum / l = rowsum(a32 da). Kept in shared memory for all L
//      rows, with 1 / |q| of every row.
//   2. for each key tile (dk and dv of its 64 keys in registers), over all
//      query tiles: s and da again, a32 = exp(logit - m) / l,
//      dl = a32 (da - dot); dbias slab += dl, dscale += dl s (cosine);
//      dv += T(a32)^T do, dk += T(dl scale)^T qn, and dq += T(dl scale) kn
//      into an f32 (L, 32) accumulator in shared memory (76 KB at L = 576).
//      dk goes back through the normalisation of k when its tile is done.
//   3. dq goes back through the normalisation of q and out.
// Seven products instead of five; no atomics: the dq accumulator's entries
// each belong to one thread, the block's dbias slab in device memory is
// stored at its first image and added to at the later ones (in image order),
// and the reduction kernel adds the slabs and the dscale slots in slot
// order, so results are bit-identical from run to run. The slab scratch is
// (slots, H, L, L) f32 with slots = nW x slices; the wrapper sizes the
// slices (about two blocks per SM) so that it stays well under 1 GB at the
// shapes of swinv2_base_window12to24 at batch 32 (at most 425 MB).
//
// What bounds it: as the register-tile kernels, f32 FMAs fed from shared
// memory, with two (forward: one) extra products.
#pragma once
#include "window_attention_common.cuh"

namespace wattn {

constexpr int kTileKC = kTileK / 16;  // key columns a thread owns in a key tile

// Rows [r0, r0 + 64) of one part of a window (the part starts at channel
// `off` of a row of `width`; head h), zeros beyond L.
template <typename T>
__device__ __forceinline__ void load_tile_rows(const T* __restrict__ image, int width, int off,
                                               int h, const int* pix, int r0, int L, T* dst) {
  constexpr int Dp = kD + kPad<T>;
  for (int idx = threadIdx.x; idx < 64 * kParts<T>; idx += kThreads) {
    const int r = idx / kParts<T>;
    const int part = idx - r * kParts<T>;
    const int i = r0 + r;
    const T* src = i < L ? image + (size_t)pix[i] * width + off + h * kD : nullptr;
    copy_row_part(dst + r * Dp, src, part);
  }
}

// acc[r][c] = a row (ti + 16 r) . b row (tj + 16 c) over the head dim, f32
template <typename T>
__device__ __forceinline__ void tile_dot(const T* sa, const T* sb, float (&acc)[kRows][kTileKC]) {
  constexpr int Dp = kD + kPad<T>;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kTileKC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float av[kRows], bv[kTileKC];
#pragma unroll
    for (int r = 0; r < kRows; ++r) av[r] = to_f(sa[(ti + 16 * r) * Dp + d]);
#pragma unroll
    for (int c = 0; c < kTileKC; ++c) bv[c] = to_f(sb[(tj + 16 * c) * Dp + d]);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kTileKC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// The logit of query i against key j from its cosine: -inf for a padded
// key, bias and mask only for a real query row (as the register-tile kernels).
template <bool kHasMask>
__device__ __forceinline__ float tile_logit(float cosv, float s, const float* brow,
                                            const float* mrow, bool real_row, int j, int L) {
  if (j >= L) return -INFINITY;
  float logit = cosv * s;
  if (real_row) logit += brow[j];
  if (kHasMask && real_row) logit += mrow[j];
  return logit;
}

template <typename T>
constexpr size_t fwd_tiled_shared_bytes() {
  return (size_t)(3 * 64 * (kD + kPad<T>) + kTileQ * (kTileK + kPad<T>)) * sizeof(T) +
         kMaxLTiled * sizeof(int);
}

template <typename T, bool kHasMask>
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_tiled_kernel(const T* __restrict__ qkv, const float* __restrict__ scale,
                                  const float* __restrict__ bias, const float* __restrict__ mask,
                                  T* __restrict__ out, Geometry g, int nqt) {
  constexpr int Dp = kD + kPad<T>;
  constexpr int Lkp = kTileK + kPad<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // [kTileQ][Dp]
  T* sk = sq + kTileQ * Dp;                // [kTileK][Dp]
  T* sv = sk + kTileK * Dp;                // [kTileK][Dp]
  T* sa = sv + kTileK * Dp;                // [kTileQ][Lkp] a, rounded
  int* spix = reinterpret_cast<int*>(sa + kTileQ * Lkp);  // [L] pixel table

  const int win = blockIdx.x / nqt;
  const int q0 = (blockIdx.x - win * nqt) * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  const int L = g.L;
  const int C = g.C;
  const int width = 3 * C;
  const float s = scale[h];
  const T* image = qkv + (size_t)b * g.Hp * g.Wp * width;

  fill_pixel_table(g, win, spix);
  __syncthreads();
  load_tile_rows(image, width, 0, h, spix, q0, L, sq);
  __syncthreads();
  normalize_rows(sq, kTileQ, nullptr);

  const float* brow[kRows];
  const float* mrow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + ti + 16 * r;
    brow[r] = bias + ((size_t)h * L + i) * L;
    mrow[r] = kHasMask ? mask + ((size_t)win * L + i) * L : nullptr;
  }

  // pass 1: online max and sum per query row
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += kTileK) {
    __syncthreads();  // sq is ready; the last tile's readers of sk are done
    load_tile_rows(image, width, C, h, spix, k0, L, sk);
    __syncthreads();
    normalize_rows(sk, kTileK, nullptr);
    __syncthreads();
    float acc[kRows][kTileKC];
    tile_dot(sq, sk, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool real = q0 + ti + 16 * r < L;
      float tm = -INFINITY;
#pragma unroll
      for (int c = 0; c < kTileKC; ++c) {
        acc[r][c] = tile_logit<kHasMask>(acc[r][c], s, brow[r], mrow[r], real,
                                                   k0 + tj + 16 * c, L);
        tm = fmaxf(tm, acc[r][c]);
      }
      const float mnew = fmaxf(m[r], row_max16(tm));  // key k0 is real: finite
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < kTileKC; ++c) e += expf(acc[r][c] - mnew);
      l[r] = l[r] * expf(m[r] - mnew) + row_sum16(e);
      m[r] = mnew;
    }
  }

  // pass 2: the rounded weights tile by tile, out = a v in f32
  float o[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) o[r][0] = o[r][1] = 0.f;
  for (int k0 = 0; k0 < L; k0 += kTileK) {
    __syncthreads();  // the last tile's readers of sk, sv and sa are done
    load_tile_rows(image, width, C, h, spix, k0, L, sk);
    load_tile_rows(image, width, 2 * C, h, spix, k0, L, sv);
    __syncthreads();
    normalize_rows(sk, kTileK, nullptr);
    __syncthreads();
    float acc[kRows][kTileKC];
    tile_dot(sq, sk, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool real = q0 + ti + 16 * r < L;
#pragma unroll
      for (int c = 0; c < kTileKC; ++c) {
        const float logit = tile_logit<kHasMask>(acc[r][c], s, brow[r], mrow[r], real,
                                                           k0 + tj + 16 * c, L);
        sa[(ti + 16 * r) * Lkp + tj + 16 * c] = from_f<T>(expf(logit - m[r]) / l[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTileK; ++j) {  // padded keys: weight 0, v rows 0
      const float v0 = to_f(sv[j * Dp + tj]);
      const float v1 = to_f(sv[j * Dp + tj + 16]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = to_f(sa[(ti + 16 * r) * Lkp + j]);
        o[r][0] = fmaf(av, v0, o[r][0]);
        o[r][1] = fmaf(av, v1, o[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + ti + 16 * r;
    if (i < L) {
      T* dst = out + ((size_t)b * g.Hp * g.Wp + spix[i]) * C + h * kD + tj;
      dst[0] = from_f<T>(o[r][0]);
      dst[16] = from_f<T>(o[r][1]);
    }
  }
}

template <typename T>
constexpr size_t bwd_tiled_shared_bytes() {
  return (size_t)(4 * 64 * (kD + kPad<T>) + 2 * kTileQ * (kTileK + kPad<T>)) * sizeof(T) +
         kMaxLTiled * sizeof(int) +
         (4 * kMaxLTiled + kTileK + kMaxLTiled * (kD + 1) + kThreads / 32) * sizeof(float);
}

template <typename T, bool kHasMask>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_tiled_kernel(const T* __restrict__ qkv, const float* __restrict__ scale,
                                  const float* __restrict__ bias, const float* __restrict__ mask,
                                  const T* __restrict__ dout, T* __restrict__ dqkv,
                                  float* __restrict__ partial, float* __restrict__ partial_scale,
                                  Geometry g, int images_per_block) {
  constexpr int Dp = kD + kPad<T>;
  constexpr int Lkp = kTileK + kPad<T>;
  constexpr int Dq = kD + 1;  // f32 dq accumulator row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // [kTileQ][Dp] q tile (qn in cosine mode)
  T* sdo = sq + kTileQ * Dp;               // [kTileQ][Dp]
  T* sk = sdo + kTileQ * Dp;               // [kTileK][Dp] k tile (kn)
  T* sv = sk + kTileK * Dp;                // [kTileK][Dp]
  T* sa = sv + kTileK * Dp;                // [kTileQ][Lkp] a, rounded
  T* sdl = sa + kTileQ * Lkp;              // [kTileQ][Lkp] dls, rounded
  int* spix = reinterpret_cast<int*>(sdl + kTileQ * Lkp);  // [kMaxLTiled]
  float* srq = reinterpret_cast<float*>(spix + kMaxLTiled);  // [kMaxLTiled] 1 / |q|
  float* sm = srq + kMaxLTiled;            // [kMaxLTiled] row max
  float* sl = sm + kMaxLTiled;             // [kMaxLTiled] row sum
  float* sdot = sl + kMaxLTiled;           // [kMaxLTiled] rowsum(a32 da)
  float* srk = sdot + kMaxLTiled;          // [kTileK] 1 / |k| of the key tile
  float* sdq = srk + kTileK;               // [kMaxLTiled][Dq] dqn accumulator
  float* sred = sdq + kMaxLTiled * Dq;     // [kThreads / 32]

  const int win = blockIdx.x;
  const int h = blockIdx.y;
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  const int L = g.L;
  const int C = g.C;
  const int width = 3 * C;
  const float s = scale[h];
  const int b0 = blockIdx.z * images_per_block;
  const int b1 = min(g.B, b0 + images_per_block);
  const size_t slot = (size_t)blockIdx.x * gridDim.z + blockIdx.z;
  float* pb = partial + (slot * g.nheads + h) * L * L;
  float dsc = 0.f;  // this thread's share of dscale

  fill_pixel_table(g, win, spix);
  for (int b = b0; b < b1; ++b) {
    const size_t base = (size_t)b * g.Hp * g.Wp;  // the image's first pixel
    const T* image = qkv + base * width;
    const T* dimage = dout + base * C;

    // 1. m, l and dot of every query row
    for (int q0 = 0; q0 < L; q0 += kTileQ) {
      __syncthreads();  // spix is ready; the readers of sq, sdo, sk, sv are done
      load_tile_rows(image, width, 0, h, spix, q0, L, sq);
      load_tile_rows(dimage, C, 0, h, spix, q0, L, sdo);
      __syncthreads();
      normalize_rows(sq, kTileQ, srq + q0);
      float m[kRows], l[kRows], dsum[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        m[r] = -INFINITY;
        l[r] = dsum[r] = 0.f;
      }
      for (int k0 = 0; k0 < L; k0 += kTileK) {
        __syncthreads();  // sq is ready; the last tile's readers of sk, sv are done
        load_tile_rows(image, width, C, h, spix, k0, L, sk);
        load_tile_rows(image, width, 2 * C, h, spix, k0, L, sv);
        __syncthreads();
        normalize_rows(sk, kTileK, nullptr);
        __syncthreads();
        float sc[kRows][kTileKC], da[kRows][kTileKC];
        tile_dot(sq, sk, sc);
        tile_dot(sdo, sv, da);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = q0 + ti + 16 * r;
          const float* brow = bias + ((size_t)h * L + i) * L;
          const float* mrow = kHasMask ? mask + ((size_t)win * L + i) * L : nullptr;
          float tm = -INFINITY;
#pragma unroll
          for (int c = 0; c < kTileKC; ++c) {
            sc[r][c] = tile_logit<kHasMask>(sc[r][c], s, brow, mrow, i < L,
                                                      k0 + tj + 16 * c, L);
            tm = fmaxf(tm, sc[r][c]);
          }
          const float mnew = fmaxf(m[r], row_max16(tm));
          float e = 0.f, ed = 0.f;
#pragma unroll
          for (int c = 0; c < kTileKC; ++c) {
            const float ex = expf(sc[r][c] - mnew);
            e += ex;
            ed = fmaf(ex, da[r][c], ed);
          }
          const float rescale = expf(m[r] - mnew);
          l[r] = l[r] * rescale + row_sum16(e);
          dsum[r] = dsum[r] * rescale + row_sum16(ed);
          m[r] = mnew;
        }
      }
      if (tj == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = q0 + ti + 16 * r;
          sm[i] = m[r];
          sl[i] = l[r];
          sdot[i] = dsum[r] / l[r];
        }
      }
    }

    // 2. key tile by key tile: dk, dv in registers, dq into sdq
    for (int k0 = 0; k0 < L; k0 += kTileK) {
      __syncthreads();  // the readers of sk, sv and the statistics' writers are done
      load_tile_rows(image, width, C, h, spix, k0, L, sk);
      load_tile_rows(image, width, 2 * C, h, spix, k0, L, sv);
      __syncthreads();
      normalize_rows(sk, kTileK, srk);
      float dk[kTileKC][2], dv[kTileKC][2];  // key rows ti + 16 rr, head columns tj, tj + 16
#pragma unroll
      for (int rr = 0; rr < kTileKC; ++rr) dk[rr][0] = dk[rr][1] = dv[rr][0] = dv[rr][1] = 0.f;
      for (int q0 = 0; q0 < L; q0 += kTileQ) {
        __syncthreads();  // kn is ready; the last tile's readers of sq, sdo, sa, sdl are done
        load_tile_rows(image, width, 0, h, spix, q0, L, sq);
        load_tile_rows(dimage, C, 0, h, spix, q0, L, sdo);
        __syncthreads();
        normalize_rows(sq, kTileQ, nullptr);  // the same bits as in step 1
        __syncthreads();
        {
          float sc[kRows][kTileKC], da[kRows][kTileKC];
          tile_dot(sq, sk, sc);
          tile_dot(sdo, sv, da);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int lr = ti + 16 * r;
            const int i = q0 + lr;
            const float* brow = bias + ((size_t)h * L + i) * L;
            const float* mrow = kHasMask ? mask + ((size_t)win * L + i) * L : nullptr;
            const float mi = sm[i], li = sl[i], doti = sdot[i];
#pragma unroll
            for (int c = 0; c < kTileKC; ++c) {
              const int j = k0 + tj + 16 * c;
              const float logit =
                  tile_logit<kHasMask>(sc[r][c], s, brow, mrow, i < L, j, L);
              const float a32 = expf(logit - mi) / li;
              const float dl = a32 * (da[r][c] - doti);
              dsc = fmaf(dl, sc[r][c], dsc);  // padded rows and keys give 0
              sa[lr * Lkp + tj + 16 * c] = from_f<T>(a32);
              sdl[lr * Lkp + tj + 16 * c] = from_f<T>(dl * s);
              if (i < L && j < L) {
                float* slab = pb + (size_t)i * L + j;
                *slab = b == b0 ? dl : *slab + dl;
              }
            }
          }
        }
        __syncthreads();
        // dv += a^T do, dk += dls^T qn over the tile's 64 rows (padded rows
        // add zeros: their do is 0, so is their dl)
#pragma unroll 2
        for (int i = 0; i < kTileQ; ++i) {
          const float do0 = to_f(sdo[i * Dp + tj]), do1 = to_f(sdo[i * Dp + tj + 16]);
          const float qv0 = to_f(sq[i * Dp + tj]), qv1 = to_f(sq[i * Dp + tj + 16]);
#pragma unroll
          for (int rr = 0; rr < kTileKC; ++rr) {
            const float av = to_f(sa[i * Lkp + ti + 16 * rr]);
            const float lv = to_f(sdl[i * Lkp + ti + 16 * rr]);
            dv[rr][0] = fmaf(av, do0, dv[rr][0]);
            dv[rr][1] = fmaf(av, do1, dv[rr][1]);
            dk[rr][0] = fmaf(lv, qv0, dk[rr][0]);
            dk[rr][1] = fmaf(lv, qv1, dk[rr][1]);
          }
        }
        // dq of the tile's rows += dls kn over the key tile
        float dq[kRows][2];
#pragma unroll
        for (int r = 0; r < kRows; ++r) dq[r][0] = dq[r][1] = 0.f;
#pragma unroll 4
        for (int j = 0; j < kTileK; ++j) {
          const float k0v = to_f(sk[j * Dp + tj]), k1v = to_f(sk[j * Dp + tj + 16]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float lv = to_f(sdl[(ti + 16 * r) * Lkp + j]);
            dq[r][0] = fmaf(lv, k0v, dq[r][0]);
            dq[r][1] = fmaf(lv, k1v, dq[r][1]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float* acc = sdq + (size_t)(q0 + ti + 16 * r) * Dq + tj;
          acc[0] = k0 == 0 ? dq[r][0] : acc[0] + dq[r][0];
          acc[16] = k0 == 0 ? dq[r][1] : acc[16] + dq[r][1];
        }
      }
      // dk back through the normalisation of k (raw rows from device memory)
#pragma unroll
      for (int rr = 0; rr < kTileKC; ++rr) {
        const int j = k0 + ti + 16 * rr;
        const T* krow = j < L ? image + (size_t)spix[j] * width + C + h * kD : nullptr;
        const float x0 = krow != nullptr ? to_f(krow[tj]) : 0.f;
        const float x1 = krow != nullptr ? to_f(krow[tj + 16]) : 0.f;
        normalize_backward(x0, x1, j < L ? srk[ti + 16 * rr] : 0.f, dk[rr][0], dk[rr][1]);
        if (j < L) {
          T* dst = dqkv + (base + spix[j]) * width + C + h * kD + tj;
          dst[0] = from_f<T>(dk[rr][0]);
          dst[16] = from_f<T>(dk[rr][1]);
          dst[C] = from_f<T>(dv[rr][0]);
          dst[C + 16] = from_f<T>(dv[rr][1]);
        }
      }
    }

    // 3. dq back through the normalisation of q, and out
    __syncthreads();
    for (int q0 = 0; q0 < L; q0 += kTileQ) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = q0 + ti + 16 * r;
        float d0 = sdq[(size_t)i * Dq + tj], d1 = sdq[(size_t)i * Dq + tj + 16];
        const T* qrow = i < L ? image + (size_t)spix[i] * width + h * kD : nullptr;
        const float x0 = qrow != nullptr ? to_f(qrow[tj]) : 0.f;
        const float x1 = qrow != nullptr ? to_f(qrow[tj + 16]) : 0.f;
        normalize_backward(x0, x1, i < L ? srq[i] : 0.f, d0, d1);
        if (i < L) {
          T* dst = dqkv + (base + spix[i]) * width + h * kD + tj;
          dst[0] = from_f<T>(d0);
          dst[16] = from_f<T>(d1);
        }
      }
    }
  }
  const float total = block_sum(dsc, sred);
  if (threadIdx.x == 0) partial_scale[slot * g.nheads + h] = total;
}

template <typename T, bool kHasMask>
cudaError_t launch_fwd_tiled(const void* qkv, const void* scale, const void* bias,
                             const void* mask, void* out, const Geometry& g,
                             cudaStream_t stream) {
  auto kernel = window_attention_fwd_tiled_kernel<T, kHasMask>;
  constexpr size_t bytes = fwd_tiled_shared_bytes<T>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (g.L > kMaxLTiled || g.B > 65535 || g.nheads > 65535) return cudaErrorInvalidValue;
  const int nqt = (g.L + kTileQ - 1) / kTileQ;
  const dim3 grid(g.nW * nqt, g.nheads, g.B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<T*>(out), g,
      nqt);
  return cudaGetLastError();
}

template <typename T, bool kHasMask>
cudaError_t launch_bwd_tiled(const void* qkv, const void* scale, const void* bias,
                             const void* mask, const void* dout, void* dqkv, void* partial,
                             void* partial_scale, const Geometry& g, int images_per_block,
                             cudaStream_t stream) {
  auto kernel = window_attention_bwd_tiled_kernel<T, kHasMask>;
  constexpr size_t bytes = bwd_tiled_shared_bytes<T>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int zblocks = (g.B + images_per_block - 1) / images_per_block;
  if (g.L > kMaxLTiled || zblocks > 65535 || g.nheads > 65535) return cudaErrorInvalidValue;
  const dim3 grid(g.nW, g.nheads, zblocks);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<const T*>(dout), static_cast<T*>(dqkv), static_cast<float*>(partial),
      static_cast<float*>(partial_scale), g, images_per_block);
  return cudaGetLastError();
}

}  // namespace wattn
