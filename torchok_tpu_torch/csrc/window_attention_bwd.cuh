// Backward of the window attention, shared by window_attention_bwd.cu
// (kGlobal = false), window_attention_global_bwd.cu (kGlobal = true) and
// swin_attention_bwd.cu (kCosine, with the shift mask kHasMask). See
// window_attention_common.cuh for the layout; L > 256 goes to
// window_attention_tiled.cuh. The forward is recomputed from the inputs;
// nothing else is saved.
//
// With T the input dtype and all else f32, per window and head:
//   s = q k^T;  logits = s scale_h (+ bias_h);  a32 = softmax;  a = T(a32)
//   dv = a^T do;  da = do v^T;  dl = a32 (da - rowsum(da a32))
//   dbias += dl;  dls = T(dl scale_h);  dq = dls k;  dk = dls^T q
// All five products are computed here. scale gets no gradient. In cosine
// mode q and k are first normalised (qn = T(q rq), rq = rsqrt(sum q^2 + eps),
// kn likewise) and take their places above, the mask is added to the logits,
// dscale += sum(dl s) with s the f32 cosine, and the gradients go back
// through the normalisation: dq = rq dqn - rq^3 q sum(q dqn), dk likewise.
//
// Design. The Pallas kernels add dbias (and, in global mode, dqg) into
// revisited output blocks over a sequential grid; CUDA blocks run in no
// order. So the sums that cross windows or images are made inside one block,
// by the thread that owns the element, in a fixed order, with no atomics:
//  * local mode: a block takes one (window position, head) and loops over a
//    slice of the images (grid nW x H x slices);
//  * global mode: a block takes one head and a slice of the images and loops
//    over each image's windows (grid 1 x H x slices), so dqg, the sum over an
//    image's windows, is accumulated by that one block into its f32 output
//    (first window stores, later ones add).
// A window is walked in tiles of 64 queries against all L keys held in shared
// memory; dk and dv (16*KC x 32 per head) stay in registers across the tiles.
// dl is 4 x KC per thread and tile, too much to keep for every tile at
// L = 196, so each block adds its dl into its own (L, L) slab of a scratch
// buffer in device memory (first visit stores, later ones add; the slab of a
// running block stays in L2), and window_attention_bwd_reduce adds the slabs
// in slot order. Results are bit-identical from run to run. In cosine mode
// dscale is a second sum, one fixed slot per block, added in slot order by
// swin_attention_bwd_reduce.
#pragma once
#include "window_attention_common.cuh"

namespace wattn {

template <typename T, int KC, bool kCosine = false>
constexpr size_t bwd_shared_bytes() {
  return (size_t)(2 * 16 * KC * (kD + kPad<T>) + 2 * kTileQ * (kD + kPad<T>) +
                  2 * kTileQ * (16 * KC + kPad<T>)) * sizeof(T) + 16 * KC * sizeof(int) +
         (kCosine ? (16 * KC + kTileQ + kThreads / 32) * sizeof(float) : 0);
}

template <typename T, int KC, bool kHasBias, bool kGlobal, bool kCosine, bool kHasMask>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const T* __restrict__ proj, const T* __restrict__ qg,
                            const float* __restrict__ scale, const float* __restrict__ bias,
                            const float* __restrict__ mask, const T* __restrict__ dout,
                            T* __restrict__ dproj, float* __restrict__ dqg,
                            float* __restrict__ partial, float* __restrict__ partial_scale,
                            Geometry g, int images_per_block) {
  static_assert(!(kCosine && kGlobal), "the cosine mode has no global queries");
  static_assert(!kCosine || kHasBias, "the cosine mode always has its bias");
  constexpr int Lk = 16 * KC;
  constexpr int Dp = kD + kPad<T>;
  constexpr int Lkp = Lk + kPad<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);  // [Lk][Dp]
  T* sv = sk + Lk * Dp;                    // [Lk][Dp]
  T* sq = sv + Lk * Dp;                    // [kTileQ][Dp]
  T* sdo = sq + kTileQ * Dp;               // [kTileQ][Dp]
  T* sa = sdo + kTileQ * Dp;               // [kTileQ][Lkp]  a, rounded
  T* sdl = sa + kTileQ * Lkp;              // [kTileQ][Lkp]  dls, rounded
  int* spix = reinterpret_cast<int*>(sdl + kTileQ * Lkp);  // [Lk] pixel table
  float* srk = reinterpret_cast<float*>(spix + Lk);          // cosine: [Lk] 1 / |k|
  float* srq = srk + Lk;                                     // cosine: [kTileQ] 1 / |q|
  float* sred = srq + kTileQ;                                // cosine: [kThreads / 32]

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int ti = tid / 16;
  const int tj = tid % 16;
  const int L = g.L;
  const int C = g.C;
  const int width = (kGlobal ? 2 : 3) * C;
  const int koff = kGlobal ? 0 : C;
  const float s = scale[h];
  const int win0 = kGlobal ? 0 : blockIdx.x;
  const int win1 = kGlobal ? g.nW : win0 + 1;
  const int b0 = blockIdx.z * images_per_block;
  const int b1 = min(g.B, b0 + images_per_block);
  // this block's slab of dl sums
  const size_t slot = kGlobal ? blockIdx.z : (size_t)blockIdx.x * gridDim.z + blockIdx.z;
  float* pb = kHasBias ? partial + (slot * g.nheads + h) * L * L : nullptr;
  float dsc = 0.f;  // cosine: this thread's share of dscale

  for (int b = b0; b < b1; ++b) {
    for (int win = win0; win < win1; ++win) {
      const bool first_visit = b == b0 && win == win0;
      const size_t base = (size_t)b * g.Hp * g.Wp;  // the image's first pixel
      fill_pixel_table(g, win, spix);
      __syncthreads();
      load_kv<T, KC>(g, proj + base * width, width, koff, h, spix, sk, sv);
      if constexpr (kCosine) {  // kn in place; the q tile's load below shares the barrier
        __syncthreads();
        normalize_rows(sk, L, srk);
      }
      float dk[KC][2], dv[KC][2];  // rows ti + 16 rr, head columns tj, tj + 16
#pragma unroll
      for (int rr = 0; rr < KC; ++rr) dk[rr][0] = dk[rr][1] = dv[rr][0] = dv[rr][1] = 0.f;

      for (int q0 = 0; q0 < L; q0 += kTileQ) {
        const int rows = min(kTileQ, L - q0);  // real query rows of this tile
        // 1. q and dout of the tile (rows beyond L zero)
        for (int idx = tid; idx < kTileQ * kParts<T>; idx += kThreads) {
          const int r = idx / kParts<T>;
          const int part = idx - r * kParts<T>;
          const T* qsrc = nullptr;
          const T* dosrc = nullptr;
          if (r < rows) {
            const size_t p = base + spix[q0 + r];
            qsrc = kGlobal ? qg + ((size_t)b * L + q0 + r) * C + h * kD
                           : proj + p * width + h * kD;
            dosrc = dout + p * C + h * kD;
          }
          copy_row_part(sq + r * Dp, qsrc, part);
          copy_row_part(sdo + r * Dp, dosrc, part);
        }
        __syncthreads();
        if constexpr (kCosine) {  // qn in place
          normalize_rows(sq, rows, srq);
          __syncthreads();
        }

        // 2. s = q k^T and da = do v^T on the thread's 4 x KC tile; softmax
        //    and its backward in registers
        {
          float sc[kRows][KC], da[kRows][KC];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int c = 0; c < KC; ++c) sc[r][c] = da[r][c] = 0.f;
#pragma unroll 2
          for (int d = 0; d < kD; ++d) {
            float qv[kRows], dov[kRows], kv[KC], vv[KC];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              qv[r] = to_f(sq[(ti + 16 * r) * Dp + d]);
              dov[r] = to_f(sdo[(ti + 16 * r) * Dp + d]);
            }
#pragma unroll
            for (int c = 0; c < KC; ++c) {
              kv[c] = to_f(sk[(tj + 16 * c) * Dp + d]);
              vv[c] = to_f(sv[(tj + 16 * c) * Dp + d]);
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
                da[r][c] = fmaf(dov[r], vv[c], da[r][c]);
              }
          }
          if constexpr (kCosine) {
            // as below, with the mask, and dscale from the cosine kept in sc
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const int lr = ti + 16 * r;  // row within the tile
              const int i = q0 + lr;
              const float* brow = bias + ((size_t)h * L + i) * L;
              const float* mrow = kHasMask ? mask + ((size_t)win * L + i) * L : nullptr;
              float a32[KC];
              float mx = -INFINITY;
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                const int j = tj + 16 * c;
                float logit = -INFINITY;  // padded keys: weight exactly 0
                if (j < L) {
                  logit = sc[r][c] * s;
                  if (lr < rows) {
                    logit += brow[j];
                    if (kHasMask) logit += mrow[j];
                  }
                }
                a32[c] = logit;
                mx = fmaxf(mx, logit);
              }
              mx = row_max16(mx);
              float sum = 0.f;
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                a32[c] = expf(a32[c] - mx);
                sum += a32[c];
              }
              sum = row_sum16(sum);
              float dot = 0.f;
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                a32[c] = a32[c] / sum;
                dot = fmaf(da[r][c], a32[c], dot);
              }
              dot = row_sum16(dot);
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                const int j = tj + 16 * c;
                const float dl = a32[c] * (da[r][c] - dot);
                dsc = fmaf(dl, sc[r][c], dsc);  // padded rows and keys give 0
                sa[lr * Lkp + j] = from_f<T>(a32[c]);
                sdl[lr * Lkp + j] = from_f<T>(dl * s);
                sc[r][c] = dl;
              }
            }
          } else {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const int lr = ti + 16 * r;  // row within the tile
              const int i = q0 + lr;
              const float* brow = kHasBias ? bias + ((size_t)h * L + i) * L : nullptr;
              float mx = -INFINITY;
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                const int j = tj + 16 * c;
                float logit = -INFINITY;  // padded keys: weight exactly 0
                if (j < L) {
                  logit = sc[r][c] * s;
                  if (kHasBias && lr < rows) logit += brow[j];
                }
                sc[r][c] = logit;
                mx = fmaxf(mx, logit);
              }
              mx = row_max16(mx);  // column 0 is always a real key, so mx is finite
              float sum = 0.f;
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                sc[r][c] = expf(sc[r][c] - mx);
                sum += sc[r][c];
              }
              sum = row_sum16(sum);
              float dot = 0.f;
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                sc[r][c] = sc[r][c] / sum;  // a32
                dot = fmaf(da[r][c], sc[r][c], dot);
              }
              dot = row_sum16(dot);
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                const int j = tj + 16 * c;
                const float dl = sc[r][c] * (da[r][c] - dot);
                sa[lr * Lkp + j] = from_f<T>(sc[r][c]);
                sdl[lr * Lkp + j] = from_f<T>(dl * s);
                sc[r][c] = dl;
              }
            }
          }
          if (kHasBias) {
            // add the tile's dl into this block's slab: all loads first (da is
            // free to hold them), then all stores, so that the loads overlap
            if (!first_visit) {
#pragma unroll
              for (int r = 0; r < kRows; ++r)
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                  const int lr = ti + 16 * r, j = tj + 16 * c;
                  da[r][c] = lr < rows && j < L ? pb[(size_t)(q0 + lr) * L + j] : 0.f;
                }
#pragma unroll
              for (int r = 0; r < kRows; ++r)
#pragma unroll
                for (int c = 0; c < KC; ++c) sc[r][c] += da[r][c];
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                const int lr = ti + 16 * r, j = tj + 16 * c;
                if (lr < rows && j < L) pb[(size_t)(q0 + lr) * L + j] = sc[r][c];
              }
          }
        }
        __syncthreads();

        // 3. dv += a^T do and dk += dls^T q over the tile's real rows (column
        //    reads of a and dls)
#pragma unroll 2
        for (int i = 0; i < rows; ++i) {
          const float do0 = to_f(sdo[i * Dp + tj]), do1 = to_f(sdo[i * Dp + tj + 16]);
          const float qv0 = to_f(sq[i * Dp + tj]), qv1 = to_f(sq[i * Dp + tj + 16]);
#pragma unroll
          for (int rr = 0; rr < KC; ++rr) {
            const float av = to_f(sa[i * Lkp + ti + 16 * rr]);
            const float lv = to_f(sdl[i * Lkp + ti + 16 * rr]);
            dv[rr][0] = fmaf(av, do0, dv[rr][0]);
            dv[rr][1] = fmaf(av, do1, dv[rr][1]);
            dk[rr][0] = fmaf(lv, qv0, dk[rr][0]);
            dk[rr][1] = fmaf(lv, qv1, dk[rr][1]);
          }
        }

        // 4. dq = dls k for the tile's rows
        {
          float dq[kRows][2];
#pragma unroll
          for (int r = 0; r < kRows; ++r) dq[r][0] = dq[r][1] = 0.f;
#pragma unroll 4
          for (int j = 0; j < L; ++j) {
            const float k0 = to_f(sk[j * Dp + tj]), k1 = to_f(sk[j * Dp + tj + 16]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float lv = to_f(sdl[(ti + 16 * r) * Lkp + j]);
              dq[r][0] = fmaf(lv, k0, dq[r][0]);
              dq[r][1] = fmaf(lv, k1, dq[r][1]);
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int lr = ti + 16 * r;
            if (lr < rows) {
              if (kGlobal) {
                // the image's windows share the queries: their dq add up here
                float* dst = dqg + ((size_t)b * L + q0 + lr) * C + h * kD + tj;
                dst[0] = win == 0 ? dq[r][0] : dst[0] + dq[r][0];
                dst[16] = win == 0 ? dq[r][1] : dst[16] + dq[r][1];
              } else if (!kCosine) {
                T* dst = dproj + (base + spix[q0 + lr]) * width + h * kD + tj;
                dst[0] = from_f<T>(dq[r][0]);
                dst[16] = from_f<T>(dq[r][1]);
              }
            }
          }
          if constexpr (kCosine) {
            // back through the normalisation of q (its raw rows from device
            // memory); every lane joins the row sums
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const int lr = ti + 16 * r;
              const T* qrow = lr < rows ? proj + (base + spix[q0 + lr]) * width + h * kD : nullptr;
              const float x0 = qrow != nullptr ? to_f(qrow[tj]) : 0.f;
              const float x1 = qrow != nullptr ? to_f(qrow[tj + 16]) : 0.f;
              normalize_backward(x0, x1, lr < rows ? srq[lr] : 0.f, dq[r][0], dq[r][1]);
              if (lr < rows) {
                T* dst = dproj + (base + spix[q0 + lr]) * width + h * kD + tj;
                dst[0] = from_f<T>(dq[r][0]);
                dst[16] = from_f<T>(dq[r][1]);
              }
            }
          }
        }
        __syncthreads();  // the tile's shared arrays are overwritten next
      }

      // 5. dk and dv of the window's real rows (cosine: dk back through the
      //    normalisation of k, its raw rows from device memory)
#pragma unroll
      for (int rr = 0; rr < KC; ++rr) {
        const int j = ti + 16 * rr;
        if constexpr (kCosine) {
          const T* krow = j < L ? proj + (base + spix[j]) * width + koff + h * kD : nullptr;
          const float x0 = krow != nullptr ? to_f(krow[tj]) : 0.f;
          const float x1 = krow != nullptr ? to_f(krow[tj + 16]) : 0.f;
          normalize_backward(x0, x1, j < L ? srk[j] : 0.f, dk[rr][0], dk[rr][1]);
        }
        if (j < L) {
          T* dst = dproj + (base + spix[j]) * width + koff + h * kD + tj;
          dst[0] = from_f<T>(dk[rr][0]);
          dst[16] = from_f<T>(dk[rr][1]);
          dst[C] = from_f<T>(dv[rr][0]);
          dst[C + 16] = from_f<T>(dv[rr][1]);
        }
      }
      __syncthreads();  // spix is rewritten for the next window
    }
  }
  if constexpr (kCosine) {
    const float total = block_sum(dsc, sred);
    if (tid == 0) partial_scale[slot * g.nheads + h] = total;
  }
}

// Adds the per-block slabs in slot order: dbias[h][i][j].
__global__ void window_attention_bwd_reduce(const float* __restrict__ partial,
                                            float* __restrict__ dbias, int slots, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) {
    float total = 0.f;
    for (int p = 0; p < slots; ++p) total += partial[(size_t)p * n + idx];
    dbias[idx] = total;
  }
}

template <typename T, int KC, bool kHasBias, bool kGlobal, bool kCosine = false,
          bool kHasMask = false>
cudaError_t launch_bwd_kc(const T* proj, const T* qg, const float* scale, const float* bias,
                          const float* mask, const T* dout, T* dproj, float* dqg, float* partial,
                          float* partial_scale, const Geometry& g, int images_per_block,
                          cudaStream_t stream) {
  auto kernel = window_attention_bwd_kernel<T, KC, kHasBias, kGlobal, kCosine, kHasMask>;
  constexpr size_t bytes = bwd_shared_bytes<T, KC, kCosine>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int zblocks = (g.B + images_per_block - 1) / images_per_block;
  if (zblocks > 65535 || g.nheads > 65535) return cudaErrorInvalidValue;
  const dim3 grid(kGlobal ? 1 : g.nW, g.nheads, zblocks);
  kernel<<<grid, kThreads, bytes, stream>>>(proj, qg, scale, bias, mask, dout, dproj, dqg,
                                            partial, partial_scale, g, images_per_block);
  return cudaGetLastError();
}

// Launches the backward kernel (instantiation by L as in the forward) and,
// with a bias, the reduction of its slabs. partial holds (slots, H, L, L) f32
// with slots = nW * ceil(B / images_per_block) in local mode and
// ceil(B / images_per_block) in global mode.
template <typename T, bool kHasBias, bool kGlobal>
cudaError_t launch_bwd(const void* proj, const void* qg, const void* scale, const void* bias,
                       const void* dout, void* dproj, void* dqg, void* dbias, void* partial,
                       const Geometry& g, int images_per_block, cudaStream_t stream) {
  if (images_per_block < 1) return cudaErrorInvalidValue;
  const T* p = static_cast<const T*>(proj);
  const T* q = static_cast<const T*>(qg);
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const T* d = static_cast<const T*>(dout);
  T* dp = static_cast<T*>(dproj);
  float* dq = static_cast<float*>(dqg);
  float* pa = static_cast<float*>(partial);
  cudaError_t err;
  if (g.L <= 64) {
    err = launch_bwd_kc<T, 4, kHasBias, kGlobal>(p, q, s, bi, nullptr, d, dp, dq, pa, nullptr, g,
                                              images_per_block, stream);
  } else if (g.L <= 208) {
    err = launch_bwd_kc<T, 13, kHasBias, kGlobal>(p, q, s, bi, nullptr, d, dp, dq, pa, nullptr, g,
                                               images_per_block, stream);
  } else {
    err = launch_bwd_kc<T, 16, kHasBias, kGlobal>(p, q, s, bi, nullptr, d, dp, dq, pa, nullptr, g,
                                               images_per_block, stream);
  }
  if (err != cudaSuccess || !kHasBias) return err;
  const int zblocks = (g.B + images_per_block - 1) / images_per_block;
  const int slots = (kGlobal ? 1 : g.nW) * zblocks;
  const int n = g.nheads * g.L * g.L;
  window_attention_bwd_reduce<<<(n + 255) / 256, 256, 0, stream>>>(
      pa, static_cast<float*>(dbias), slots, n);
  return cudaGetLastError();
}

}  // namespace wattn
