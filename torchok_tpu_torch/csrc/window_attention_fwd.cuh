// Forward of the window attention, shared by window_attention_fwd.cu
// (kGlobal = false: q, k, v of the window's own tokens, bias optional),
// window_attention_global_fwd.cu (kGlobal = true: k, v of the window, q the
// image's shared queries) and swin_attention_fwd.cu (kCosine: q and k
// row-normalised before the product, the per-head scale multiplies the
// cosine, bias and optionally the shift mask kHasMask are added). See
// window_attention_common.cuh for the layout; L > 256 goes to
// window_attention_tiled.cuh.
//
// One block per (window, query tile, head, image): it holds all L keys and
// values of the window and one tile of 64 queries, computes the tile's logits
// in registers (4 x KC per thread), takes the f32 softmax with 16-lane
// shuffles, rounds the weights to the input dtype into shared memory and
// multiplies by v. At L = 196 the four query tiles of a window are four
// blocks that each re-read k and v (from L2), which keeps the logits out of
// shared memory and gives stage 3 of GCViT (one window per image) enough
// blocks to fill the card.
#pragma once
#include "window_attention_common.cuh"

namespace wattn {

template <typename T, int KC>
constexpr size_t fwd_shared_bytes() {
  return (size_t)(2 * 16 * KC * (kD + kPad<T>) + kTileQ * (kD + kPad<T>) +
                  kTileQ * (16 * KC + kPad<T>)) * sizeof(T) + 16 * KC * sizeof(int);
}

template <typename T, int KC, bool kHasBias, bool kGlobal, bool kCosine, bool kHasMask>
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const T* __restrict__ proj, const T* __restrict__ qg,
                            const float* __restrict__ scale, const float* __restrict__ bias,
                            const float* __restrict__ mask, T* __restrict__ out, Geometry g,
                            int nqt) {
  static_assert(!(kCosine && kGlobal), "the cosine mode has no global queries");
  constexpr int Lk = 16 * KC;
  constexpr int Dp = kD + kPad<T>;
  constexpr int Lkp = Lk + kPad<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);  // [Lk][Dp]
  T* sv = sk + Lk * Dp;                    // [Lk][Dp]
  T* sq = sv + Lk * Dp;                    // [kTileQ][Dp]
  T* sa = sq + kTileQ * Dp;                // [kTileQ][Lkp]
  int* spix = reinterpret_cast<int*>(sa + kTileQ * Lkp);  // [Lk] pixel table

  const int win = blockIdx.x / nqt;
  const int q0 = (blockIdx.x - win * nqt) * kTileQ;  // first query row of this tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ti = tid / 16;
  const int tj = tid % 16;
  const int L = g.L;
  const int C = g.C;
  const int width = (kGlobal ? 2 : 3) * C;

  // 1. k and v of the window, q of this tile (rows beyond L zero)
  fill_pixel_table(g, win, spix);
  __syncthreads();
  const T* image = proj + (size_t)b * g.Hp * g.Wp * width;
  load_kv<T, KC>(g, image, width, kGlobal ? 0 : C, h, spix, sk, sv);
  for (int idx = tid; idx < kTileQ * kParts<T>; idx += kThreads) {
    const int r = idx / kParts<T>;
    const int part = idx - r * kParts<T>;
    const int i = q0 + r;
    const T* src = nullptr;
    if (i < L) {
      src = kGlobal ? qg + ((size_t)b * L + i) * C + h * kD
                    : image + (size_t)spix[i] * width + h * kD;
    }
    copy_row_part(sq + r * Dp, src, part);
  }
  __syncthreads();
  if constexpr (kCosine) {  // qn and kn, in place
    normalize_rows(sk, L, nullptr);
    normalize_rows(sq, kTileQ, nullptr);
    __syncthreads();
  }

  // 2. logits = (q . k) * scale[h] (+ bias[h]) (+ mask[win]); f32 softmax
  //    per row; the weights are rounded to T before they meet v
  {
    float acc[kRows][KC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float qv[kRows], kv[KC];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = to_f(sq[(ti + 16 * r) * Dp + d]);
#pragma unroll
      for (int c = 0; c < KC; ++c) kv[c] = to_f(sk[(tj + 16 * c) * Dp + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[r][c] = fmaf(qv[r], kv[c], acc[r][c]);
    }
    const float s = scale[h];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + ti + 16 * r;
      const float* brow = kHasBias ? bias + ((size_t)h * L + i) * L : nullptr;
      const float* mrow = kHasMask ? mask + ((size_t)win * L + i) * L : nullptr;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int j = tj + 16 * c;
        float logit = -INFINITY;  // padded keys: weight exactly 0
        if (j < L) {
          logit = acc[r][c] * s;
          if (kHasBias && i < L) logit += brow[j];
          if (kHasMask && i < L) logit += mrow[j];
        }
        acc[r][c] = logit;
        mx = fmaxf(mx, logit);
      }
      mx = row_max16(mx);  // column 0 is always a real key, so mx is finite
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        acc[r][c] = expf(acc[r][c] - mx);
        sum += acc[r][c];
      }
      sum = row_sum16(sum);
#pragma unroll
      for (int c = 0; c < KC; ++c) sa[(ti + 16 * r) * Lkp + tj + 16 * c] = from_f<T>(acc[r][c] / sum);
    }
  }
  __syncthreads();

  // 3. out = a @ v in f32; thread tile rows ti + 16 r, head columns tj, tj + 16
  {
    float acc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const float v0 = to_f(sv[j * Dp + tj]);
      const float v1 = to_f(sv[j * Dp + tj + 16]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = to_f(sa[(ti + 16 * r) * Lkp + j]);
        acc[r][0] = fmaf(av, v0, acc[r][0]);
        acc[r][1] = fmaf(av, v1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + ti + 16 * r;
      if (i < L) {
        T* dst = out + ((size_t)b * g.Hp * g.Wp + spix[i]) * C + h * kD + tj;
        dst[0] = from_f<T>(acc[r][0]);
        dst[16] = from_f<T>(acc[r][1]);
      }
    }
  }
}

template <typename T, int KC, bool kHasBias, bool kGlobal, bool kCosine, bool kHasMask>
cudaError_t launch_fwd_kc(const T* proj, const T* qg, const float* scale, const float* bias,
                          const float* mask, T* out, const Geometry& g, cudaStream_t stream) {
  auto kernel = window_attention_fwd_kernel<T, KC, kHasBias, kGlobal, kCosine, kHasMask>;
  constexpr size_t bytes = fwd_shared_bytes<T, KC>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int nqt = (g.L + kTileQ - 1) / kTileQ;
  if (g.B > 65535 || g.nheads > 65535) return cudaErrorInvalidValue;
  const dim3 grid(g.nW * nqt, g.nheads, g.B);
  kernel<<<grid, kThreads, bytes, stream>>>(proj, qg, scale, bias, mask, out, g, nqt);
  return cudaGetLastError();
}

// picks the instantiation by L: 4 key columns per thread up to 64 keys, 13 up
// to 208 (L 196 of ws 14, L 144 of ws 12), 16 up to 256
template <typename T, bool kHasBias, bool kGlobal, bool kCosine = false, bool kHasMask = false>
cudaError_t launch_fwd(const void* proj, const void* qg, const void* scale, const void* bias,
                       const void* mask, void* out, const Geometry& g, cudaStream_t stream) {
  const T* p = static_cast<const T*>(proj);
  const T* q = static_cast<const T*>(qg);
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  T* o = static_cast<T*>(out);
  if (g.L <= 64) {
    return launch_fwd_kc<T, 4, kHasBias, kGlobal, kCosine, kHasMask>(p, q, s, bi, m, o, g, stream);
  }
  if (g.L <= 208) {
    return launch_fwd_kc<T, 13, kHasBias, kGlobal, kCosine, kHasMask>(p, q, s, bi, m, o, g, stream);
  }
  return launch_fwd_kc<T, 16, kHasBias, kGlobal, kCosine, kHasMask>(p, q, s, bi, m, o, g, stream);
}

}  // namespace wattn
