// SwinV2 cosine window attention on pre-partitioned, head-major windows,
// forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel torchok_tpu/ops/window_attention.py::
// _wa_kernel_mw (reached through _window_attention_pallas_mw, the hybrid
// custom_vjp and the public window_attention(..., use_pallas=True)). Same
// contract:
//   q, k, v (B_, H, L, D) bf16|f32, logit_scale (H,) f32, bias (H, L, L) f32,
//   mask (n_mask, L, L) f32 or null  ->  out (B_, H, L, D) in q's dtype,
//   qn = q * rsqrt(sum q^2 + 1e-12), kn likewise,
//   out = softmax(qn kn^T * exp(min(logit_scale_h, ln 100)) + bias_h
//                 + mask[window % n_mask]) v.
// Everything between the loads and the one rounding of the output is f32, as
// in the Pallas kernel (the spatial-layout kernel swin_attention_fwd.cu rounds
// qn, kn and the weights to the input type, so the two share no device code).
// The mask row is picked by the global window index (batch-major order)
// modulo n_mask, which serves n_mask = 1, nW (compact) and B_ (tiled) alike.
//
// Design: one block of 256 threads per (window, head). The block reads the
// window's q, k and v rows once into shared memory as f32, keeps the L x L
// logits there, and writes the output once. The 16 x 16 thread grid gives each
// thread an (L/16)^2 tile of logits; for the output the threads are laid
// min(D, 16) wide, so every shared-memory load feeds several FMAs. Row strides
// are padded by one word against bank conflicts. The TPU's windows_per_block
// (G windows per grid step, to amortise its per-step cost) has no counterpart:
// a block per window already fills the card.
//
// What bounds it: it moves q, k, v in and the output out (8 bytes per token
// and channel in bf16) for 4*L*D FLOPs per token and head, far below the
// tensor-core ridge; f32 FMAs fed from shared memory, not device memory, are
// its limit. Instantiated for L in {16, 64} and D in {8, 32}.
//
// Routes (window_attention_mw_fwd_route): bf16 at head dim 32 goes to the
// tensor-core kernel of window_attention_mw_mma.cuh, with the same f32
// numerics; f32, and bf16 at head dim 8, to the FMA template below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "window_attention_mw_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLn100 = 4.605170185988092f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int L, int D, bool kHasMask>
__global__ void __launch_bounds__(kThreads)
window_attention_mw_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ logit_scale,
                               const float* __restrict__ bias, const float* __restrict__ mask,
                               T* __restrict__ out, int H, int n_mask) {
  constexpr int Dp = D + 1;
  constexpr int Lp = L + 1;
  constexpr int R = L / 16;                    // logits rows and columns per thread
  constexpr int TD = D < 16 ? D : 16;          // threads across the head dim
  constexpr int TI = kThreads / TD;            // threads down the rows
  constexpr int OR = (L + TI - 1) / TI;        // output rows per thread
  constexpr int OC = D / TD;                   // output columns per thread
  constexpr int E = (L + 31) / 32;             // softmax entries per lane
  __shared__ float sq[L][Dp];
  __shared__ float sk[L][Dp];
  __shared__ float sv[L][Dp];
  __shared__ float sp[L][Lp];

  const int win = blockIdx.x;  // global window index, batch-major
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = ((size_t)win * H + h) * L * D;

  // 1. the (L, D) blocks of q, k, v: contiguous, read once
  for (int idx = tid; idx < L * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    sq[i][d] = to_f(q[base + idx]);
    sk[i][d] = to_f(k[base + idx]);
    sv[i][d] = to_f(v[base + idx]);
  }
  __syncthreads();

  // 2. cosine normalisation of the q and k rows in f32 (no rounding)
  for (int r = warp; r < 2 * L; r += kThreads / 32) {
    float(*m)[Dp] = r < L ? sq : sk;
    const int i = r < L ? r : r - L;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) ss += m[i][d] * m[i][d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss + 1e-12f);
    for (int d = lane; d < D; d += 32) m[i][d] *= inv;
  }
  __syncthreads();

  // 3. logits = (qn . kn) * scale + bias[h] (+ mask[win % n_mask]); thread
  //    tile rows ti + 16 r, columns tj + 16 c
  {
    const int ti = tid / 16;
    const int tj = tid % 16;
    float acc[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) qv[r] = sq[ti + 16 * r][d];
#pragma unroll
      for (int c = 0; c < R; ++c) kv[c] = sk[tj + 16 * c][d];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fmaf(qv[r], kv[c], acc[r][c]);
    }
    const float s = expf(fminf(logit_scale[h], kLn100));
    const float* bh = bias + (size_t)h * L * L;
    const float* mw = kHasMask ? mask + (size_t)(win % n_mask) * L * L : nullptr;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int i = ti + 16 * r;
        const int j = tj + 16 * c;
        float logit = acc[r][c] * s + bh[i * L + j];
        if (kHasMask) logit += mw[i * L + j];
        sp[i][j] = logit;
      }
    }
  }
  __syncthreads();

  // 4. f32 row softmax, one warp per row; the weights stay f32
  for (int i = warp; i < L; i += kThreads / 32) {
    float a[E];
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = lane + 32 * e;
      a[e] = j < L ? sp[i][j] : -INFINITY;
      mx = fmaxf(mx, a[e]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      a[e] = expf(a[e] - mx);  // lanes past L: exp(-inf) = 0
      sum += a[e];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = lane + 32 * e;
      if (j < L) sp[i][j] = a[e] / sum;
    }
  }
  __syncthreads();

  // 5. out = A @ V in f32, rounded once; thread tile rows ti + TI r, head
  //    columns td + TD c
  {
    const int ti = tid / TD;
    const int td = tid % TD;
    float acc[OR][OC];
#pragma unroll
    for (int r = 0; r < OR; ++r)
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[r][c] = 0.f;
    if (ti < L) {  // with L < TI the upper threads have no row
#pragma unroll 8
      for (int j = 0; j < L; ++j) {
        float av[OR], vv[OC];
#pragma unroll
        for (int r = 0; r < OR; ++r) av[r] = sp[(ti + TI * r) % L][j];
#pragma unroll
        for (int c = 0; c < OC; ++c) vv[c] = sv[j][td + TD * c];
#pragma unroll
        for (int r = 0; r < OR; ++r)
#pragma unroll
          for (int c = 0; c < OC; ++c) acc[r][c] = fmaf(av[r], vv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < OR; ++r) {
        const int i = ti + TI * r;
        if (i < L) {
#pragma unroll
          for (int c = 0; c < OC; ++c)
            out[base + (size_t)i * D + td + TD * c] = from_f<T>(acc[r][c]);
        }
      }
    }
  }
}

template <typename T, int L, int D>
cudaError_t launch_ld(const void* q, const void* k, const void* v, const void* logit_scale,
                      const void* bias, const void* mask, void* out, int B, int H, int n_mask,
                      cudaStream_t stream) {
  const dim3 grid(B, H);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* sp = static_cast<const float*>(logit_scale);
  const float* bp = static_cast<const float*>(bias);
  const float* mp = static_cast<const float*>(mask);
  T* op = static_cast<T*>(out);
  if (mask != nullptr) {
    window_attention_mw_fwd_kernel<T, L, D, true>
        <<<grid, kThreads, 0, stream>>>(qp, kp, vp, sp, bp, mp, op, H, n_mask);
  } else {
    window_attention_mw_fwd_kernel<T, L, D, false>
        <<<grid, kThreads, 0, stream>>>(qp, kp, vp, sp, bp, mp, op, H, 1);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* logit_scale,
                   const void* bias, const void* mask, void* out, int B, int H, int L, int D,
                   int n_mask, cudaStream_t st) {
  if (L == 64 && D == 32) return launch_ld<T, 64, 32>(q, k, v, logit_scale, bias, mask, out, B, H, n_mask, st);
  if (L == 64 && D == 8) return launch_ld<T, 64, 8>(q, k, v, logit_scale, bias, mask, out, B, H, n_mask, st);
  if (L == 16 && D == 32) return launch_ld<T, 16, 32>(q, k, v, logit_scale, bias, mask, out, B, H, n_mask, st);
  if (L == 16 && D == 8) return launch_ld<T, 16, 8>(q, k, v, logit_scale, bias, mask, out, B, H, n_mask, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// 0: the FMA template, 1: the tensor-core kernel (window_attention_mw_mma.cuh)
static int route_of(int dtype, int L, int D) {
  return dtype == 1 && D == 32 && (L == 16 || L == 64) ? 1 : 0;
}

// The route a launch of these arguments takes.
extern "C" int window_attention_mw_fwd_route(int dtype, int L, int D) {
  return route_of(dtype, L, D);
}

// dtype: 0 = float32, 1 = bfloat16. mask may be null (then n_mask is not
// read). windows: the windows of a mask row each block of the tensor-core
// route walks (ops.window_attention.forward_plan); the FMA route ignores it.
// Returns the launch's CUDA error (0 on success).
extern "C" int window_attention_mw_fwd(const void* q, const void* k, const void* v,
                                       const void* logit_scale, const void* bias,
                                       const void* mask, void* out, int dtype, int B, int H,
                                       int L, int D, int n_mask, int windows, void* stream) {
  if (B < 1 || H < 1 || H > 65535 || (mask != nullptr && n_mask < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route_of(dtype, L, D) == 1) {
    if (L == 64) return (int)mw_mma::launch<64>(q, k, v, logit_scale, bias, mask, out, B, H, n_mask, windows, st);
    return (int)mw_mma::launch<16>(q, k, v, logit_scale, bias, mask, out, B, H, n_mask, windows, st);
  }
  if (dtype == 0) return (int)launch<float>(q, k, v, logit_scale, bias, mask, out, B, H, L, D, n_mask, st);
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, k, v, logit_scale, bias, mask, out, B, H, L, D, n_mask, st);
  }
  return (int)cudaErrorInvalidValue;
}
