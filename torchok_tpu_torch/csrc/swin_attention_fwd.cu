// SwinV2 shifted-window cosine attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel torchok_tpu/ops/swin_attention.py::_fwd_kernel
// (cosine mode, spatial layout; reached through _fwd_pallas and the public
// fused_swin_attention). Same contract:
//   qkv (B, Hp, Wp, 3C) bf16|f32, scale (H,) f32 = exp(min(logit_scale, ln 100)),
//   bias (H, L, L) f32, mask (nW, L, L) f32 or null  ->  out (B, Hp, Wp, C), qkv's dtype.
// Window partition and reverse happen in the indexing: no partitioned copy of
// qkv or of the output is ever made.
//
// Rounding points follow the Pallas kernel: q and k are row-normalised in f32
// (x * rsqrt(sum x^2 + 1e-12)) and rounded to the input dtype, QK^T
// accumulates in f32, then *scale + bias (+ mask) and an f32 softmax, the
// attention weights are rounded to the input dtype, and PV accumulates in f32
// before the output is rounded.
//
// Design: one block of 256 threads per (window, head, image). The block reads
// the window's 64 q, k and v rows of width 32 once, keeps them and the 64x64
// logits in shared memory (41 KB), and writes the head's 32 output columns
// once. Each thread owns a 4x4 tile of logits and a 4x2 tile of the output,
// so every shared-memory load feeds two or more FMAs; row strides are padded
// by one word so the column reads hit distinct banks.
//
// What bounds it: at L = 64 and D = 32 the kernel moves qkv in and the output
// out (8 bytes per token per channel in bf16) and does about 4*L*D FLOPs per
// token per head, so it sits far below the tensor-core ridge. Its limit is
// shared-memory bandwidth and latency inside each block, not device memory.
// The TPU-specific parts of the Pallas kernel (two-window sublane packing,
// the VMEM budget gate, shard_map) have no counterpart here; wgmma and TMA
// are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWs = 8;
constexpr int kL = kWs * kWs;  // tokens per window
constexpr int kD = 32;         // head dim
constexpr int kThreads = 256;  // 16 x 16 thread grid over each tile
constexpr int kDp = kD + 1;    // padded shared row strides
constexpr int kLp = kL + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an f32 value to T and back (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, bool kHasMask>
__global__ void __launch_bounds__(kThreads)
swin_attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ scale,
                          const float* __restrict__ bias, const float* __restrict__ mask,
                          T* __restrict__ out, int Hp, int Wp, int C, int ngx) {
  __shared__ float sq[kL][kDp];
  __shared__ float sk[kL][kDp];
  __shared__ float sv[kL][kDp];
  __shared__ float sp[kL][kLp];

  const int win = blockIdx.x;  // row-major window index wy * ngx + wx
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wy = win / ngx;
  const int wx = win - wy * ngx;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t c3 = 3 * (size_t)C;

  // token i of the window sits at pixel (wy*ws + i/ws, wx*ws + i%ws)
  auto pixel = [&](int i) -> size_t {
    const int y = wy * kWs + i / kWs;
    const int x = wx * kWs + i % kWs;
    return ((size_t)b * Hp + y) * Wp + x;
  };

  // 1. load head h's q, k, v rows of the window (one row of 32 per warp step)
  for (int idx = tid; idx < kL * kD; idx += kThreads) {
    const int i = idx / kD;
    const int d = idx - i * kD;
    const T* src = qkv + pixel(i) * c3 + h * kD + d;
    sq[i][d] = to_f(src[0]);
    sk[i][d] = to_f(src[C]);
    sv[i][d] = to_f(src[2 * C]);
  }
  __syncthreads();

  // 2. cosine normalisation of q and k rows in f32, rounded to T (one warp per row)
  for (int r = warp; r < 2 * kL; r += kThreads / 32) {
    float(*m)[kDp] = r < kL ? sq : sk;
    const int i = r < kL ? r : r - kL;
    const float x = m[i][lane];
    float ss = x * x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    m[i][lane] = round_to<T>(x * rsqrtf(ss + 1e-12f));
  }
  __syncthreads();

  // 3. logits = (qn . kn) * scale[h] + bias[h] (+ mask[win]); thread tile
  //    rows ti + 16r, cols tj + 16c
  {
    const int ti = tid / 16;
    const int tj = tid % 16;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sq[ti + 16 * r][d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sk[tj + 16 * c][d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(qv[r], kv[c], acc[r][c]);
    }
    const float s = scale[h];
    const float* bh = bias + (size_t)h * kL * kL;
    const float* mw = kHasMask ? mask + (size_t)win * kL * kL : nullptr;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ti + 16 * r;
        const int j = tj + 16 * c;
        float logit = acc[r][c] * s + bh[i * kL + j];
        if (kHasMask) logit += mw[i * kL + j];
        sp[i][j] = logit;
      }
    }
  }
  __syncthreads();

  // 4. f32 row softmax, one warp per row, two entries per lane; the weights
  //    are rounded to T before PV
  for (int i = warp; i < kL; i += kThreads / 32) {
    const float a0 = sp[i][lane];
    const float a1 = sp[i][lane + 32];
    float mx = fmaxf(a0, a1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float e0 = expf(a0 - mx);
    const float e1 = expf(a1 - mx);
    float sum = e0 + e1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sp[i][lane] = round_to<T>(e0 / sum);
    sp[i][lane + 32] = round_to<T>(e1 / sum);
  }
  __syncthreads();

  // 5. out = A @ V in f32; thread tile rows ti + 16r, head columns td + 16c
  {
    const int ti = tid / 16;
    const int td = tid % 16;
    float acc[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 8
    for (int j = 0; j < kL; ++j) {
      float av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = sp[ti + 16 * r][j];
      const float v0 = sv[j][td];
      const float v1 = sv[j][td + 16];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(av[r], v0, acc[r][0]);
        acc[r][1] = fmaf(av[r], v1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      T* dst = out + pixel(ti + 16 * r) * C + h * kD + td;
      dst[0] = from_f<T>(acc[r][0]);
      dst[16] = from_f<T>(acc[r][1]);
    }
  }
}

template <typename T>
void launch(const void* qkv, const void* scale, const void* bias, const void* mask,
            void* out, int B, int Hp, int Wp, int C, int nheads, cudaStream_t stream) {
  const int ngx = Wp / kWs;
  const dim3 grid(ngx * (Hp / kWs), nheads, B);
  const T* q = static_cast<const T*>(qkv);
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  T* o = static_cast<T*>(out);
  if (mask != nullptr) {
    swin_attention_fwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(q, s, bi, m, o, Hp, Wp, C, ngx);
  } else {
    swin_attention_fwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(q, s, bi, m, o, Hp, Wp, C, ngx);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null (unshifted blocks).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int swin_attention_fwd(const void* qkv, const void* scale, const void* bias,
                                  const void* mask, void* out, int dtype, int B, int Hp,
                                  int Wp, int C, int nheads, int ws, void* stream) {
  if (ws != kWs || C != nheads * kD || Hp % kWs != 0 || Wp % kWs != 0 || B < 1 ||
      B > 65535 || nheads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(qkv, scale, bias, mask, out, B, Hp, Wp, C, nheads, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(qkv, scale, bias, mask, out, B, Hp, Wp, C, nheads, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
