// The first SwinV2 attention backward, for windows of 8 x 8 (L = 64), kept
// beside the window attention templates for that one size: at
// swinv2_tiny_window8_256's shapes (bs 128, bf16, NVIDIA H100 80GB HBM3,
// 700.00 W) the templates' cosine backward took 15.4354 ms per step against
// 12.8993 ms for this kernel, 20% more (PERF.md). The templates'
// backward is redesigned next; this file goes when it is no slower here.
//
// One block of 256 threads per (window position, head) loops over a slice
// of the images. q, k, their normalised copies, v and dout sit in shared
// memory as f32 (84,480 bytes); each thread owns a fixed 4x4 tile of the
// 64x64 logits, so the softmax, da, dl and the block's running dbias and
// dscale sums stay in registers (row reductions are 16-lane shuffles), and
// only a and dls go through shared memory for the transposed products. The
// block writes one (L, L) partial and one scalar: the slots of
// swin_attention_bwd.cu, added in slot order there.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace swin8 {

constexpr int kWs = 8;
constexpr int kL = kWs * kWs;  // tokens per window
constexpr int kD = 32;         // head dim
constexpr int kThreads = 256;  // 16 x 16 thread grid over each tile
constexpr int kDp = kD + 1;    // padded shared row strides
constexpr int kLp = kL + 1;
constexpr size_t kSharedBytes = (6 * kL * kDp + 2 * kL * kLp + 2 * kL) * sizeof(float);

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

// sum / max over the 16 lanes that share a tile row (lanes differ in bits 0-3)
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, bool kHasMask>
__global__ void __launch_bounds__(kThreads)
swin_attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ scale,
                          const float* __restrict__ bias, const float* __restrict__ mask,
                          const T* __restrict__ dout, T* __restrict__ dqkv,
                          float* __restrict__ partial_bias, float* __restrict__ partial_scale,
                          int B, int Hp, int Wp, int C, int ngx, int images_per_block) {
  extern __shared__ float smem[];
  float(*sq)[kDp] = reinterpret_cast<float(*)[kDp]>(smem);
  float(*sk)[kDp] = sq + kL;
  float(*sqn)[kDp] = sk + kL;
  float(*skn)[kDp] = sqn + kL;
  float(*sv)[kDp] = skn + kL;
  float(*sdo)[kDp] = sv + kL;
  float(*sa)[kLp] = reinterpret_cast<float(*)[kLp]>(smem + 6 * kL * kDp);
  float(*sdl)[kLp] = sa + kL;
  float* srq = smem + 6 * kL * kDp + 2 * kL * kLp;
  float* srk = srq + kL;
  __shared__ float swarp[kThreads / 32];

  const int win = blockIdx.x;  // row-major window index wy * ngx + wx
  const int h = blockIdx.y;
  const int nheads = gridDim.y;
  const int wy = win / ngx;
  const int wx = win - wy * ngx;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ti = tid / 16;  // tile row group: rows ti + 16 r
  const int tj = tid % 16;  // tile column group: cols tj + 16 c (or head cols tj, tj + 16)
  const size_t c3 = 3 * (size_t)C;
  const float s = scale[h];
  const float* bh = bias + (size_t)h * kL * kL;
  const float* mw = kHasMask ? mask + (size_t)win * kL * kL : nullptr;

  // this block's running sums over its images
  float dbias_acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) dbias_acc[r][c] = 0.f;
  float dscale_acc = 0.f;

  const int b0 = blockIdx.z * images_per_block;
  const int b1 = min(B, b0 + images_per_block);
  for (int b = b0; b < b1; ++b) {
    // token i of the window sits at pixel (wy*ws + i/ws, wx*ws + i%ws)
    auto pixel = [&](int i) -> size_t {
      const int y = wy * kWs + i / kWs;
      const int x = wx * kWs + i % kWs;
      return ((size_t)b * Hp + y) * Wp + x;
    };

    // 1. load head h's q, k, v and dout rows of the window
    for (int idx = tid; idx < kL * kD; idx += kThreads) {
      const int i = idx / kD;
      const int d = idx - i * kD;
      const size_t p = pixel(i);
      const T* src = qkv + p * c3 + h * kD + d;
      sq[i][d] = to_f(src[0]);
      sk[i][d] = to_f(src[C]);
      sv[i][d] = to_f(src[2 * C]);
      sdo[i][d] = to_f(dout[p * C + h * kD + d]);
    }
    __syncthreads();

    // 2. cosine normalisation in f32, rounded to T (one warp per row)
    for (int r = warp; r < 2 * kL; r += kThreads / 32) {
      const bool is_q = r < kL;
      const int i = is_q ? r : r - kL;
      const float x = is_q ? sq[i][lane] : sk[i][lane];
      float ss = x * x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      const float rinv = rsqrtf(ss + 1e-12f);
      const float xn = round_to<T>(x * rinv);
      if (is_q) {
        sqn[i][lane] = xn;
        if (lane == 0) srq[i] = rinv;
      } else {
        skn[i][lane] = xn;
        if (lane == 0) srk[i] = rinv;
      }
    }
    __syncthreads();

    // 3. cos = qn kn^T and da = do v^T on the thread's 4x4 tile, softmax and
    //    its backward in registers
    {
      float cosv[4][4], da[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) cosv[r][c] = da[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kD; ++d) {
        float qv[4], kv[4], dv_[4], vv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qv[r] = sqn[ti + 16 * r][d];
          dv_[r] = sdo[ti + 16 * r][d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kv[c] = skn[tj + 16 * c][d];
          vv[c] = sv[tj + 16 * c][d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            cosv[r][c] = fmaf(qv[r], kv[c], cosv[r][c]);
            da[r][c] = fmaf(dv_[r], vv[c], da[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        float a32[4];
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
          float logit = cosv[r][c] * s + bh[i * kL + j];
          if (kHasMask) logit += mw[i * kL + j];
          a32[c] = logit;
          mx = fmaxf(mx, logit);
        }
        mx = row_max16(mx);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a32[c] = expf(a32[c] - mx);
          sum += a32[c];
        }
        sum = row_sum16(sum);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a32[c] = a32[c] / sum;
          dot = fmaf(da[r][c], a32[c], dot);
        }
        dot = row_sum16(dot);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
          const float dl = a32[c] * (da[r][c] - dot);
          dbias_acc[r][c] += dl;
          dscale_acc = fmaf(dl, cosv[r][c], dscale_acc);
          sa[i][j] = round_to<T>(a32[c]);
          sdl[i][j] = round_to<T>(dl * s);
        }
      }
    }
    __syncthreads();

    // 4. the three products back to head width; thread tile rows ti + 16 r,
    //    head columns tj and tj + 16
    {
      float dqn[4][2], dkn[4][2], dv[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dqn[r][0] = dqn[r][1] = dkn[r][0] = dkn[r][1] = dv[r][0] = dv[r][1] = 0.f;
      // dv[j] = sum_i a[i][j] do[i],  dkn[j] = sum_i dls[i][j] qn[i]  (column reads)
#pragma unroll 4
      for (int i = 0; i < kL; ++i) {
        const float do0 = sdo[i][tj], do1 = sdo[i][tj + 16];
        const float qn0 = sqn[i][tj], qn1 = sqn[i][tj + 16];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float av = sa[i][ti + 16 * r];
          const float lv = sdl[i][ti + 16 * r];
          dv[r][0] = fmaf(av, do0, dv[r][0]);
          dv[r][1] = fmaf(av, do1, dv[r][1]);
          dkn[r][0] = fmaf(lv, qn0, dkn[r][0]);
          dkn[r][1] = fmaf(lv, qn1, dkn[r][1]);
        }
      }
      // dqn[i] = sum_j dls[i][j] kn[j]
#pragma unroll 4
      for (int j = 0; j < kL; ++j) {
        const float kn0 = skn[j][tj], kn1 = skn[j][tj + 16];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float lv = sdl[ti + 16 * r][j];
          dqn[r][0] = fmaf(lv, kn0, dqn[r][0]);
          dqn[r][1] = fmaf(lv, kn1, dqn[r][1]);
        }
      }
      // through the f32 row normalisation, then out in T
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        const float q0 = sq[i][tj], q1 = sq[i][tj + 16];
        const float k0 = sk[i][tj], k1 = sk[i][tj + 16];
        const float qdot = row_sum16(fmaf(q0, dqn[r][0], q1 * dqn[r][1]));
        const float kdot = row_sum16(fmaf(k0, dkn[r][0], k1 * dkn[r][1]));
        const float rq = srq[i], rk = srk[i];
        const float rq3 = rq * rq * rq, rk3 = rk * rk * rk;
        T* dst = dqkv + pixel(i) * c3 + h * kD + tj;
        dst[0] = from_f<T>(rq * dqn[r][0] - rq3 * q0 * qdot);
        dst[16] = from_f<T>(rq * dqn[r][1] - rq3 * q1 * qdot);
        dst[C] = from_f<T>(rk * dkn[r][0] - rk3 * k0 * kdot);
        dst[C + 16] = from_f<T>(rk * dkn[r][1] - rk3 * k1 * kdot);
        dst[2 * C] = from_f<T>(dv[r][0]);
        dst[2 * C + 16] = from_f<T>(dv[r][1]);
      }
    }
    __syncthreads();  // shared tiles are overwritten by the next image
  }

  // 5. this block's partial sums: slot (win * gridDim.z + z), head h
  const size_t slot = (size_t)win * gridDim.z + blockIdx.z;
  float* pb = partial_bias + (slot * nheads + h) * kL * kL;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) pb[(ti + 16 * r) * kL + tj + 16 * c] = dbias_acc[r][c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dscale_acc += __shfl_xor_sync(0xffffffffu, dscale_acc, off);
  if (lane == 0) swarp[warp] = dscale_acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += swarp[w];
    partial_scale[slot * nheads + h] = total;
  }
}

template <typename T, bool kHasMask>
cudaError_t launch_one(const T* qkv, const float* scale, const float* bias, const float* mask,
                       const T* dout, T* dqkv, float* pbias, float* pscale, int B, int Hp,
                       int Wp, int C, int nheads, int images_per_block, cudaStream_t stream) {
  auto kernel = swin_attention_bwd_kernel<T, kHasMask>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSharedBytes);
  if (err != cudaSuccess) return err;
  const int ngx = Wp / kWs;
  const int zblocks = (B + images_per_block - 1) / images_per_block;
  const dim3 grid(ngx * (Hp / kWs), nheads, zblocks);
  kernel<<<grid, kThreads, kSharedBytes, stream>>>(qkv, scale, bias, mask, dout, dqkv, pbias,
                                                   pscale, B, Hp, Wp, C, ngx, images_per_block);
  return cudaGetLastError();
}

}  // namespace swin8
