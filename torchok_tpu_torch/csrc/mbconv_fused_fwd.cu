// One inference MBConv block, fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/probe_mbconv_fused.py::_kernel
// (reached through pallas_block). Same contract, f32 inside:
//   x (N, H, W, C) NHWC bf16|f32; parameters f32 (the wrapper widens them)
//   a = swish(x @ w_exp * s1 + b1)                       (N, H, W, mid)
//   d = swish(depthwise_kxk(zero_pad(a)) * s2 + b2)      zero padding AFTER the swish
//   g = sigmoid(swish(mean_hw(d) @ w_se1 + b_se1) @ w_se2 + b_se2)   (N, mid)
//   y = round_T((d * g) @ w_proj * s3 + b3 + float(x))
//
// What is hard here: the TPU kernel keeps one whole expanded image in VMEM
// and takes the SE mean from it before the projection. An expanded image is
// 1.76 MB in f32 at 56x56x144 and 225 KB at 7x7x1152; a Hopper block has at
// most 227 KB of shared memory. So the block is three launches, no atomics,
// and the expanded tensor never goes to device memory:
//   (a) statistics: grid (row strip, image). The block holds the strip's x
//       rows and (k-1)/2 halo rows on each side, and for each chunk of mid
//       channels expands them (f32 FMAs from shared memory), applies the
//       depthwise conv, the affine and swish, and sums the strip's pixels of
//       each channel into its fixed slot of partial (N, strips, mid);
//   (b) gate: one block per image adds the strips' sums in order, divides by
//       H*W and applies the two small SE layers;
//   (c) project: the grid of (a) recomputes the same values with the same
//       device code (so the SE mean is over exactly these numbers), scales
//       them by the gate and accumulates the projection of the strip in
//       shared memory over the chunks; then affine, + x as read, one rounding.
// Every sum has a fixed order, so the result is bit-equal from run to run.
// x is read twice and the expand and depthwise work done twice (plus the
// halo rows): about 1.8 times the arithmetic of one pass, against the
// unfused chain's several round trips of the expanded tensor.
//
// This is the f32 route. bf16 takes mbconv_fused_cluster.cuh (entry
// mbconv_fused_cluster_fwd below) wherever ops/mbconv_fused.py::plan_cluster
// fits an image into a cluster; other bf16 shapes come here too.
//
// What bounds it: 13.2 GFLOP against 77 MB at B0's 56x56 block at batch 256
// (bf16), so the operations do. This first version runs them as f32 FMAs fed
// from shared memory (8x4 and 4x8 register tiles; the depthwise conv slides
// a window along 8 pixels of a row with the taps in registers), far from the
// tensor cores. The host (ops/mbconv_fused.py::plan) picks the widest chunk
// of expanded channels first, then the tallest strip that fits 227 KB: each
// chunk repeats a barrier-separated expand whose k-loop one to four warps
// run, so fewer, wider chunks beat two blocks an SM (measured on the H100).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mbconv_fused_cluster.cuh"  // the bf16 route: one launch a block, clusters

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 8;  // pixels of a row per depthwise work item
constexpr size_t kSharedLimit = 232448;

struct Params {
  const float *w_exp, *s1, *b1, *w_dw, *s2, *b2, *w_se1, *b_se1, *w_se2, *b_se2, *w_proj, *s3,
      *b3;
};

struct Dims {
  int N, H, W, C, mid, rd, rows, chunk, strips;
};

__host__ __device__ constexpr size_t up4(size_t v) { return (v + 3) / 4 * 4; }

// Offsets (in floats) of the shared buffers; ops/mbconv_fused.py::shared_bytes
// computes the same total for the project pass.
struct SharedLayout {
  int lda;         // x row stride: pixels of the strip with its halo, rounded to 8
  int pos_stride;  // floats per pixel in the expansion and activation buffers
  size_t x, e, e_size, we, vec, red, v, v_size, wp, g, y, y_size, total;
  __host__ __device__ SharedLayout(int W, int C, int K, int rows, int chunk, int itemsize,
                                   bool project) {
    const int pad = (K - 1) / 2;
    const int halo = rows + 2 * pad;
    lda = (halo * W + 7) / 8 * 8;
    pos_stride = chunk + 1;  // odd: neighbouring work items fall in other banks
    x = 0;
    e = x + up4((size_t)C * lda * itemsize / 4);
    e_size = (size_t)halo * (W + 2 * pad) * pos_stride;
    we = e + up4(e_size);
    vec = we + up4((size_t)C * chunk);
    red = vec + up4((size_t)chunk * (4 + K * K));
    v = red + kThreads;
    v_size = up4((size_t)rows * W) * pos_stride;
    wp = v + (project ? up4(v_size) : 0);
    g = wp + (project ? up4((size_t)chunk * C) : 0);
    y = g + (project ? up4(chunk) : 0);
    y_size = (size_t)rows * W * C;
    total = y + (project ? up4(y_size) : 0);
  }
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// explicit roundings: both passes compute the same bits whatever the
// compiler would contract
__device__ __forceinline__ float sigmoid(float a) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
}
__device__ __forceinline__ float swish(float a) { return __fmul_rn(a, sigmoid(a)); }

// eight consecutive values of a row of x in shared memory, as f32
__device__ __forceinline__ void load8(const float* src, float (&a)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
  a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&a)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    a[2 * i] = f.x;
    a[2 * i + 1] = f.y;
  }
}

// The expansion of one chunk: E[pix][c] = swish(sum_i x[pix][i] w[i][c] * s1 + b1)
// for the x pixels held, written into the zero-bordered buffer es. Tiles of
// 8 pixels x 4 channels per thread; xs is channel-major (xs[i * lda + pix]).
template <typename T>
__device__ __forceinline__ void expand_chunk(const T* xs, const float* we, const float* s1,
                                             const float* b1, float* es, const Dims& d,
                                             const SharedLayout& L, int xpix, int hr0, int pad) {
  const int cq = d.chunk / 4;
  const int tiles = (xpix + 7) / 8 * cq;
  const int wpad = d.W + 2 * pad;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int p0 = t / cq * 8;
    const int c0 = t % cq * 4;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll 4
    for (int i = 0; i < d.C; ++i) {
      float a[8];
      load8(xs + (size_t)i * L.lda + p0, a);
      const float4 b = *reinterpret_cast<const float4*>(we + i * d.chunk + c0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] = __fmaf_rn(a[j], b.x, acc[j][0]);
        acc[j][1] = __fmaf_rn(a[j], b.y, acc[j][1]);
        acc[j][2] = __fmaf_rn(a[j], b.z, acc[j][2]);
        acc[j][3] = __fmaf_rn(a[j], b.w, acc[j][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pix = p0 + j;
      if (pix < xpix) {
        const int row = pix / d.W;
        float* dst = es + ((size_t)(hr0 + row) * wpad + pix - row * d.W + pad) * L.pos_stride + c0;
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q] = swish(__fmaf_rn(acc[j][q], s1[c0 + q], b1[c0 + q]));
      }
    }
  }
}

// The depthwise conv of one chunk over the strip's rows, then affine and
// swish: each value goes to sink(pixel of the strip, channel of the chunk, v)
// in a fixed order per thread. A thread keeps one channel (its taps in
// registers) and slides a window along kSeg pixels of a row.
template <int K, typename Sink>
__device__ __forceinline__ void depthwise_chunk(const float* es, const float* wd, const float* s2,
                                                const float* b2, const Dims& d,
                                                const SharedLayout& L, int rows, Sink& sink) {
  constexpr int pad = (K - 1) / 2;
  const int wpad = d.W + 2 * pad;
  const int c = threadIdx.x % d.chunk;
  float wk[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = wd[t * d.chunk + c];
  const float s2c = s2[c], b2c = b2[c];
  const int segs = (d.W + kSeg - 1) / kSeg;
  const int items = rows * segs;
  for (int it = threadIdx.x / d.chunk; it < items; it += kThreads / d.chunk) {
    const int r = it / segs;
    const int j0 = (it - r * segs) * kSeg;
    const int len = min(kSeg, d.W - j0);
    float acc[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) acc[j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      // output row r reads halo rows r .. r + K - 1, padded columns j0 ..
      const float* src = es + ((size_t)(r + dy) * wpad + j0) * L.pos_stride + c;
      float win[kSeg + K - 1];
#pragma unroll
      for (int q = 0; q < kSeg + K - 1; ++q) win[q] = q < len + K - 1 ? src[q * L.pos_stride] : 0.f;
#pragma unroll
      for (int j = 0; j < kSeg; ++j)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) acc[j] = __fmaf_rn(win[j + dx], wk[dy * K + dx], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      if (j < len) sink(r * d.W + j0 + j, c, swish(__fmaf_rn(acc[j], s2c, b2c)));
  }
}

struct SumSink {
  float sum = 0.f;
  __device__ __forceinline__ void operator()(int, int, float v) { sum = __fadd_rn(sum, v); }
};

struct GateSink {
  float* vs;
  const float* g;
  int stride;
  __device__ __forceinline__ void operator()(int pix, int c, float v) {
    vs[(size_t)pix * stride + c] = __fmul_rn(v, g[c]);
  }
};

// ys[pix][o] += sum_k vs[pix][k] wp[k][o] over the chunk: 4 pixels x 8 outputs
// per thread tile.
__device__ __forceinline__ void project_chunk(const float* vs, const float* wp, float* ys,
                                              const Dims& d, const SharedLayout& L, int npix) {
  const int oq = d.C / 8;
  const int tiles = (npix + 3) / 4 * oq;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int p0 = t / oq * 4;
    const int o0 = t % oq * 8;
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (p0 + j < npix) {
        const float4 lo = *reinterpret_cast<const float4*>(ys + (size_t)(p0 + j) * d.C + o0);
        const float4 hi = *reinterpret_cast<const float4*>(ys + (size_t)(p0 + j) * d.C + o0 + 4);
        acc[j][0] = lo.x; acc[j][1] = lo.y; acc[j][2] = lo.z; acc[j][3] = lo.w;
        acc[j][4] = hi.x; acc[j][5] = hi.y; acc[j][6] = hi.z; acc[j][7] = hi.w;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[j][q] = 0.f;
      }
    }
#pragma unroll 4
    for (int k = 0; k < d.chunk; ++k) {
      float a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = vs[(size_t)(p0 + j) * L.pos_stride + k];
      const float4 lo = *reinterpret_cast<const float4*>(wp + k * d.C + o0);
      const float4 hi = *reinterpret_cast<const float4*>(wp + k * d.C + o0 + 4);
      const float b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[j][q] = __fmaf_rn(a[j], b[q], acc[j][q]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (p0 + j < npix) {
        float* dst = ys + (size_t)(p0 + j) * d.C + o0;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
      }
    }
  }
}

// Pass (a) (kProject false) or (c) (true) over one row strip of one image.
template <typename T, int K, bool kProject>
__global__ void __launch_bounds__(kThreads, 2)
    mbconv_pass(const T* __restrict__ x, T* __restrict__ y, float* __restrict__ partial,
                const float* __restrict__ gate, Params p, Dims d) {
  constexpr int pad = (K - 1) / 2;
  extern __shared__ __align__(16) float smem[];
  const SharedLayout L(d.W, d.C, K, d.rows, d.chunk, sizeof(T), kProject);
  T* xs = reinterpret_cast<T*>(smem + L.x);
  float* es = smem + L.e;
  float* we = smem + L.we;
  float* s1 = smem + L.vec;
  float* b1 = s1 + d.chunk;
  float* s2 = b1 + d.chunk;
  float* b2 = s2 + d.chunk;
  float* wd = b2 + d.chunk;
  float* red = smem + L.red;
  float* vs = smem + L.v;
  float* wp = smem + L.wp;
  float* g = smem + L.g;
  float* ys = smem + L.y;

  const int tid = threadIdx.x;
  const int strip = blockIdx.x;
  const int n = blockIdx.y;
  const int r0 = strip * d.rows;
  const int rows = min(d.rows, d.H - r0);  // this strip's rows
  const int lo = max(0, r0 - pad);         // image rows of x held: [lo, hi)
  const int hi = min(d.H, r0 + rows + pad);
  const int xpix = (hi - lo) * d.W;
  const int npix = rows * d.W;

  // zeros: the expansion's border and the halo rows outside the image stay
  // zero (the padding comes after the activation); the tails the tiles read
  for (size_t i = tid; i < L.e_size; i += kThreads) es[i] = 0.f;
  if (kProject) {
    for (size_t i = tid; i < L.v_size; i += kThreads) vs[i] = 0.f;
    for (size_t i = tid; i < L.y_size; i += kThreads) ys[i] = 0.f;
  }
  const T* xb = x + ((size_t)n * d.H + lo) * d.W * d.C;
  for (int i = tid; i < xpix * d.C; i += kThreads) {
    const int pix = i / d.C;
    xs[(size_t)(i - pix * d.C) * L.lda + pix] = xb[i];
  }
  for (int i = tid; i < (L.lda - xpix) * d.C; i += kThreads) {
    const int c = i / (L.lda - xpix);
    xs[(size_t)c * L.lda + xpix + i - c * (L.lda - xpix)] = from_f<T>(0.f);
  }

  for (int c0 = 0; c0 < d.mid; c0 += d.chunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < d.C * d.chunk; i += kThreads) {
      const int ci = i / d.chunk;
      we[i] = p.w_exp[(size_t)ci * d.mid + c0 + i - ci * d.chunk];
    }
    for (int i = tid; i < d.chunk; i += kThreads) {
      s1[i] = p.s1[c0 + i];
      b1[i] = p.b1[c0 + i];
      s2[i] = p.s2[c0 + i];
      b2[i] = p.b2[c0 + i];
      if (kProject) g[i] = gate[(size_t)n * d.mid + c0 + i];
    }
    for (int i = tid; i < K * K * d.chunk; i += kThreads) {
      const int t = i / d.chunk;
      wd[i] = p.w_dw[(size_t)t * d.mid + c0 + i - t * d.chunk];
    }
    if (kProject)
      for (int i = tid; i < d.chunk * d.C; i += kThreads) wp[i] = p.w_proj[(size_t)c0 * d.C + i];
    __syncthreads();
    expand_chunk<T>(xs, we, s1, b1, es, d, L, xpix, lo - (r0 - pad), pad);
    __syncthreads();
    if (kProject) {
      GateSink sink{vs, g, L.pos_stride};
      depthwise_chunk<K>(es, wd, s2, b2, d, L, rows, sink);
      __syncthreads();
      project_chunk(vs, wp, ys, d, L, npix);
    } else {
      SumSink sink;
      depthwise_chunk<K>(es, wd, s2, b2, d, L, rows, sink);
      red[tid] = sink.sum;
      __syncthreads();
      if (tid < d.chunk) {
        float s = 0.f;
        for (int j = tid; j < kThreads; j += d.chunk) s = __fadd_rn(s, red[j]);
        partial[((size_t)n * d.strips + strip) * d.mid + c0 + tid] = s;
      }
    }
  }
  if (kProject) {
    __syncthreads();
    const size_t base = ((size_t)n * d.H + r0) * d.W * d.C;
    for (int i = tid; i < npix * d.C; i += kThreads) {
      const int o = i % d.C;
      const float v = __fmaf_rn(ys[i], p.s3[o], p.b3[o]);
      y[base + i] = from_f<T>(__fadd_rn(v, to_f<T>(x[base + i])));
    }
  }
}

// Pass (b): one block per image; the strips' sums in order, the SE layers.
__global__ void __launch_bounds__(kThreads)
    mbconv_gate(const float* __restrict__ partial, float* __restrict__ gate, Params p, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* se = sm;
  float* r = sm + d.mid;
  const int n = blockIdx.x;
  const float count = (float)d.H * (float)d.W;
  for (int c = threadIdx.x; c < d.mid; c += kThreads) {
    float s = 0.f;
    for (int st = 0; st < d.strips; ++st)
      s = __fadd_rn(s, partial[((size_t)n * d.strips + st) * d.mid + c]);
    se[c] = __fdiv_rn(s, count);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d.rd; j += kThreads) {
    float a = 0.f;
    for (int c = 0; c < d.mid; ++c) a = __fmaf_rn(se[c], p.w_se1[(size_t)c * d.rd + j], a);
    r[j] = swish(__fadd_rn(a, p.b_se1[j]));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d.mid; c += kThreads) {
    float a = 0.f;
    for (int j = 0; j < d.rd; ++j) a = __fmaf_rn(r[j], p.w_se2[(size_t)j * d.mid + c], a);
    gate[(size_t)n * d.mid + c] = sigmoid(__fadd_rn(a, p.b_se2[c]));
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, void* y, float* partial, float* gate, const Params& p,
                   const Dims& d, cudaStream_t stream) {
  const size_t stats_bytes = 4 * SharedLayout(d.W, d.C, K, d.rows, d.chunk, sizeof(T), false).total;
  const size_t proj_bytes = 4 * SharedLayout(d.W, d.C, K, d.rows, d.chunk, sizeof(T), true).total;
  const size_t gate_bytes = 4 * ((size_t)d.mid + d.rd);
  if (proj_bytes > kSharedLimit || gate_bytes > 48 * 1024) return cudaErrorInvalidValue;
  auto stats = mbconv_pass<T, K, false>;
  auto project = mbconv_pass<T, K, true>;
  cudaError_t err =
      cudaFuncSetAttribute(stats, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)stats_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(project, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)proj_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.strips, d.N);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  stats<<<grid, kThreads, stats_bytes, stream>>>(xt, yt, partial, gate, p, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mbconv_gate<<<d.N, kThreads, gate_bytes, stream>>>(partial, gate, p, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  project<<<grid, kThreads, proj_bytes, stream>>>(xt, yt, partial, gate, p, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(int K, const void* x, void* y, float* partial, float* gate, const Params& p,
                     const Dims& d, cudaStream_t stream) {
  switch (K) {
    case 1: return launch<T, 1>(x, y, partial, gate, p, d, stream);
    case 3: return launch<T, 3>(x, y, partial, gate, p, d, stream);
    case 5: return launch<T, 5>(x, y, partial, gate, p, d, stream);
    case 7: return launch<T, 7>(x, y, partial, gate, p, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. partial (N, strips, mid) and gate (N, mid)
// are f32 scratch, strips = ceil(H / rows). Returns the launches' CUDA error
// (0 on success).
extern "C" int mbconv_fused_fwd(const void* x, void* y, void* partial, void* gate,
                                const void* w_exp, const void* s1, const void* b1,
                                const void* w_dw, const void* s2, const void* b2,
                                const void* w_se1, const void* b_se1, const void* w_se2,
                                const void* b_se2, const void* w_proj, const void* s3,
                                const void* b3, int dtype, int N, int H, int W, int C, int mid,
                                int rd, int K, int rows, int chunk, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 8 || C % 8 != 0 || mid < 8 || mid % 8 != 0 ||
      rd < 1 || rows < 1 || rows > H || (chunk != 8 && chunk != 16 && chunk != 32) ||
      mid % chunk != 0 || (long long)H * W * C > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{static_cast<const float*>(w_exp), static_cast<const float*>(s1),
                 static_cast<const float*>(b1),    static_cast<const float*>(w_dw),
                 static_cast<const float*>(s2),    static_cast<const float*>(b2),
                 static_cast<const float*>(w_se1), static_cast<const float*>(b_se1),
                 static_cast<const float*>(w_se2), static_cast<const float*>(b_se2),
                 static_cast<const float*>(w_proj), static_cast<const float*>(s3),
                 static_cast<const float*>(b3)};
  const Dims d{N, H, W, C, mid, rd, rows, chunk, (H + rows - 1) / rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* g = static_cast<float*>(gate);
  if (dtype == 0) return (int)launch_k<float>(K, x, y, part, g, p, d, st);
  if (dtype == 1) return (int)launch_k<__nv_bfloat16>(K, x, y, part, g, p, d, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 route (mbconv_fused_cluster.cuh): x, y (N, H, W, C) bf16; the
// parameters f32 as above (w_exp is rounded to bf16 in the kernel). strips
// blocks of `rows` rows hold an image (a cluster), chunk (16, 32 or 64)
// expanded channels at a time, kc (16 to 64) rows of w_proj a stage, warps_m
// x (16 / warps_m) warps over y's tiles; all from
// ops/mbconv_fused.py::plan_cluster. Returns the launch's CUDA error (0 on
// success).
extern "C" int mbconv_fused_cluster_fwd(const void* x, void* y, const void* w_exp,
                                        const void* s1, const void* b1, const void* w_dw,
                                        const void* s2, const void* b2, const void* w_se1,
                                        const void* b_se1, const void* w_se2, const void* b_se2,
                                        const void* w_proj, const void* s3, const void* b3, int N,
                                        int H, int W, int C, int mid, int rd, int K, int strips,
                                        int rows, int chunk, int kc, int warps_m,
                                        void* stream) {
  namespace mc = mbconv_cluster;
  using mc::bf16;
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 8 || C % 8 != 0 || mid < 16 ||
      mid % 16 != 0 || rd < 1 || rd > mid || rd > mc::kThreads || strips < 1 ||
      strips > mc::kMaxStrips || rows < 1 || rows * strips < H || rows * (strips - 1) >= H ||
      (chunk != 16 && chunk != 32 && chunk != 64) || mid % chunk != 0 || kc < 16 || kc > 64 ||
      kc % 16 != 0 ||
      (warps_m != 1 && warps_m != 2 && warps_m != 4 && warps_m != 8 && warps_m != 16) ||
      !mc::fits_warps(rows, W, C, warps_m) || C * chunk > mc::kQuads * 4 * mc::kThreads ||
      (long long)H * W * C > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const mc::Params p{static_cast<const float*>(w_exp),    static_cast<const float*>(s1),
                     static_cast<const float*>(b1),      static_cast<const float*>(w_dw),
                     static_cast<const float*>(s2),      static_cast<const float*>(b2),
                     static_cast<const float*>(w_se1), static_cast<const float*>(b_se1),
                     static_cast<const float*>(w_se2),   static_cast<const float*>(b_se2),
                     static_cast<const float*>(w_proj),  static_cast<const float*>(s3),
                     static_cast<const float*>(b3)};
  const mc::Dims d{N, H, W, C, mid, rd, rows, chunk, kc, strips, warps_m};
  return (int)mc::launch_k(K, static_cast<const bf16*>(x), static_cast<bf16*>(y), p, d,
                           static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a block of the bf16 route (Layout in
// mbconv_fused_cluster.cuh), which ops/mbconv_fused.py::cluster_shared_bytes
// must reproduce.
extern "C" int mbconv_fused_cluster_bytes(int H, int W, int C, int mid, int K, int rows,
                                          int chunk, int kc) {
  return (int)mbconv_cluster::Layout(H, W, C, mid, K, rows, chunk, kc).total;
}
