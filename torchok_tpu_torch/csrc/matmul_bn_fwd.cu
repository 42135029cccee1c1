// 1x1 conv as a GEMM with the previous BatchNorm folded into its input and
// the next BatchNorm's statistics folded into its output, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel torchok_tpu/ops/conv_bn.py::_kernel (reached
// through _matmul_bn_fwd_impl and the public matmul_bn). Same contract:
//   x (M, K) bf16|f32, w (K, N) same type, scale/bias (K,) f32
//   a  = x                      (kAffine: x * scale + bias, in f32)
//   a  = max(a, 0)              (kRelu)
//   y  = round_T( round_T(a) @ w )   with f32 accumulation       -> (M, N), T
//   s1 = sum over the M rows of y (the rounded y, as f32)         -> (N,) f32
//   s2 = sum over the M rows of y*y                               -> (N,) f32
// Rows past M are zeros before the product and never reach the statistics,
// even though the affine maps 0 to relu(bias) != 0.
//
// On the TPU s1 and s2 are carried in VMEM across a sequential grid. Here
// blocks run in no order, so each block keeps its column sums in registers
// over the row tiles it walks, writes one row of partial sums, and a second
// small kernel adds the rows in fixed order: no atomics, so two launches give
// the same bits.
//
// Two routes, chosen by the element type (ops/conv_bn.py::forward_route):
// bf16 runs matmul_bn_wgmma.cuh (wgmma with the prologue on A in registers,
// TMA stages, a persistent warp-specialised grid); f32, which exists for
// correctness tests (TF32 would change its numbers), runs the f32-FMA tile
// loop of gemm_tile.cuh with the loader and epilogue below.
//
// What bounds it: at ResNet-50's 1x1 shapes (M 12,544 to 802,816 at batch
// 256, K and N 64 to 2048) the kernel must move x and y once for at most
// 2 x 1024 products a row, below the tensor-core ridge: device memory bounds
// it, and the fusion's whole point is that the normalised input and the
// statistics pass never touch that memory.
#include "gemm_tile.cuh"
#include "matmul_bn_wgmma.cuh"

namespace {

using namespace tilegemm;

template <typename T, bool kRelu, bool kAffine>
struct AffineLoader {
  struct Row {
    const T* base;  // null past M
  };
  const T* x;
  const float* scale;
  const float* bias;
  int M, K;

  __device__ __forceinline__ Row row(int m) const {
    return Row{m < M ? x + (size_t)m * K : nullptr};
  }
  __device__ __forceinline__ Pack<T> fetch(const Row& r, int k) const {
    if (r.base == nullptr || k >= K) return zero_pack<T>();
    return *reinterpret_cast<const Pack<T>*>(r.base + k);
  }
  __device__ __forceinline__ Pack<T> finish(Pack<T> p, const Row& r, int k) const {
    if (r.base == nullptr || k >= K) return p;  // zeros stay zeros
    if (kRelu || kAffine) {
#pragma unroll
      for (int i = 0; i < Pack<T>::kN; ++i) {
        float a = to_f(p.v[i]);
        if (kAffine) a = a * scale[k + i] + bias[k + i];
        if (kRelu) a = fmaxf(a, 0.f);
        p.v[i] = from_f<T>(a);
      }
    }
    return p;
  }
};

// Writes y and keeps this block's column sums of the rounded y.
template <typename T>
struct StatsEpilogue {
  T* y;
  int M, N;
  float s1, s2;  // column tid % BN, rows tid / BN + 4 r

  __device__ __forceinline__ void tile(const float* cs, int m0, int n0) {
    write_tile<T>(cs, y, m0, n0, M, N);
    const int col = threadIdx.x % BN;
    for (int r = threadIdx.x / BN; r < BM; r += kThreads / BN) {
      if (m0 + r < M) {
        const float v = round_to<T>(cs[r * Layout<T>::kLdc + col]);
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
    }
  }
};

template <typename T, bool kRelu, bool kAffine>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
matmul_bn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     T* __restrict__ y, float* __restrict__ partial, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  AffineLoader<T, kRelu, kAffine> loader{x, scale, bias, M, K};
  StatsEpilogue<T> epilogue{y, M, N, 0.f, 0.f};
  run_tiles<T>(loader, w, M, K, N, epilogue, smem);

  // the four row groups of a column, added in fixed order; the staging tile
  // is free again (run_tiles ends on a __syncthreads)
  constexpr int kGroups = kThreads / BN;
  float* red = reinterpret_cast<float*>(smem);  // [2][kGroups][BN]
  const int col = threadIdx.x % BN;
  const int grp = threadIdx.x / BN;
  red[grp * BN + col] = epilogue.s1;
  red[(kGroups + grp) * BN + col] = epilogue.s2;
  __syncthreads();
  const int n = blockIdx.y * BN + col;
  if (grp == 0 && n < N) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      t1 += red[g * BN + col];
      t2 += red[(kGroups + g) * BN + col];
    }
    // partial: [2][gridDim.x][N]
    partial[(size_t)blockIdx.x * N + n] = t1;
    partial[((size_t)gridDim.x + blockIdx.x) * N + n] = t2;
  }
}

// s1[n], s2[n] = the partial rows added from first to last
__global__ void matmul_bn_reduce_kernel(const float* __restrict__ partial, float* __restrict__ s1,
                                        float* __restrict__ s2, int rows, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float t1 = 0.f, t2 = 0.f;
  for (int r = 0; r < rows; ++r) {
    t1 += partial[(size_t)r * N + n];
    t2 += partial[((size_t)rows + r) * N + n];
  }
  s1[n] = t1;
  s2[n] = t2;
}

template <typename T, bool kRelu, bool kAffine>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* bias, void* y,
                   void* partial, int M, int K, int N, int m_blocks, cudaStream_t stream) {
  auto kernel = matmul_bn_fwd_kernel<T, kRelu, kAffine>;
  constexpr size_t bytes = Layout<T>::kSharedBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(m_blocks, (N + BN - 1) / BN);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), static_cast<float*>(partial), M, K, N);
  return cudaGetLastError();
}

cudaError_t launch_fma(bool relu, bool affine, const void* x, const void* w, const void* scale,
                       const void* bias, void* y, void* partial, int M, int K, int N,
                       int m_blocks, cudaStream_t st) {
  if (relu && affine) return launch<float, true, true>(x, w, scale, bias, y, partial, M, K, N, m_blocks, st);
  if (relu) return launch<float, true, false>(x, w, scale, bias, y, partial, M, K, N, m_blocks, st);
  if (affine) return launch<float, false, true>(x, w, scale, bias, y, partial, M, K, N, m_blocks, st);
  return launch<float, false, false>(x, w, scale, bias, y, partial, M, K, N, m_blocks, st);
}

}  // namespace

// dtype: 0 = float32 (the FMA route: tile_n must be 64, the grid is groups x
// column tiles), 1 = bfloat16 (the wgmma route: tile_n 64, 128 or 256, the
// grid column tiles x groups; x, w, scale and bias 16-byte aligned). groups
// (1 .. row tiles of 128) is how many blocks share the row tiles of one
// column tile; partial is scratch of 2 * groups * N floats. Returns the first
// CUDA error of the launches (0 on success).
extern "C" int matmul_bn_fwd(const void* x, const void* w, const void* scale, const void* bias,
                             void* y, void* s1, void* s2, void* partial, int dtype, int M, int K,
                             int N, int relu_in, int with_affine, int tile_n, int groups,
                             void* stream) {
  const int m_tiles = (M + tilegemm::BM - 1) / tilegemm::BM;
  if (M < 1 || K < 8 || N < 8 || K % 8 != 0 || N % 8 != 0 || groups < 1 || groups > m_tiles ||
      tile_n < 64) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles_n = (N + tile_n - 1) / tile_n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    if (tile_n != tilegemm::BN || tiles_n > 65535) return (int)cudaErrorInvalidValue;
    err = launch_fma(relu_in != 0, with_affine != 0, x, w, scale, bias, y, partial, M, K, N,
                     groups, st);
  } else if (dtype == 1) {
    if (tiles_n * groups > 2147483647LL) return (int)cudaErrorInvalidValue;
    err = bnwg::launch(tile_n, relu_in != 0, with_affine != 0,
                       static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                       static_cast<const float*>(scale), static_cast<const float*>(bias),
                       static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial), M, K, N,
                       groups, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  matmul_bn_reduce_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(s1), static_cast<float*>(s2),
      groups, N);
  return (int)cudaGetLastError();
}
