// 3x3, stride 1, zero padding 1 convolution as an implicit GEMM, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tools/probe_r50_conv_gemm.py::_kernel
// (reached through pallas_conv). Same contract:
//   x (N, H, W, Cin) NHWC bf16|f32, w (3, 3, Cin, Cout) HWIO same type
//   y[n, i, j, :] = round_T( sum over the nine taps (dy, dx) and Cin of
//                            x[n, i+dy-1, j+dx-1, :] @ w[dy, dx] )   f32 accumulation
// with taps outside the image contributing zeros (not clamped reads).
//
// The TPU kernel builds the im2col matrix of a few images in VMEM and runs
// one product of depth 9*Cin. Here the matrix is never built: the GEMM's rows
// run over all N*H*W output pixels flattened (so 7x7 images fill a 128-row
// tile as well as 56x56 ones do), its depth over (tap, channel), and each
// 16-byte piece of a row is gathered straight from the pixel it belongs to,
// or is zero at the border. w is already the (9*Cin, Cout) matrix the
// product needs.
//
// Two main loops. bf16 (the probe's type) runs conv3x3_wgmma.cuh: wgmma on
// a warp-specialised, persistent kernel fed by a ring of cp.async and TMA
// stages (the Hopper redesign; before it the mma.sync tile loop of
// gemm_tile.cuh took 3.0916 ms over the four ResNet-50 shapes at batch 256 on
// an NVIDIA H100 80GB HBM3, 700.00 W, PERF.md). f32, which exists for
// correctness tests (TF32 would change its numbers), keeps the f32-FMA tile
// loop of gemm_tile.cuh with the gathering loader below.
//
// What bounds it: 59 GFLOP at each of ResNet-50's four 3x3 shapes at batch
// 256 against at most 0.2 GB moved, so the product bounds it (at 56x56x64 the
// two bounds meet); every x element is gathered nine times, from L1/L2.
#include "conv3x3_wgmma.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace tilegemm;

template <typename T>
struct GatherLoader {
  struct Row {
    const T* image;  // the row's image, null past M
    int y, x;        // its output pixel
  };
  const T* x;
  int M, H, W, Cin;

  __device__ __forceinline__ Row row(int m) const {
    if (m >= M) return Row{nullptr, 0, 0};
    const int n = m / (H * W);
    const int rem = m - n * H * W;
    const int yy = rem / W;
    return Row{x + (size_t)n * H * W * Cin, yy, rem - yy * W};
  }
  __device__ __forceinline__ Pack<T> fetch(const Row& r, int k) const {
    if (r.image == nullptr || k >= 9 * Cin) return zero_pack<T>();
    const int tap = k / Cin;
    const int c = k - tap * Cin;
    const int dy = tap / 3;
    const int yy = r.y + dy - 1;
    const int xx = r.x + (tap - 3 * dy) - 1;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) return zero_pack<T>();
    return *reinterpret_cast<const Pack<T>*>(r.image + ((size_t)yy * W + xx) * Cin + c);
  }
  __device__ __forceinline__ Pack<T> finish(Pack<T> p, const Row&, int) const { return p; }
};

template <typename T>
struct WriteEpilogue {
  T* y;
  int M, N;
  __device__ __forceinline__ void tile(const float* cs, int m0, int n0) {
    write_tile<T>(cs, y, m0, n0, M, N);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv3x3_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int M,
                    int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  GatherLoader<T> loader{x, M, H, W, Cin};
  WriteEpilogue<T> epilogue{y, M, Cout};
  run_tiles<T>(loader, w, M, 9 * Cin, Cout, epilogue, smem);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int M, int H, int W, int Cin, int Cout,
                   cudaStream_t stream) {
  auto kernel = conv3x3_gemm_kernel<T>;
  constexpr size_t bytes = Layout<T>::kSharedBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                            static_cast<T*>(y), M, H, W, Cin, Cout);
  return cudaGetLastError();
}

// The SM count of the current device, for the persistent grid (asked once per device).
int multiprocessors() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms < 1) {
      return 132;
    }
    cached[dev] = sms;
  }
  return cached[dev];
}

cudaError_t launch_wgmma(const void* x, const void* w, void* y, int M, int H, int W, int Cin,
                         int Cout, cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (Cout <= 64) {
    return convwg::launch<64, 2, 2>(xb, wb, yb, M, H, W, Cin, Cout, multiprocessors(), stream);
  }
  return convwg::launch<128, 3, 1>(xb, wb, yb, M, H, W, Cin, Cout, multiprocessors(), stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's CUDA error (0 on success).
extern "C" int conv3x3_gemm(const void* x, const void* w, void* y, int dtype, int N, int H, int W,
                            int Cin, int Cout, void* stream) {
  const long long rows = (long long)N * H * W;
  if (N < 1 || H < 1 || W < 1 || Cin < 8 || Cout < 8 || Cin % 8 != 0 || Cout % 8 != 0 ||
      rows > 2147483647LL - tilegemm::BM || (Cout + tilegemm::BN - 1) / tilegemm::BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, y, (int)rows, H, W, Cin, Cout, st);
  if (dtype == 1) return (int)launch_wgmma(x, w, y, (int)rows, H, W, Cin, Cout, st);
  return (int)cudaErrorInvalidValue;
}
