// The f32 tile-product main loop for Hopper (sm_90a), shared by the f32
// routes of matmul_bn_fwd.cu (1x1 conv as a GEMM with a prologue on A and a
// column-sum epilogue) and conv3x3_gemm.cu (3x3 conv as an implicit GEMM with
// a gathering A loader). Their bf16 routes run on wgmma instead
// (matmul_bn_wgmma.cuh, conv3x3_wgmma.cuh); f32 exists for correctness tests
// (TF32 would change its numbers).
//
//   C (M, N) = A (M, K) @ W (K, N),  f32 accumulation,
// where A is never a tensor in memory: an ALoader produces its 16-byte pieces
// (4 f32 values along K) from whatever the caller has, and W is a row-major
// (K, N) matrix. K and N must be multiples of 8 so that every piece is whole;
// M is free (rows past M are zeros and are never written).
//
// A block of 256 threads owns a 128 x 64 tile of C and walks K in slabs of
// BK. The next slab travels from device memory to registers while the
// current one is multiplied from shared memory, then goes into the other half
// of a double buffer: one __syncthreads per slab. The operands meet in f32
// FMAs (TF32 is not f32), each thread an 8 x 4 register tile; the finished
// tile is parked in shared memory and handed to the caller's epilogue.
//
// A block loops over the row tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// of its column tile blockIdx.y: what a sequential TPU grid would carry from
// step to step (matmul_bn's column sums) lives in the epilogue object's
// registers across that loop.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tilegemm {

constexpr int kThreads = 256;
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;  // slab depth; 64 measured no faster
// blocks per SM the register budget must allow: left to itself the compiler
// has taken up to 193 registers and halved the occupancy
constexpr int kMinBlocks = 2;
constexpr int kCPad = 4;  // f32 staging tile row padding

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 16 bytes of T, moved as one
template <typename T> struct alignas(16) Pack {
  static constexpr int kN = 16 / (int)sizeof(T);
  T v[kN];
};

template <typename T> __device__ __forceinline__ Pack<T> zero_pack() {
  Pack<T> p;
#pragma unroll
  for (int i = 0; i < Pack<T>::kN; ++i) p.v[i] = from_f<T>(0.f);
  return p;
}

template <typename T> struct Layout {
  static constexpr int kVec = Pack<T>::kN;
  static constexpr int kPad = 16 / (int)sizeof(T);   // one 16-byte piece per row
  static constexpr int kLda = BK + kPad;             // shared row strides, in elements
  static constexpr int kLdb = BN + kPad;
  static constexpr int kLdc = BN + kCPad;
  static constexpr int kAVecs = BM * BK / kVec / kThreads;  // pieces per thread per slab
  static constexpr int kBVecs = BK * BN / kVec / kThreads;
  static constexpr int kAPerRow = BK / kVec;
  static constexpr int kBPerRow = BN / kVec;
  static constexpr size_t kABytes = (size_t)BM * kLda * sizeof(T);
  static constexpr size_t kBBytes = (size_t)BK * kLdb * sizeof(T);
  static constexpr size_t kCBytes = (size_t)BM * kLdc * sizeof(float);
  static constexpr size_t kSharedBytes = 2 * kABytes + 2 * kBBytes + kCBytes;
};

// The product of one slab, accumulated over the slabs of a tile.
template <typename T> struct Mma;

template <> struct Mma<float> {
  using L = Layout<float>;
  static constexpr int kR = BM / 16;  // 8 rows ti + 16 r
  static constexpr int kC = BN / 16;  // 4 columns tj + 16 c
  float acc[kR][kC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
  }

  __device__ __forceinline__ void step(const float* as, const float* bs) {
    const int ti = threadIdx.x / 16;
    const int tj = threadIdx.x % 16;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[kR], b[kC];
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] = as[(ti + 16 * r) * L::kLda + k];
#pragma unroll
      for (int c = 0; c < kC; ++c) b[c] = bs[k * L::kLdb + tj + 16 * c];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

  __device__ __forceinline__ void store(float* cs) {
    const int ti = threadIdx.x / 16;
    const int tj = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) cs[(ti + 16 * r) * L::kLdc + tj + 16 * c] = acc[r][c];
  }
};

// Writes the staged f32 tile to y (M, N) row-major, rounded once to T, in
// 16-byte pieces; rows past M and columns past N are left alone.
template <typename T>
__device__ __forceinline__ void write_tile(const float* cs, T* __restrict__ y, int m0, int n0,
                                           int M, int N) {
  using L = Layout<T>;
  for (int v = threadIdx.x; v < BM * L::kBPerRow; v += kThreads) {
    const int r = v / L::kBPerRow;
    const int c = (v - r * L::kBPerRow) * L::kVec;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) {
      Pack<T> p;
#pragma unroll
      for (int i = 0; i < L::kVec; ++i) p.v[i] = from_f<T>(cs[r * L::kLdc + c + i]);
      *reinterpret_cast<Pack<T>*>(y + (size_t)m * N + n) = p;
    }
  }
}

// The loop over this block's tiles. ALoader supplies
//   struct Row;                         what it needs to know about a row of A
//   Row row(int m) const;               once per tile and piece
//   Pack<T> fetch(const Row&, int k);   the raw 16 bytes at column k (zeros outside)
//   Pack<T> finish(Pack<T>, const Row&, int k);  what enters the product
// and Epilogue supplies  void tile(const float* cs, int m0, int n0)  called by
// all threads once the tile is staged (a __syncthreads precedes and follows).
template <typename T, typename ALoader, typename Epilogue>
__device__ __forceinline__ void run_tiles(const ALoader& loader, const T* __restrict__ w, int M,
                                          int K, int N, Epilogue& epilogue,
                                          unsigned char* smem) {
  using L = Layout<T>;
  T* as = reinterpret_cast<T*>(smem);                                   // [2][BM][kLda]
  T* bs = reinterpret_cast<T*>(smem + 2 * L::kABytes);                  // [2][BK][kLdb]
  float* cs = reinterpret_cast<float*>(smem + 2 * L::kABytes + 2 * L::kBBytes);  // [BM][kLdc]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int m_tiles = (M + BM - 1) / BM;
  const int slabs = (K + BK - 1) / BK;

  // this thread's pieces of a slab: fixed rows of A, fixed (k, n) of W
  int a_r[L::kAVecs], a_k[L::kAVecs], b_k[L::kBVecs], b_n[L::kBVecs];
#pragma unroll
  for (int i = 0; i < L::kAVecs; ++i) {
    const int v = tid + i * kThreads;
    a_r[i] = v / L::kAPerRow;
    a_k[i] = (v - a_r[i] * L::kAPerRow) * L::kVec;
  }
#pragma unroll
  for (int i = 0; i < L::kBVecs; ++i) {
    const int v = tid + i * kThreads;
    b_k[i] = v / L::kBPerRow;
    b_n[i] = (v - b_k[i] * L::kBPerRow) * L::kVec;
  }

  for (int tile = blockIdx.x; tile < m_tiles; tile += gridDim.x) {
    const int m0 = tile * BM;
    typename ALoader::Row rows[L::kAVecs];
#pragma unroll
    for (int i = 0; i < L::kAVecs; ++i) rows[i] = loader.row(m0 + a_r[i]);

    Pack<T> ra[L::kAVecs], rb[L::kBVecs];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < L::kAVecs; ++i) ra[i] = loader.fetch(rows[i], k0 + a_k[i]);
#pragma unroll
      for (int i = 0; i < L::kBVecs; ++i) {
        const int k = k0 + b_k[i];
        const int n = n0 + b_n[i];
        rb[i] = (k < K && n < N) ? *reinterpret_cast<const Pack<T>*>(w + (size_t)k * N + n)
                                 : zero_pack<T>();
      }
    };
    auto park = [&](int buf, int k0) {
      T* a = as + buf * BM * L::kLda;
      T* b = bs + buf * BK * L::kLdb;
#pragma unroll
      for (int i = 0; i < L::kAVecs; ++i)
        *reinterpret_cast<Pack<T>*>(a + a_r[i] * L::kLda + a_k[i]) =
            loader.finish(ra[i], rows[i], k0 + a_k[i]);
#pragma unroll
      for (int i = 0; i < L::kBVecs; ++i)
        *reinterpret_cast<Pack<T>*>(b + b_k[i] * L::kLdb + b_n[i]) = rb[i];
    };

    Mma<T> mma;
    mma.init();
    fetch(0);
    park(0, 0);
    __syncthreads();
    int buf = 0;
    for (int s = 0; s < slabs; ++s) {
      const bool more = s + 1 < slabs;
      if (more) fetch((s + 1) * BK);
      mma.step(as + buf * BM * L::kLda, bs + buf * BK * L::kLdb);
      if (more) park(buf ^ 1, (s + 1) * BK);
      __syncthreads();
      buf ^= 1;
    }
    mma.store(cs);
    __syncthreads();
    epilogue.tile(cs, m0, n0);
    __syncthreads();
  }
}

}  // namespace tilegemm
