// Shared pieces of the window attention kernels for Hopper (sm_90a):
// window_attention_{fwd,bwd}.cu (plain scaled dot-product attention over the
// window's own tokens; DaViT spatial blocks, GCViT local blocks),
// window_attention_global_{fwd,bwd}.cu (GCViT global blocks: every window of
// an image attends with that image's shared queries) and
// swin_attention_{fwd,bwd}.cu (SwinV2 cosine attention with a per-head logit
// scale, the relative position bias and the shift mask: kCosine).
//
// All work on the unpartitioned spatial layout (B, Hp, Wp, parts*C) and
// compute each token's pixel address themselves, so no window partition or
// reverse copy is ever made. Head dim is 32; the window side ws is a run-time
// value. Up to L = ws*ws = 256 (ws 16) a block holds all L keys of a window,
// and L picks one of three instantiations by the key columns each thread
// owns (KC: L <= 64, 208, 256). Above 256 (SwinV2's ws 24, L = 576) the
// key-tiled path of window_attention_tiled.cuh walks the keys in tiles of
// kTileK instead.
//
// A block has 256 threads laid out 16 x 16 over a tile of 64 query rows by
// 16*KC key columns: thread (ti, tj) owns rows ti + 16 r (r < 4) and columns
// tj + 16 c (c < KC). Rows and columns beyond L are padding: padded keys get
// a logit of -inf (weight exactly 0), padded query rows are computed on zeros
// and never written. q, k, v, dout and the rounded a and dls sit in shared
// memory in the input dtype (they are values of that dtype, so nothing is
// lost), with every row padded by one 32-bit word against bank conflicts.
// In cosine mode q and k are normalised in place, in f32, and rounded back to
// the input dtype: qn and kn are values of that dtype as well.
// A window's pixel offsets are worked out once into a table in shared memory,
// and rows of 32 head channels move from device memory 16 bytes per thread.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace wattn {

constexpr int kD = 32;                // head dim
constexpr int kThreads = 256;         // 16 x 16 thread grid over each tile
constexpr int kRows = 4;              // query rows per thread
constexpr int kTileQ = 16 * kRows;    // query rows per pass
constexpr int kMaxL = 256;            // ws <= 16: all keys of a window in one block
constexpr int kMaxLTiled = 576;       // ws <= 24 on the key-tiled path
constexpr int kTileK = 64;            // keys per tile on the key-tiled path
constexpr float kNormEps = 1e-12f;    // x * rsqrt(sum x^2 + eps), as the Pallas kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// one 32-bit word of padding per shared row, in elements of T
template <typename T> constexpr int kPad = 4 / (int)sizeof(T);

struct Geometry {
  int B, Hp, Wp, C, nheads, ws, L, ngx, nW;
};

__host__ inline bool make_geometry(Geometry* g, int B, int Hp, int Wp, int C, int nheads, int ws,
                                   int max_l = kMaxL) {
  if (ws < 1 || ws * ws > max_l || C != nheads * kD || B < 1 || nheads < 1 || Hp < ws ||
      Wp < ws || Hp % ws != 0 || Wp % ws != 0) {
    return false;
  }
  g->B = B; g->Hp = Hp; g->Wp = Wp; g->C = C; g->nheads = nheads; g->ws = ws;
  g->L = ws * ws; g->ngx = Wp / ws; g->nW = (Hp / ws) * (Wp / ws);
  return true;
}

// Fills pix[i], i < L, with the offset of token i of window win (row-major
// wy * ngx + wx) inside one image's (Hp, Wp) map: pixel (wy*ws + i/ws,
// wx*ws + i%ws). The caller synchronises before reading the table.
__device__ __forceinline__ void fill_pixel_table(const Geometry& g, int win, int* pix) {
  const int wy = win / g.ngx;
  const int wx = win - wy * g.ngx;
  for (int i = threadIdx.x; i < g.L; i += kThreads) {
    const int iy = i / g.ws;
    const int ix = i - iy * g.ws;
    pix[i] = (wy * g.ws + iy) * g.Wp + wx * g.ws + ix;
  }
}

// Copies 16 bytes (part `part` of a row of 32 head channels) from device
// memory to a shared row, or zeros when src_row is null. Rows start on
// 64-byte boundaries in device memory (the wrappers check the base pointers)
// and on 4-byte boundaries in shared memory.
template <typename T>
__device__ __forceinline__ void copy_row_part(T* dst_row, const T* src_row, int part) {
  constexpr int kVec = 16 / (int)sizeof(T);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src_row != nullptr) v = *reinterpret_cast<const uint4*>(src_row + part * kVec);
  uint32_t* dst = reinterpret_cast<uint32_t*>(dst_row + part * kVec);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

template <typename T> constexpr int kParts = kD * (int)sizeof(T) / 16;  // 16-byte parts per row

// Loads head h's k and v rows of one window into shared memory (rows beyond L
// zero). image is the image's (Hp, Wp, width) map with k at channel koff and
// v at koff + C; pix is the window's pixel table.
template <typename T, int KC>
__device__ __forceinline__ void load_kv(const Geometry& g, const T* __restrict__ image, int width,
                                        int koff, int h, const int* pix, T* sk, T* sv) {
  constexpr int Dp = kD + kPad<T>;
  for (int idx = threadIdx.x; idx < 16 * KC * kParts<T>; idx += kThreads) {
    const int j = idx / kParts<T>;
    const int part = idx - j * kParts<T>;
    const T* src = j < g.L ? image + (size_t)pix[j] * width + koff + h * kD : nullptr;
    copy_row_part(sk + j * Dp, src, part);
    copy_row_part(sv + j * Dp, src != nullptr ? src + g.C : nullptr, part);
  }
}

// Cosine mode: normalises rows [0, rows) of a shared (rows, Dp) array in
// place, one warp per row (lane d holds channel d): x * rsqrt(sum x^2 + eps)
// in f32, rounded to T. The f32 factor of row i goes to rinv[i] when rinv is
// not null (the backward needs it). Zero rows stay zero. The caller
// synchronises before and after.
template <typename T>
__device__ __forceinline__ void normalize_rows(T* rows_base, int rows, float* rinv) {
  constexpr int Dp = kD + kPad<T>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < rows; i += kThreads / 32) {
    T* row = rows_base + i * Dp;
    const float x = to_f(row[lane]);
    float ss = x * x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss + kNormEps);
    row[lane] = from_f<T>(x * r);
    if (rinv != nullptr && lane == 0) rinv[i] = r;
  }
}

// Cosine mode, backward through the f32 row normalisation xn = x r,
// r = rsqrt(sum x^2 + eps): dx = r dxn - r^3 x sum(x dxn). The thread holds
// columns tj and tj + 16 of one row (x0, x1 and dxn0, dxn1); the 16 lanes of
// the row sum their shares, so every lane must call this.
__device__ __forceinline__ void normalize_backward(float x0, float x1, float r, float& d0,
                                                   float& d1) {
  const float dot = row_sum16(fmaf(x0, d0, x1 * d1));
  const float r3 = r * r * r;
  d0 = r * d0 - r3 * x0 * dot;
  d1 = r * d1 - r3 * x1 * dot;
}

// Sums x over the block (all kThreads threads call it) in a fixed order;
// the result is valid in thread 0. red holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();  // red may still be read from an earlier call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  }
  return total;
}

}  // namespace wattn
