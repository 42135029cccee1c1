// Pieces shared by the window attention kernels on Hopper's tensor cores in
// bf16: the SwinV2 cosine forward (swin_attention_fwd_mma.cuh) and the
// backward of all three modes, cosine, plain-dot local and global-query
// (swin_attention_bwd_mma.cuh). PTX wrappers for cp.async,
// ldmatrix and mma.sync.m16n8k16 (bf16 operands, f32 accumulators), the
// tile heights, the fragment layouts of the products, and the loaders,
// normalisation and stores of window rows (through a window's pixel table)
// and of dense rows (global queries).
#pragma once
#include "window_attention_common.cuh"

namespace swin_mma {

using bf16 = __nv_bfloat16;
using wattn::Geometry;
using wattn::kD;
using wattn::kNormEps;

constexpr int kTile = 64;             // most rows of a tile (queries or keys)
constexpr int kRow = kD + 8;          // bf16 per shared row: 80 bytes
constexpr float kLog2e = 1.4426950408889634f;

// L is cut into ceil(L / 64) tiles of equal height, a multiple of 16: 64
// rows, but 48 at L = 144 (three full tiles, not 64 + 64 + 16) and L = 36.
// A block has a warp per 16 rows of a tile (pass 2: two).
__host__ __device__ constexpr int tiles_of(int L) { return (L + kTile - 1) / kTile; }
__host__ __device__ constexpr int tile_rows(int L) {
  return ((L + tiles_of(L) - 1) / tiles_of(L) + 15) / 16 * 16;
}

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device to shared memory, zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; c 16 x 8 f32
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(logit - m) given m2 = m log2(e); 0 for a logit of -inf
__device__ __forceinline__ float exp_minus(float logit, float m2) {
  return ex2(fmaf(logit, kLog2e, -m2));
}

// ---- fragments ------------------------------------------------------------
// In an mma accumulator (16 x 8) lane (g = lane / 4, t = lane % 4) holds
// rows g and g + 8, columns 2t and 2t + 1: entry e of n-tile n is row
// g + 8 (e / 2), column 8 n + 2 t + e % 2.

// The operand A (16 rows x 16 channels from ks * 16) of rows r0.. of a
// shared [row][kRow] array.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16* rows, int r0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = rows + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) ldsm_x4(a[ks], p + 16 * ks);
}

// acc (16 rows x 32 channels) += P z, where P (16 x 16 np) is the bf16
// rounding of the accumulator-layout values p and z the shared rows
// k0 .. k0 + 16 np (all 32 channels) of a [row][kRow] array.
template <int kPairs>
__device__ __forceinline__ void product_into(float (&acc)[4][4], const float (&p)[2 * kPairs][4],
                                             const bf16* z, int k0, int np) {
  const int lane = threadIdx.x & 31;
  const int off = (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow + (lane >> 4) * 8;
#pragma unroll
  for (int kp = 0; kp < kPairs; ++kp) {
    if (kp < np) {
      const uint32_t a[4] = {pack_bf16(p[2 * kp][0], p[2 * kp][1]),
                             pack_bf16(p[2 * kp][2], p[2 * kp][3]),
                             pack_bf16(p[2 * kp + 1][0], p[2 * kp + 1][1]),
                             pack_bf16(p[2 * kp + 1][2], p[2 * kp + 1][3])};
#pragma unroll
      for (int nc = 0; nc < 2; ++nc) {
        uint32_t f[4];
        ldsm_x4_trans(f, z + off + 16 * kp * kRow + 16 * nc);
        mma16816(acc[2 * nc], a, f[0], f[1]);
        mma16816(acc[2 * nc + 1], a, f[2], f[3]);
      }
    }
  }
}

// ---- rows and tiles in shared memory --------------------------------------

// pix[i], i < L: the offset of token i of window win in one image's map
__device__ __forceinline__ void fill_pixels(const Geometry& g, int win, int* pix) {
  const int wy = win / g.ngx;
  const int wx = win - wy * g.ngx;
  for (int i = threadIdx.x; i < g.L; i += blockDim.x) {
    const int iy = i / g.ws;
    pix[i] = (wy * g.ws + iy) * g.Wp + wx * g.ws + i - iy * g.ws;
  }
}

// Rows r0 .. r0 + rows of a window (channels off .. off + 32 of rows of
// `width` in image) into dst by cp.async, zeros beyond L.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ image, int width,
                                          int off, const int* pix, int r0, int rows, int L) {
  for (int idx = threadIdx.x; idx < rows * 4; idx += blockDim.x) {
    const int r = idx >> 2;
    const int part = idx & 3;
    const bool valid = r0 + r < L;
    const bf16* src = image + (valid ? (size_t)pix[r0 + r] * width + off + part * 8 : 0);
    cp_async16(dst + r * kRow + part * 8, src, valid);
  }
}

// Rows r0 .. r0 + rows of a dense (L, width) matrix (channels off .. off +
// 32) into dst by cp.async, zeros beyond L: GCViT's global queries.
__device__ __forceinline__ void load_dense_rows(bf16* dst, const bf16* __restrict__ matrix,
                                                int width, int off, int r0, int rows, int L) {
  for (int idx = threadIdx.x; idx < rows * 4; idx += blockDim.x) {
    const int r = idx >> 2;
    const int part = idx & 3;
    const bool valid = r0 + r < L;
    const bf16* src = matrix + (valid ? (size_t)(r0 + r) * width + off + part * 8 : 0);
    cp_async16(dst + r * kRow + part * 8, src, valid);
  }
}

// Normalises rows [0, rows) of src into dst (may be src): x rsqrt(sum x^2 +
// eps) in f32, rounded to bf16; 1 / |x| of row r to rinv[r] if rinv is not
// null. Four threads a row; rows * 4 is a multiple of the block's threads,
// so whole warps take part in the shuffles. Both passes normalise with this
// code, so they see the same bits of qn and kn.
__device__ __forceinline__ void normalize_rows(const bf16* src, bf16* dst, int rows,
                                               float* rinv) {
  for (int idx = threadIdx.x; idx < rows * 4; idx += blockDim.x) {
    const int r = idx >> 2;
    const int part = idx & 3;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * kRow + part * 8);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    float v[8];
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = __bfloat162float(x[c]);
      ss = fmaf(v[c], v[c], ss);
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    const float rn = rsqrtf(ss + kNormEps);
    uint4 out;
    out.x = pack_bf16(v[0] * rn, v[1] * rn);
    out.y = pack_bf16(v[2] * rn, v[3] * rn);
    out.z = pack_bf16(v[4] * rn, v[5] * rn);
    out.w = pack_bf16(v[6] * rn, v[7] * rn);
    *reinterpret_cast<uint4*>(dst + r * kRow + part * 8) = out;
    if (rinv != nullptr && part == 0) rinv[r] = rn;
  }
}

// Stores the packed pairs of the warp's rows i0 + g, i0 + g + 8 (those
// below L) at channel offset off.
__device__ __forceinline__ void store_rows(bf16* __restrict__ image, int width, int off,
                                           const int* pix, int i0, int L,
                                           const uint32_t (&v)[2][4]) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + gr + 8 * r;
    if (i < L) {
      bf16* dst = image + (size_t)pix[i] * width + off + 2 * tc;
#pragma unroll
      for (int n = 0; n < 4; ++n) *reinterpret_cast<uint32_t*>(dst + 8 * n) = v[r][n];
    }
  }
}

}  // namespace swin_mma
