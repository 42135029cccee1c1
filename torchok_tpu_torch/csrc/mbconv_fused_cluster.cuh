// K9's bf16 route: one inference MBConv block in one launch, each image held
// by a thread-block cluster of S = 1, 2, 4 or 8 blocks, one row strip a
// block, with the two 1x1 products on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulators). Entered from mbconv_fused_fwd.cu
// (mbconv_fused_cluster_fwd); the f32 route stays on that file's three-launch
// kernel.
//
// Same contract as mbconv_fused_fwd.cu (replaces the Pallas TPU kernel
// tools/probe_mbconv_fused.py::_kernel). What the TPU kernel does, and this
// one now does too: it keeps the whole expanded image on the chip and takes
// the SE mean from it before the projection. In bf16 one image's activation
// after the depthwise conv fits the shared memory of a cluster, so nothing is
// computed twice and nothing of it goes to device memory. A block (512
// threads, one an SM) holds, for its strip of `rows` image rows:
//   xs    the strip's x rows and (k-1)/2 halo rows each side, bf16, channels
//         padded with zeros to a multiple of 16 (the product's depth)
//   act   the strip's activation after the depthwise conv for all of mid, bf16
//   e     one chunk of the expansion, f32, with a zero border (the padding of
//         the depthwise conv comes after the activation); the chunk's w_exp^T
//         rows, rounded to bf16 here from the f32 weights, which the threads
//         fetch into registers while the previous chunk computes; two stages
//         of the chunk's s1, b1, s2, b2 and taps by cp.async. The projection's
//         ring of three tiles of f32 w_proj rows takes the same space after.
//   part  the strip's per-channel sums of act for the SE mean, then the SE
//         hidden layer; gate the SE mean, then the gate
// Per chunk of mid: expand (A = x pixels, B = w_exp^T rows, by ldmatrix) on
// mma.sync, affine + swish into e; the depthwise conv in f32 FMAs, a thread a
// channel sliding along 8 pixels of a row; affine + swish; each value
// added in f32 into the thread's SE sum and stored once in bf16 into act.
// Then the SE mean across the cluster with no atomics: every block adds the
// S strips' sums in rank order through distributed shared memory (so all
// hold the same bits), runs the two SE layers itself, and the projection
// follows from shared memory: A = act, B = bf16(gate * w_proj) built per warp
// from the staged f32 rows (the gate folded into B keeps act's one rounding),
// y accumulated in registers over mid; then affine, + x as read, one
// rounding.
//
// Rounding points: x is exact in bf16; w_exp, each product of act (the f32
// value after the depthwise conv's swish) and gate * w_proj are rounded to
// bf16 as operands (the plain version has none of these roundings); the SE
// mean is over the f32 values before their rounding. sigmoid uses ex2.approx
// and rcp.approx. Every sum has a fixed order, so the result is bit-equal
// from run to run.
//
// What bounds it: at B0's blocks (bs 256) the work is small for the card
// (0.11 ms of products at the tensor cores' peak, 0.16 ms of taps in f32,
// about 0.35 ms of exponentials). One 512-thread block an SM runs phases
// behind barriers with little work each, so latency bounds it: builds
// without one phase each (tools/time_mbconv_cluster_variants.py) put the
// expansion and the depthwise conv first at 56x56 to 14x14, and at 7x7 the
// projection's stream of w_proj (0.9 MB a block) first.
#pragma once
#include <cooperative_groups.h>

#include "swin_mma_common.cuh"

// K9_RUN(phase): whether the kernel runs a phase (expand, depthwise, se,
// project). Always in the package; tools/time_mbconv_cluster_variants.py
// builds this file with it defined to leave a phase out, for timing.
#ifndef K9_RUN
#define K9_RUN(phase) true
#endif

namespace mbconv_cluster {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using swin_mma::cp_async16;
using swin_mma::cp_async_commit;
using swin_mma::cp_async_wait_all;
using swin_mma::ldsm_x4;
using swin_mma::mma16816;
using swin_mma::pack_bf16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTilesM = 4;     // m-tiles (16 pixels) of y a warp holds at most
constexpr int kTilesN = 2;     // n-tiles (8 channels) of y a warp holds at most
constexpr int kMaxStrips = 8;  // blocks of a cluster (portable)
constexpr int kQuads = 6;      // float4 of a chunk's w_exp a thread carries (C x chunk <= 12288)
constexpr int kProjStages = 3;  // the w_proj ring
constexpr size_t kSharedLimit = 232448;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* w_exp;  // (C, mid), rounded to bf16 in the kernel
  const float *s1, *b1, *w_dw, *s2, *b2;
  const float* w_se1;  // (mid, rd)
  const float *b_se1, *w_se2, *b_se2;
  const float* w_proj;  // (mid, C)
  const float *s3, *b3;
};

struct Dims {
  int N, H, W, C, mid, rd, rows, chunk, kc, strips, warps_m;
};

__host__ __device__ constexpr size_t up16(size_t v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Byte offsets of the shared buffers; ops/mbconv_fused.py::cluster_shared_bytes
// computes the same total.
struct Layout {
  int cp;         // C padded to 16: the expand's depth
  int xs_stride;  // bf16 per row of xs and of a w_exp stage (odd multiple of 16 bytes)
  int a_stride;   // bf16 per row of act
  int e_stride;   // floats per position of e (odd: other channels, other banks)
  int p_stride;   // floats per row of a w_proj stage (rows 2 apart, 8 banks apart)
  int xm, am;     // rows of xs and act: x pixels held, strip pixels
  size_t e_bytes, xs, act, e, wexp, vec, vec_stage, proj, proj_stage, part, gate, red, total;
  __host__ __device__ Layout(int H, int W, int C, int mid, int K, int rows, int chunk, int kc) {
    const int pad = (K - 1) / 2;
    const int halo = rows + 2 * pad < H ? rows + 2 * pad : H;
    cp = round16(C);
    xs_stride = cp + 8;
    a_stride = mid + 8;
    e_stride = chunk + 1;
    p_stride = C + 4;
    xm = halo * W;
    am = rows * W;
    e_bytes = (size_t)(rows + 2 * pad) * (W + 2 * pad) * e_stride * 4;
    xs = 0;
    act = xs + up16((size_t)xm * xs_stride * 2);
    e = act + up16((size_t)am * a_stride * 2);
    wexp = e + up16(e_bytes);  // the chunk's w_exp^T rows [chunk][xs_stride], bf16
    vec = wexp + up16((size_t)chunk * xs_stride * 2);
    // two stages of the chunk's s1, b1, s2, b2 and K x K taps [4 + K * K][chunk]
    vec_stage = up16((size_t)chunk * (4 + K * K) * 4);
    proj = e;  // the projection's ring reuses the expansion's space
    proj_stage = up16((size_t)kc * p_stride * 4);
    const size_t expand_space = vec + 2 * vec_stage - e;
    const size_t project_space = kProjStages * proj_stage;
    part = e + (expand_space > project_space ? expand_space : project_space);
    gate = part + up16((size_t)mid * 4);
    red = gate + up16((size_t)mid * 4);
    total = red + kThreads * 4;
    // the last m-tile of xs or act reads up to 15 rows past its end: rows of
    // the buffers after it (their products are never stored)
    const size_t xs_tiles = xs + (size_t)round16(xm) * xs_stride * 2;
    const size_t act_tiles = act + (size_t)round16(am) * a_stride * 2;
    total = total > xs_tiles ? total : xs_tiles;
    total = total > act_tiles ? total : act_tiles;
  }
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 1 / (1 + e^-a): 0 for a very negative (rcp of +inf is +0)
__device__ __forceinline__ float sigmoid(float a) {
  return rcp_approx(1.f + swin_mma::ex2(-a * kLog2e));
}
__device__ __forceinline__ float swish(float a) { return a * sigmoid(a); }

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk c0's columns of w_exp (C, mid) f32 into registers, kQuads float4 a
// thread: they load while the previous chunk computes.
__device__ __forceinline__ void fetch_w_exp(float4 (&v)[kQuads], const float* __restrict__ w,
                                            int c0, const Dims& d) {
  const int quads = d.chunk / 4;
#pragma unroll
  for (int r = 0; r < kQuads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int k = i / quads;
    if (k < d.C)
      v[r] = __ldg(reinterpret_cast<const float4*>(w + (size_t)k * d.mid + c0) + i - k * quads);
  }
}

// ... rounded to bf16 into the rows [chunk][xs_stride] of w_exp^T (its
// columns from C stay zero).
__device__ __forceinline__ void store_w_exp(bf16* rows, const float4 (&v)[kQuads], const Dims& d,
                                            const Layout& L) {
  const int quads = d.chunk / 4;
#pragma unroll
  for (int r = 0; r < kQuads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int k = i / quads;
    if (k < d.C) {
      bf16* dst = rows + (i - k * quads) * 4 * L.xs_stride + k;
      dst[0] = __float2bfloat16_rn(v[r].x);
      dst[L.xs_stride] = __float2bfloat16_rn(v[r].y);
      dst[2 * L.xs_stride] = __float2bfloat16_rn(v[r].z);
      dst[3 * L.xs_stride] = __float2bfloat16_rn(v[r].w);
    }
  }
}

// Chunk c0's s1, b1, s2, b2 and taps [K * K][chunk] into a stage, by cp.async.
template <int K>
__device__ __forceinline__ void load_vectors(float* vec, const Params& p, int c0, const Dims& d) {
  const int quads = d.chunk / 4;
  for (int i = threadIdx.x; i < (4 + K * K) * quads; i += kThreads) {
    const int v = i / quads;
    const int q = i - v * quads;
    const float* src = v == 0 ? p.s1 : v == 1 ? p.b1 : v == 2 ? p.s2 : v == 3 ? p.b2
                                                              : p.w_dw + (size_t)(v - 4) * d.mid;
    cp_async16(vec + v * d.chunk + q * 4, src + c0 + q * 4, true);
  }
}

// The rows k0 .. k0 + min(kc, mid - k0) of w_proj (mid, C) into a stage
// [kc][p_stride].
__device__ __forceinline__ void load_w_proj(float* dst, const float* __restrict__ w, int k0,
                                            const Dims& d, const Layout& L) {
  const int parts = d.C / 4;
  const int n = min(d.kc, d.mid - k0) * parts;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / parts;
    const int q = i - r * parts;
    cp_async16(dst + r * L.p_stride + q * 4, w + (size_t)(k0 + r) * d.C + q * 4, true);
  }
}

// e = swish(x w_exp[:, c0 : c0 + chunk] * s1 + b1) for the x pixels held,
// into the zero-bordered e. A warp takes 16 pixels x 16 channels at a time.
__device__ __forceinline__ void expand_chunk(const bf16* xs, const bf16* ws, const float* vec,
                                             float* es, const Dims& d, const Layout& L, int xpix,
                                             int hr0, int pad) {
  const float* s1 = vec;
  const float* b1 = vec + d.chunk;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int groups = d.chunk / 16;
  const int items = (xpix + 15) / 16 * groups;
  const int wpad = d.W + 2 * pad;
  const int ksteps = L.cp / 16;
  for (int it = threadIdx.x >> 5; it < items; it += kWarps) {
    const int mt = it / groups;
    const int ng = it - mt * groups;
    const bf16* arow = xs + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.xs_stride +
                       (lane >> 4) * 8;
    const bf16* brow = ws + (ng * 16 + (lane & 7) + (lane >> 4) * 8) * L.xs_stride +
                       ((lane >> 3) & 1) * 8;
    float acc[2][4] = {};
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4], b[4];
      ldsm_x4(a, arow + ks * 16);
      ldsm_x4(b, brow + ks * 16);
      mma16816(acc[0], a, b[0], b[1]);
      mma16816(acc[1], a, b[2], b[3]);
    }
    // the lane's two pixels (rows g and g + 8 of the tile) in e; -1 past xpix
    int off[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = mt * 16 + g + 8 * half;
      const int row = pix / d.W;
      off[half] = pix < xpix ? ((hr0 + row) * wpad + pix - row * d.W + pad) * L.e_stride : -1;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = ng * 16 + h * 8 + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(s1 + ch);
      const float2 b = *reinterpret_cast<const float2*>(b1 + ch);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (off[half] >= 0) {
          es[off[half] + ch] = swish(fmaf(acc[h][2 * half], s.x, b.x));
          es[off[half] + ch + 1] = swish(fmaf(acc[h][2 * half + 1], s.y, b.y));
        }
      }
    }
  }
}

// The depthwise conv of the chunk over the strip's rows, affine and swish:
// each value is added to the thread's SE sum (f32, a fixed order) and stored
// once in bf16 into act. A thread keeps one channel (its taps in registers)
// and slides along kSeg pixels of a row. The chunk is a template argument, so the window's
// loads take immediate offsets; a row's last segment reads past the row (into
// the next row, or the buffers after e) values that only its outputs past W
// use, and those are never stored.
template <int K, int kSeg, int kChunk>
__device__ __forceinline__ float depthwise_chunk(const float* es, const float* vec, bf16* act,
                                                 const Dims& d, const Layout& L, int c0,
                                                 int rows) {
  constexpr int pad = (K - 1) / 2;
  constexpr int kStride = kChunk + 1;  // L.e_stride
  const int wpad = d.W + 2 * pad;
  const int c = threadIdx.x % kChunk;
  float wk[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = vec[(4 + t) * kChunk + c];
  const float s2 = vec[2 * kChunk + c], b2 = vec[3 * kChunk + c];
  const int segs = (d.W + kSeg - 1) / kSeg;
  const int items = rows * segs;
  float sum = 0.f;
  for (int it = threadIdx.x / kChunk; it < items; it += kThreads / kChunk) {
    const int r = it / segs;
    const int j0 = (it - r * segs) * kSeg;
    const int len = min(kSeg, d.W - j0);
    float acc[kSeg] = {};
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      // output row r reads e rows r .. r + K - 1, padded columns j0 ..
      const float* src = es + ((r + dy) * wpad + j0) * kStride + c;
      float win[kSeg + K - 1];
#pragma unroll
      for (int q = 0; q < kSeg + K - 1; ++q) win[q] = src[q * kStride];
#pragma unroll
      for (int j = 0; j < kSeg; ++j)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) acc[j] = fmaf(win[j + dx], wk[dy * K + dx], acc[j]);
    }
    bf16* dst = act + (r * d.W + j0) * L.a_stride + c0 + c;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (j < len) {
        const float v = swish(fmaf(acc[j], s2, b2));
        sum += v;
        dst[j * L.a_stride] = __float2bfloat16_rn(v);
      }
    }
  }
  return sum;
}

// depthwise_chunk at the launch's chunk, along 8 pixels.
template <int K>
__device__ __forceinline__ float depthwise_any(const float* es, const float* vec, bf16* act,
                                               const Dims& d, const Layout& L, int c0, int rows) {
  if (d.chunk == 16) return depthwise_chunk<K, 8, 16>(es, vec, act, d, L, c0, rows);
  if (d.chunk == 32) return depthwise_chunk<K, 8, 32>(es, vec, act, d, L, c0, rows);
  return depthwise_chunk<K, 8, 64>(es, vec, act, d, L, c0, rows);
}

// The strip's sum of a chunk's channel c: the threads' sums in order.
__device__ __forceinline__ float strip_sum(const float* red, int c, int chunk) {
  float s = 0.f;
  for (int j = c; j < kThreads; j += chunk) s += red[j];
  return s;
}

// The SE layers on the mean in gate, every block for all of mid: layer 1 by
// thread (slice sl, unit j) over its slice of mid (reads of w_se1 (mid, rd)
// contiguous across j), then the slices in order, into part; layer 2 and the
// sigmoid into gate.
__device__ __forceinline__ void se_layers(const Params& p, const Dims& d, float* gate,
                                          float* part, float* red) {
  const int tid = threadIdx.x;
  const int slices = kThreads / d.rd;
  const int len = (d.mid + slices - 1) / slices;
  if (tid < slices * d.rd) {
    const int sl = tid / d.rd, j = tid - sl * d.rd;
    const int c1 = min(d.mid, (sl + 1) * len);
    float a = 0.f;
#pragma unroll 8
    for (int c = sl * len; c < c1; ++c) a = fmaf(gate[c], __ldg(p.w_se1 + (size_t)c * d.rd + j), a);
    red[tid] = a;
  }
  __syncthreads();
  if (tid < d.rd) {
    float a = 0.f;
    for (int sl = 0; sl < slices; ++sl) a += red[sl * d.rd + tid];
    part[tid] = swish(a + __ldg(p.b_se1 + tid));
  }
  __syncthreads();
  for (int c = tid; c < d.mid; c += kThreads) {
    float a = 0.f;
#pragma unroll 16
    for (int j = 0; j < d.rd; ++j) a = fmaf(part[j], __ldg(p.w_se2 + (size_t)j * d.mid + c), a);
    gate[c] = sigmoid(a + __ldg(p.b_se2 + c));
  }
}

// grid (strips, N), clusters of `strips` blocks: block `strip` of image n.
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    mbconv_cluster_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, Params p, Dims d) {
  constexpr int pad = (K - 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d.H, d.W, d.C, d.mid, K, d.rows, d.chunk, d.kc);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* act = reinterpret_cast<bf16*>(smem + L.act);
  float* es = reinterpret_cast<float*>(smem + L.e);
  bf16* wrows = reinterpret_cast<bf16*>(smem + L.wexp);
  float* vst = reinterpret_cast<float*>(smem + L.vec);
  float* pst = reinterpret_cast<float*>(smem + L.proj);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* gate = reinterpret_cast<float*>(smem + L.gate);
  float* red = reinterpret_cast<float*>(smem + L.red);
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = blockIdx.x;  // the block's rank in its cluster
  const int n = blockIdx.y;
  const int r0 = strip * d.rows;
  const int rows = min(d.rows, d.H - r0);  // this strip's rows
  const int lo = max(0, r0 - pad);         // image rows of x held: [lo, hi)
  const int hi = min(d.H, r0 + rows + pad);
  const int xpix = (hi - lo) * d.W;
  const int npix = rows * d.W;
  const size_t pstage = L.proj_stage / 4;  // floats a w_proj stage

  // x rows [lo, hi) of image n and chunk 0's vectors, by cp.async; its w_exp
  // rows
  const bf16* xb = x + ((size_t)n * d.H + lo) * d.W * d.C;
  const int cparts = d.C / 8;
  for (int i = tid; i < xpix * cparts; i += kThreads) {
    const int pix = i / cparts;
    const int q = i - pix * cparts;
    cp_async16(xs + pix * L.xs_stride + q * 8, xb + (size_t)pix * d.C + q * 8, true);
  }
  load_vectors<K>(vst, p, 0, d);
  cp_async_commit();
  float4 wv[kQuads];
  fetch_w_exp(wv, p.w_exp, 0, d);
  // zeros: the channels past C of xs and of the w_exp rows, and e (its
  // border and the halo rows outside the image stay zero)
  const int cpad = L.cp - d.C;
  for (int i = tid; i < L.xm * cpad; i += kThreads) {
    const int pix = i / cpad;
    xs[pix * L.xs_stride + d.C + i - pix * cpad] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < d.chunk * cpad; i += kThreads) {
    const int r = i / cpad;
    wrows[r * L.xs_stride + d.C + i - r * cpad] = __float2bfloat16_rn(0.f);
  }
  for (size_t i = tid; i < L.e_bytes / 4; i += kThreads) es[i] = 0.f;
  store_w_exp(wrows, wv, d, L);

  const int chunks = d.mid / d.chunk;
  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = ci * d.chunk;
    cp_async_wait_all();
    __syncthreads();  // chunk ci's rows and vectors (and x) in; the previous chunk's readers done
    if (ci > 0 && tid < d.chunk) part[c0 - d.chunk + tid] = strip_sum(red, tid, d.chunk);
    const bool next = ci + 1 < chunks;
    if (next) {
      load_vectors<K>(vst + ((ci + 1) & 1) * (L.vec_stage / 4), p, c0 + d.chunk, d);
      cp_async_commit();
      fetch_w_exp(wv, p.w_exp, c0 + d.chunk, d);
    }
    const float* vec = vst + (ci & 1) * (L.vec_stage / 4);
    if (K9_RUN(expand)) expand_chunk(xs, wrows, vec, es, d, L, xpix, lo - (r0 - pad), pad);
    __syncthreads();
    if (next) store_w_exp(wrows, wv, d, L);  // every warp is past expand(ci)
    red[tid] = K9_RUN(depthwise) ? depthwise_any<K>(es, vec, act, d, L, c0, rows) : 0.f;
  }
  __syncthreads();
  if (tid < d.chunk) part[d.mid - d.chunk + tid] = strip_sum(red, tid, d.chunk);

  // The SE mean: the strips' sums in rank order, read from each block's
  // shared memory; the second sync keeps every block's part alive until all
  // have read it.
  cluster.sync();
  {
    const float* parts[kMaxStrips];
    for (int r = 0; r < d.strips; ++r) parts[r] = cluster.map_shared_rank(part, r);
    const float count = (float)d.H * (float)d.W;
    for (int c = tid; c < d.mid; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < d.strips; ++r) s += parts[r][c];
      gate[c] = s / count;
    }
  }
  cluster.sync();
  if (K9_RUN(se)) se_layers(p, d, gate, part, red);

  // The projection: y (npix x C) in registers; warp (wm, wn) holds m-tiles
  // wm + WM i and n-tiles wn + WN j.
  const int wn_count = kWarps / d.warps_m;
  const int wm = warp / wn_count, wn = warp - wm * wn_count;
  const int mtiles = (npix + 15) / 16, ntiles = d.C / 8;
  float acc[kTilesM][kTilesN][4] = {};
  const int ktiles = K9_RUN(project) ? (d.mid + d.kc - 1) / d.kc : 0;
  // a ring of kProjStages tiles, one group committed a tile (empty past the
  // end) so that wait_group<kProjStages - 2> finds tile kt in
  for (int kt = 0; kt < kProjStages - 1; ++kt) {
    if (kt < ktiles) load_w_proj(pst + kt * pstage, p.w_proj, kt * d.kc, d, L);
    cp_async_commit();  // e, the w_exp rows and the vector stages are free
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait_group<kProjStages - 2>();
    __syncthreads();  // tile kt in (and the gate); the previous tile's readers done
    const int ahead = kt + kProjStages - 1;
    if (ahead < ktiles)
      load_w_proj(pst + (ahead % kProjStages) * pstage, p.w_proj, ahead * d.kc, d, L);
    cp_async_commit();
    const float* wp = pst + (kt % kProjStages) * pstage;
    const int k0 = kt * d.kc;
    const int ksteps = min(d.kc, d.mid - k0) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int kk = ks * 16 + 2 * t;  // this lane's rows kk, kk + 1, kk + 8, kk + 9
      const int kg = k0 + kk;
      const float g0 = gate[kg], g1 = gate[kg + 1], g8 = gate[kg + 8], g9 = gate[kg + 9];
      uint32_t b[kTilesN][2];
#pragma unroll
      for (int j = 0; j < kTilesN; ++j) {
        const int col = (wn + wn_count * j) * 8 + g;
        if (col < d.C) {
          const float* w = wp + kk * L.p_stride + col;
          b[j][0] = pack_bf16(g0 * w[0], g1 * w[L.p_stride]);
          b[j][1] = pack_bf16(g8 * w[8 * L.p_stride], g9 * w[9 * L.p_stride]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTilesM; ++i) {
        const int mt = wm + d.warps_m * i;
        if (mt < mtiles) {
          uint32_t a[4];
          ldsm_x4(a, act + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.a_stride +
                         k0 + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < kTilesN; ++j)
            if (wn + wn_count * j < ntiles) mma16816(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
  }

  // y = round(acc * s3 + b3 + x), x read from xs
  const size_t ybase = ((size_t)n * d.H + r0) * d.W * d.C;
  const bf16* xstrip = xs + (size_t)(r0 - lo) * d.W * L.xs_stride;
#pragma unroll
  for (int j = 0; j < kTilesN; ++j) {
    const int nt = wn + wn_count * j;
    if (nt >= ntiles) continue;
    const int ch = nt * 8 + 2 * t;
    const float s0 = __ldg(p.s3 + ch), s1 = __ldg(p.s3 + ch + 1);
    const float b0 = __ldg(p.b3 + ch), b1 = __ldg(p.b3 + ch + 1);
#pragma unroll
    for (int i = 0; i < kTilesM; ++i) {
      const int mt = wm + d.warps_m * i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pix = mt * 16 + g + 8 * half;
        if (mt < mtiles && pix < npix) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(xstrip + (size_t)pix * L.xs_stride + ch);
          const float2 xf = __bfloat1622float2(xv);
          const float v0 = fmaf(acc[i][j][2 * half], s0, b0) + xf.x;
          const float v1 = fmaf(acc[i][j][2 * half + 1], s1, b1) + xf.y;
          *reinterpret_cast<uint32_t*>(y + ybase + (size_t)pix * d.C + ch) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

// Whether warps_m x (16 / warps_m) warps over the strip's y tiles hold at
// most kTilesM x kTilesN tiles each; the host picks warps_m.
__host__ __device__ inline bool fits_warps(int rows, int W, int C, int warps_m) {
  const int mtiles = (rows * W + 15) / 16, ntiles = C / 8, warps_n = kWarps / warps_m;
  return (mtiles + warps_m - 1) / warps_m <= kTilesM &&
         (ntiles + warps_n - 1) / warps_n <= kTilesN;
}

template <int K>
cudaError_t launch(const bf16* x, bf16* y, const Params& p, const Dims& d, cudaStream_t stream) {
  const size_t bytes = Layout(d.H, d.W, d.C, d.mid, K, d.rows, d.chunk, d.kc).total;
  if (bytes > kSharedLimit) return cudaErrorInvalidValue;
  auto kernel = mbconv_cluster_kernel<K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = d.strips;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(d.strips, d.N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;  // the cluster cannot be placed
  err = cudaLaunchKernelEx(&cfg, kernel, x, y, p, d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline cudaError_t launch_k(int K, const bf16* x, bf16* y, const Params& p, const Dims& d,
                            cudaStream_t stream) {
  switch (K) {
    case 1: return launch<1>(x, y, p, d, stream);
    case 3: return launch<3>(x, y, p, d, stream);
    case 5: return launch<5>(x, y, p, d, stream);
    case 7: return launch<7>(x, y, p, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mbconv_cluster
