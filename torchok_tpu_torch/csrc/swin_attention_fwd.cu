// SwinV2 shifted-window cosine attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel torchok_tpu/ops/swin_attention.py::_fwd_kernel
// (cosine mode, spatial layout; reached through _fwd_pallas and the public
// fused_swin_attention). Same contract:
//   qkv (B, Hp, Wp, 3C) bf16|f32, scale (H,) f32 = exp(min(logit_scale, ln 100)),
//   bias (H, L, L) f32, mask (nW, L, L) f32 or null  ->  out (B, Hp, Wp, C), qkv's dtype,
// head dim 32, any window side ws up to 24 (L = ws*ws up to 576: every
// registered SwinV2 variant, L = 36, 64, 144, 256, 576). Window partition and
// reverse happen in the indexing: no partitioned copy is ever made.
//
// Rounding points follow the Pallas kernel: q and k are row-normalised in f32
// (x * rsqrt(sum x^2 + 1e-12)) and rounded to the input dtype, QK^T
// accumulates in f32, then *scale + bias (+ mask) and an f32 softmax, the
// attention weights are rounded to the input dtype, and PV accumulates in f32
// before the output is rounded.
//
// Routing (swin_attention_fwd_route, which dispatch follows):
//  * bf16, every L (36 to 576): the tensor-core kernel of
//    swin_attention_fwd_mma.cuh: kn normalised once per launch into a
//    scratch (and, in shifted blocks, bias + mask added once into another),
//    then a block per (window position, query tile, head, two images) walks
//    the key tiles twice on mma.sync with ldmatrix and a cp.async ring that
//    also carries the 64-wide f32 bias tiles: the row statistics first, then
//    bf16(a32) v. Tiles of 64 rows (48 at L = 36 and 144). Its tile loads
//    (their instructions and latency) and its f32 softmax arithmetic bound
//    it, not the products, L2 or device memory (PERF.md).
//  * f32: the cosine mode (kCosine, kHasMask) of the window attention
//    templates that also serve GCViT and DaViT: up to L = 256 the
//    register-tile kernel of window_attention_fwd.cuh (all keys of a window
//    in one block; 4, 13 or 16 key columns a thread), above it the key-tiled
//    kernel of window_attention_tiled.cuh (two passes over tiles of 64 keys:
//    online max and sum, then the rounded weights against v). These run f32
//    FMAs fed from shared memory (4*L*32 FLOPs per token and head, 6*L*32 on
//    the key-tiled path, which computes QK^T twice), far below the
//    tensor-core ridge: shared-memory bandwidth inside the block bounds them.
// The Pallas kernel's VMEM gate, which sends L = 576 to an XLA formulation
// on the TPU, has no counterpart: every L runs here.
//
// The least traffic: qkv read and the output written once (8 bytes per
// token and channel in bf16).
#include "swin_attention_fwd_mma.cuh"
#include "window_attention_fwd.cuh"
#include "window_attention_tiled.cuh"

namespace swin_fwd {

// The cosine mode's three launches. kn: (B, Hp, Wp, C) bf16 scratch;
// bias_mask: (nW, H, L, L) f32 scratch when mask is not null (unused
// otherwise); images: images a block takes, 1 or 2.
inline cudaError_t launch(const void* qkv, const void* scale, const void* bias, const void* mask,
                          void* out, void* kn, void* bias_mask, const Geometry& g, int images,
                          cudaStream_t st) {
  const bool shifted = mask != nullptr;
  const int z = (g.B + images - 1) / images;
  if (kn == nullptr || (shifted && bias_mask == nullptr) || images < 1 || images > 2 ||
      z > 65535 || g.nheads > 65535) {
    return cudaErrorInvalidValue;
  }
  const int tr = fwd_tile_rows(g.L);
  const size_t bytes = shared_bytes(g.L, images);
  auto kernel = tr == 64 ? (images == 2 ? swin_fwd_kernel<4, 2, true, true, false>
                                        : swin_fwd_kernel<4, 1, true, true, false>)
                         : (images == 2 ? swin_fwd_kernel<3, 2, true, true, false>
                                        : swin_fwd_kernel<3, 1, true, true, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const float* bi = static_cast<const float*>(bias);
  if (shifted) {
    const size_t n = (size_t)g.nW * g.nheads * g.L * g.L;
    const size_t want = (n + 255) / 256;
    combine_bias_mask<<<(int)(want < 4096 ? want : 4096), 256, 0, st>>>(
        bi, static_cast<const float*>(mask), static_cast<float*>(bias_mask), g.nheads, g.nW,
        g.L * g.L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bi = static_cast<const float*>(bias_mask);
  }
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* k = static_cast<bf16*>(kn);
  const size_t npix = (size_t)g.B * g.Hp * g.Wp;
  const size_t want = (npix * g.nheads * 4 + 255) / 256;
  normalize_k<<<(int)(want < 8192 ? want : 8192), 256, 0, st>>>(q, k, npix, g.nheads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.nW * tiles_of(g.L), g.nheads, z), 2 * tr, bytes, st>>>(
      q, k, static_cast<const float*>(scale), bi, static_cast<bf16*>(out), g, shifted ? 1 : 0,
      nullptr, g.L);
  return cudaGetLastError();
}

}  // namespace swin_fwd

namespace {

using namespace wattn;

enum Route { kRouteTemplates = 0, kRouteTiled = 1, kRouteMma = 2 };

int route_of(int dtype, int ws) {
  if (dtype == 1) return kRouteMma;
  return ws * ws <= kMaxL ? kRouteTemplates : kRouteTiled;
}

// f32: the FMA kernels
cudaError_t launch_f32(const void* qkv, const void* scale, const void* bias, const void* mask,
                       void* out, const Geometry& g, cudaStream_t st) {
  const bool masked = mask != nullptr;
  if (route_of(0, g.ws) == kRouteTemplates) {
    return masked ? launch_fwd<float, true, false, true, true>(qkv, nullptr, scale, bias, mask,
                                                               out, g, st)
                  : launch_fwd<float, true, false, true, false>(qkv, nullptr, scale, bias, mask,
                                                                out, g, st);
  }
  return masked ? launch_fwd_tiled<float, true>(qkv, scale, bias, mask, out, g, st)
                : launch_fwd_tiled<float, false>(qkv, scale, bias, mask, out, g, st);
}

}  // namespace

// The route a launch of this dtype (0 = float32, 1 = bfloat16) and window
// side takes: 0 the templates, 1 the key-tiled kernel, 2 the tensor-core
// kernel.
extern "C" int swin_attention_fwd_route(int dtype, int ws) { return route_of(dtype, ws); }

// dtype: 0 = float32, 1 = bfloat16. mask may be null (unshifted blocks).
// bf16 only (ignored in f32): scratch kn (B, Hp, Wp, C) bf16 and, when mask
// is not null, bias_mask (nW, H, L, L) f32; images_per_block, 1 or 2.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int swin_attention_fwd(const void* qkv, const void* scale, const void* bias,
                                  const void* mask, void* out, void* kn, void* bias_mask,
                                  int dtype, int B, int Hp, int Wp, int C, int nheads, int ws,
                                  int images_per_block, void* stream) {
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws, kMaxLTiled) || bias == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(qkv, scale, bias, mask, out, g, st);
  if (dtype == 1) {
    return (int)swin_fwd::launch(qkv, scale, bias, mask, out, kn, bias_mask, g, images_per_block,
                                 st);
  }
  return (int)cudaErrorInvalidValue;
}
