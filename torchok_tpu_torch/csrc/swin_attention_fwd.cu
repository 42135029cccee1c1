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
