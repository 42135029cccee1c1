// SwinV2 shifted-window cosine attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel torchok_tpu/ops/swin_attention.py::_bwd_kernel
// (cosine mode, spatial layout; reached through _bwd_pallas and the custom_vjp
// of fused_swin_attention). Same contract:
//   qkv (B, Hp, Wp, 3C) bf16|f32, scale (H,) f32, bias (H, L, L) f32,
//   mask (nW, L, L) f32 or null, dout (B, Hp, Wp, C) in qkv's dtype
//   ->  dqkv (B, Hp, Wp, 3C) in qkv's dtype, dbias (H, L, L) f32, dscale (H,) f32,
// head dim 32, ws up to 24 (L up to 576). The forward is recomputed from qkv;
// nothing but the inputs is saved.
//
// Rounding points follow the Pallas kernel (T = qkv's dtype, all else f32):
//   rq = rsqrt(sum q^2 + 1e-12), qn = T(q rq), kn likewise
//   cos = qn kn^T;  logits = cos s + bias (+ mask);  a32 = softmax;  a = T(a32)
//   dv = a^T do;  da = do v^T;  dl = a32 (da - rowsum(da a32))
//   dbias += dl;  dscale += sum(dl cos);  dls = T(dl s)
//   dqn = dls kn;  dkn = dls^T qn
//   dq = rq dqn - rq^3 q rowsum(q dqn);  dk likewise;  dqkv = T([dq | dk | dv])
//
// Routing (swin_attention_bwd_route, which dispatch follows):
//  * bf16, every L (36 to 576): the cosine mode of the tensor-core kernel
//    of swin_attention_bwd_mma.cuh (shared with the plain-dot backwards),
//    two passes (row statistics and dq; dk, dv,
//    dbias and dscale) on mma.sync with ldmatrix and cp.async, key and query
//    tiles of 64, L padded to a multiple of 16, the dbias sums of each block
//    in shared memory across its images. Nine products, all on the tensor
//    cores; its exponentials, bias reads and f32 softmax arithmetic bound
//    it (PERF.md).
//  * f32: the cosine mode of the window attention backward templates, up
//    to L = 256 window_attention_bwd.cuh (one block per window position and
//    head over a slice of the images, all keys in shared memory, dk/dv in
//    registers, dl summed into a per-block slab; at L <= 64 the dl sums stay
//    in registers across the images), above it the key-tiled kernel of
//    window_attention_tiled.cuh (row statistics first, then key tile by key
//    tile). These run f32 FMAs fed from shared memory,
//    far below the tensor-core ridge: shared-memory bandwidth inside the
//    block bounds them (10*L*32 FLOPs per token and head, 14*L*32 on the
//    key-tiled path).
// Every route writes (L, L) dbias slabs and dscale slots, which
// swin_attention_bwd_reduce adds in slot order, so the results are
// bit-identical from run to run (no atomics).
//
// The least traffic: qkv and dout read and dqkv written once (14 bytes per
// token and channel in bf16).
#include "swin_attention_bwd_mma.cuh"
#include "window_attention_bwd.cuh"
#include "window_attention_tiled.cuh"

namespace {

using namespace wattn;

// Adds the per-block slabs and dscale slots in slot order.
__global__ void swin_attention_bwd_reduce(const float* __restrict__ partial_bias,
                                          const float* __restrict__ partial_scale,
                                          float* __restrict__ dbias, float* __restrict__ dscale,
                                          int slots, int scale_slots, int nheads, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) {
    float total = 0.f;
    for (int p = 0; p < slots; ++p) total += partial_bias[(size_t)p * n + idx];
    dbias[idx] = total;
  }
  if (idx < nheads) {
    float total = 0.f;
    for (int p = 0; p < scale_slots; ++p) total += partial_scale[(size_t)p * nheads + idx];
    dscale[idx] = total;
  }
}

enum Route { kRouteTemplates = 0, kRouteTiled = 1, kRouteMma = 2 };

int route_of(int dtype, int ws) {
  if (dtype == 1) return kRouteMma;
  return ws * ws <= kMaxL ? kRouteTemplates : kRouteTiled;
}

// f32: the FMA kernels
template <bool kHasMask>
cudaError_t launch_f32(const void* qkv, const void* scale, const void* bias, const void* mask,
                       const void* dout, void* dqkv, void* pbias, void* pscale, const Geometry& g,
                       int images_per_block, cudaStream_t st) {
  const float* q = static_cast<const float*>(qkv);
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  const float* d = static_cast<const float*>(dout);
  float* dq = static_cast<float*>(dqkv);
  float* pb = static_cast<float*>(pbias);
  float* ps = static_cast<float*>(pscale);
  if (route_of(0, g.ws) == kRouteTiled) {
    return launch_bwd_tiled<float, kHasMask>(qkv, scale, bias, mask, dout, dqkv, pbias, pscale, g,
                                             images_per_block, st);
  }
  if (g.L <= 64) {
    return launch_bwd_kc<float, 4, true, false, true, kHasMask>(
        q, nullptr, s, bi, m, d, dq, nullptr, pb, ps, g, images_per_block, st);
  }
  if (g.L <= 208) {
    return launch_bwd_kc<float, 13, true, false, true, kHasMask>(
        q, nullptr, s, bi, m, d, dq, nullptr, pb, ps, g, images_per_block, st);
  }
  return launch_bwd_kc<float, 16, true, false, true, kHasMask>(
      q, nullptr, s, bi, m, d, dq, nullptr, pb, ps, g, images_per_block, st);
}

cudaError_t dispatch(int dtype, const void* qkv, const void* scale, const void* bias,
                     const void* mask, const void* dout, void* dqkv, void* pbias, void* pscale,
                     void* stats, void* work, const Geometry& g, int images_per_block,
                     cudaStream_t st) {
  const bool masked = mask != nullptr;
  if (route_of(dtype, g.ws) == kRouteMma) {
    // the cosine mode of the tensor-core passes: <kCosine, kShifted, kHasBias, kGlobal>
    return masked ? swin_mma::launch<true, true, true, false>(
                        qkv, nullptr, scale, bias, mask, dout, dqkv, nullptr, pbias, pscale,
                        stats, work, g, images_per_block, st)
                  : swin_mma::launch<true, false, true, false>(
                        qkv, nullptr, scale, bias, mask, dout, dqkv, nullptr, pbias, pscale,
                        stats, work, g, images_per_block, st);
  }
  return masked ? launch_f32<true>(qkv, scale, bias, mask, dout, dqkv, pbias, pscale, g,
                                   images_per_block, st)
                : launch_f32<false>(qkv, scale, bias, mask, dout, dqkv, pbias, pscale, g,
                                    images_per_block, st);
}

}  // namespace

// The route a launch of this dtype (0 = float32, 1 = bfloat16) and window
// side takes: 0 the templates, 1 the key-tiled kernel, 2 the tensor-core
// kernel.
extern "C" int swin_attention_bwd_route(int dtype, int ws) { return route_of(dtype, ws); }

// dtype: 0 = float32, 1 = bfloat16. mask may be null (unshifted blocks).
// Scratch: partial_bias (slots, H, L, L) f32 with slots = nW * ceil(B /
// images_per_block); partial_scale (scale_slots, H) f32, scale_slots = slots
// in f32 and slots * ceil(L / 64) in bf16; in bf16 only, row_stats (3, B, H,
// nW, L) f32 and work (f32: the shifted blocks' bias + mask (nW, H, L, L),
// padded to 16 bytes, then 1 / |k| (B, Hp, Wp, H)), null otherwise.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int swin_attention_bwd(const void* qkv, const void* scale, const void* bias,
                                  const void* mask, const void* dout, void* dqkv, void* dbias,
                                  void* dscale, void* partial_bias, void* partial_scale,
                                  void* row_stats, void* work, int dtype, int B, int Hp,
                                  int Wp, int C,
                                  int nheads, int ws, int images_per_block, void* stream) {
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws, kMaxLTiled) || images_per_block < 1 ||
      bias == nullptr || nheads > 65535 || (B + images_per_block - 1) / images_per_block > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slots = g.nW * ((B + images_per_block - 1) / images_per_block);
  const int scale_slots =
      dtype == 1 ? slots * ((g.L + swin_mma::kTile - 1) / swin_mma::kTile) : slots;
  const cudaError_t err =
      dispatch(dtype, qkv, scale, bias, mask, dout, dqkv, partial_bias, partial_scale, row_stats,
               work, g, images_per_block, st);
  if (err != cudaSuccess) return (int)err;
  const int n = nheads * g.L * g.L;
  swin_attention_bwd_reduce<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial_bias), static_cast<const float*>(partial_scale),
      static_cast<float*>(dbias), static_cast<float*>(dscale), slots, scale_slots, nheads, n);
  return (int)cudaGetLastError();
}
