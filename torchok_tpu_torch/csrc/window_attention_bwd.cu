// Plain (scaled dot-product) window attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel torchok_tpu/ops/swin_attention.py::_bwd_kernel
// in its cosine=False mode (reached through _bwd_pallas and the custom_vjp of
// fused_window_attention). Contract:
//   qkv (B, Hp, Wp, 3C) bf16|f32, scale (H,) f32, bias (H, L, L) f32 or null,
//   dout (B, Hp, Wp, C) in qkv's dtype
//   ->  dqkv (B, Hp, Wp, 3C) in qkv's dtype and, with a bias, dbias (H, L, L)
//       f32 summed over images and windows. No dscale: the scale is a constant.
// Without a bias none is read, no dbias is written and no reduction runs.
//
// Rounding points follow the Pallas kernel: dl in f32, dls = T(dl scale)
// before the two products with it, dbias from the f32 dl, dqkv rounded to T.
//
// What bounds it: it reads qkv and dout and writes dqkv once (14 bytes per
// token and channel in bf16) and does 10*L*32 FLOPs per token and head in f32
// FMAs fed from shared memory: shared-memory bandwidth inside the block limits
// it, far below the device-memory bound. The kernel, its design and the
// deterministic dbias sum are in window_attention_bwd.cuh (shared with the
// global-query backward).
#include "window_attention_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. bias, dbias and partial are null together
// (no-bias mode). partial is scratch of (nW * ceil(B / images_per_block), H, L, L)
// f32. Returns the first CUDA error of the launches (0 on success).
extern "C" int window_attention_bwd(const void* qkv, const void* scale, const void* bias,
                                    const void* dout, void* dqkv, void* dbias, void* partial,
                                    int dtype, int B, int Hp, int Wp, int C, int nheads, int ws,
                                    int images_per_block, void* stream) {
  using namespace wattn;
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws)) return (int)cudaErrorInvalidValue;
  const bool has_bias = bias != nullptr;
  if (has_bias != (dbias != nullptr) || has_bias != (partial != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(has_bias ? launch_bwd<float, true, false>(qkv, nullptr, scale, bias, dout, dqkv,
                                                           nullptr, dbias, partial, g,
                                                           images_per_block, st)
                          : launch_bwd<float, false, false>(qkv, nullptr, scale, bias, dout, dqkv,
                                                            nullptr, dbias, partial, g,
                                                            images_per_block, st));
  }
  if (dtype == 1) {
    return (int)(has_bias
                     ? launch_bwd<__nv_bfloat16, true, false>(qkv, nullptr, scale, bias, dout,
                                                              dqkv, nullptr, dbias, partial, g,
                                                              images_per_block, st)
                     : launch_bwd<__nv_bfloat16, false, false>(qkv, nullptr, scale, bias, dout,
                                                               dqkv, nullptr, dbias, partial, g,
                                                               images_per_block, st));
  }
  return (int)cudaErrorInvalidValue;
}
