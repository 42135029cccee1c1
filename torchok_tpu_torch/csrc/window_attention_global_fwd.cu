// GCViT global-query window attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// torchok_tpu/ops/swin_attention.py::_fwd_kernel_global (reached through
// _fwd_pallas_global and the public fused_window_attention_global). Contract:
//   kv (B, Hp, Wp, 2C) bf16|f32, qg (B, L, C) in kv's dtype, scale (H,) f32,
//   bias (H, L, L) f32  ->  out (B, Hp, Wp, C) in kv's dtype,
//   out = softmax(qg k^T * scale_h + bias_h) v for every window of the image:
// all windows of an image attend with that image's L shared queries, which are
// read from qg by each block and never repeated per window in device memory.
// The TPU version takes pre-partitioned (B, nW, L, 2C) windows; here kv stays
// on the spatial layout and the kernel computes the pixel addresses.
//
// Rounding points as in window_attention_fwd.cu (the caller casts qg to kv's
// dtype, as the Pallas kernel does before the product). The kernel is the
// kGlobal = true instantiation of window_attention_fwd.cuh; what bounds it is
// said there and in window_attention_fwd.cu.
#include "window_attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. Returns the first CUDA error (0 on success).
extern "C" int window_attention_global_fwd(const void* kv, const void* qg, const void* scale,
                                           const void* bias, void* out, int dtype, int B, int Hp,
                                           int Wp, int C, int nheads, int ws, void* stream) {
  using namespace wattn;
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws) || bias == nullptr || qg == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd<float, true, true>(kv, qg, scale, bias, nullptr, out, g, st);
  if (dtype == 1) return (int)launch_fwd<__nv_bfloat16, true, true>(kv, qg, scale, bias, nullptr, out, g, st);
  return (int)cudaErrorInvalidValue;
}
