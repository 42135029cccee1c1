// Plain (scaled dot-product) window attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel torchok_tpu/ops/swin_attention.py::_fwd_kernel
// in its cosine=False mode (reached through _fwd_pallas and the public
// fused_window_attention; DaViT spatial blocks without a bias, GCViT local
// blocks with the learned relative position bias). Contract:
//   qkv (B, Hp, Wp, 3C) bf16|f32, scale (H,) f32, bias (H, L, L) f32 or null
//   ->  out (B, Hp, Wp, C) in qkv's dtype,
//   out = softmax(q k^T * scale_h + bias_h) v per window of ws x ws tokens and head.
// The TPU version is fed pre-partitioned windows for ws 7 and 14 because its
// compiler cannot relayout a 7-row sublane; here the window's pixel addresses
// are computed in the kernel for any ws up to 16, so no partition or reverse
// copy runs on the card.
//
// Rounding points follow the Pallas kernel: q and k enter the product as they
// come (no normalisation) with f32 accumulation; scale, bias and softmax in
// f32; the weights are rounded to the input dtype before a v, which
// accumulates in f32; the output is rounded to the input dtype. Without a
// bias none is read and no zero bias is invented.
//
// What bounds it: like the SwinV2 kernels it moves 8 bytes per token and
// channel in bf16 and does 4*L*32 FLOPs per token and head in f32 FMAs fed
// from shared memory, so shared-memory bandwidth inside the block limits it,
// far below the device-memory bound. mma.sync / wgmma and TMA are later work.
// The kernel itself is in window_attention_fwd.cuh (shared with the
// global-query forward).
#include "window_attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no-bias mode).
// Returns the first CUDA error of the launch (0 on success).
extern "C" int window_attention_fwd(const void* qkv, const void* scale, const void* bias,
                                    void* out, int dtype, int B, int Hp, int Wp, int C,
                                    int nheads, int ws, void* stream) {
  using namespace wattn;
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_bias = bias != nullptr;
  if (dtype == 0) {
    return (int)(has_bias ? launch_fwd<float, true, false>(qkv, nullptr, scale, bias, nullptr, out, g, st)
                          : launch_fwd<float, false, false>(qkv, nullptr, scale, bias, nullptr, out, g, st));
  }
  if (dtype == 1) {
    return (int)(has_bias
                     ? launch_fwd<__nv_bfloat16, true, false>(qkv, nullptr, scale, bias, nullptr, out, g, st)
                     : launch_fwd<__nv_bfloat16, false, false>(qkv, nullptr, scale, bias, nullptr, out, g, st));
  }
  return (int)cudaErrorInvalidValue;
}
