// GCViT global-query window attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// torchok_tpu/ops/swin_attention.py::_bwd_kernel_global (reached through
// _bwd_pallas_global and the custom_vjp of fused_window_attention_global).
// Contract:
//   kv (B, Hp, Wp, 2C) bf16|f32, qg (B, L, C) in kv's dtype, scale (H,) f32,
//   bias (H, L, L) f32, dout (B, Hp, Wp, C) in kv's dtype
//   ->  dkv (B, Hp, Wp, 2C) in kv's dtype, dqg (B, L, C) f32 summed over the
//       image's windows, dbias (H, L, L) f32 summed over images and windows.
// dqg leaves the kernel in f32; the caller casts it to the queries' dtype.
//
// The Pallas kernel adds dqg into a block revisited over the image's window
// groups; here one block owns (head, slice of images), loops over each image's
// windows and adds their dq into dqg itself, in window order, so the sum is
// deterministic without atomics. With 64 windows per image (stage 1 of GCViT)
// that is 2 heads x 128 images = 256 blocks of 64 windows each; with one
// window per image (stages 3 and 4) the images are sliced so that about four
// blocks per SM run. Rounding points, the dbias slabs and what bounds the
// kernel are as in window_attention_bwd.cu; the kernel is the kGlobal = true
// instantiation of window_attention_bwd.cuh.
#include "window_attention_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. partial is scratch of
// (ceil(B / images_per_block), H, L, L) f32. Returns the first CUDA error of
// the launches (0 on success).
extern "C" int window_attention_global_bwd(const void* kv, const void* qg, const void* scale,
                                           const void* bias, const void* dout, void* dkv,
                                           void* dqg, void* dbias, void* partial, int dtype,
                                           int B, int Hp, int Wp, int C, int nheads, int ws,
                                           int images_per_block, void* stream) {
  using namespace wattn;
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws) || qg == nullptr || bias == nullptr ||
      dqg == nullptr || dbias == nullptr || partial == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_bwd<float, true, true>(kv, qg, scale, bias, dout, dkv, dqg, dbias, partial,
                                              g, images_per_block, st);
  }
  if (dtype == 1) {
    return (int)launch_bwd<__nv_bfloat16, true, true>(kv, qg, scale, bias, dout, dkv, dqg, dbias,
                                                      partial, g, images_per_block, st);
  }
  return (int)cudaErrorInvalidValue;
}
