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
// groups; CUDA blocks run in no order, so here one block owns each image's
// dqg rows and adds their windows' dq in window order, in f32, with no
// atomics: the sum is bit-identical from run to run. Routing
// (window_attention_global_bwd_route, which the entry follows):
//  * bf16: the global-query mode of the tensor-core kernel of
//    swin_attention_bwd_mma.cuh at every ws <= 16. Its dq pass has a block
//    per (query tile, head, image) that walks the image's windows in order
//    with dq in registers (GCViT's stage 1: 2 heads x 128 images = 256
//    blocks of 64 windows each; stage 3: 4 tiles x 8 heads x 128 images);
//    its dk/dv pass a block per (window position, key tile, head, slice of
//    the images), the query tiles streamed from qg. dkv's channels are all
//    written by the second pass; dqg by the first.
//  * f32: the kGlobal = true instantiation of the FMA template of
//    window_attention_bwd.cuh: a block per (head, slice of the images) loops
//    over each image's windows and adds their dq into dqg itself (the first
//    window stores, later ones add).
// Rounding points, the dbias slabs and what bounds the kernels are as in
// window_attention_bwd.cu.
#include "swin_attention_bwd_mma.cuh"
#include "window_attention_bwd.cuh"

// The route a launch of this dtype (0 = float32, 1 = bfloat16) takes: 0 the
// FMA template, 1 the tensor-core kernel (at every window size).
extern "C" int window_attention_global_bwd_route(int dtype) { return dtype == 1 ? 1 : 0; }

// dtype: 0 = float32, 1 = bfloat16. partial is scratch of (ceil(B /
// images_per_block), H, L, L) f32 in f32 and (nW * ceil(B /
// images_per_block), H, L, L) in bf16. bf16 only: row_stats (3, B, H, nW, L)
// f32 and, where L is not a multiple of 4, work (H, L, L rounded up to 4)
// f32; null otherwise. Returns the first CUDA error of the launches (0 on
// success).
extern "C" int window_attention_global_bwd(const void* kv, const void* qg, const void* scale,
                                           const void* bias, const void* dout, void* dkv,
                                           void* dqg, void* dbias, void* partial,
                                           void* row_stats, void* work, int dtype, int B, int Hp,
                                           int Wp, int C, int nheads, int ws,
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // <kCosine, kShifted, kHasBias, kGlobal>
  const cudaError_t err = swin_mma::launch<false, false, true, true>(
      kv, qg, scale, bias, nullptr, dout, dkv, dqg, partial, nullptr, row_stats, work, g,
      images_per_block, st);
  if (err != cudaSuccess) return (int)err;
  const int slots = g.nW * ((B + images_per_block - 1) / images_per_block);
  const int n = nheads * g.L * g.L;
  window_attention_bwd_reduce<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dbias), slots, n);
  return (int)cudaGetLastError();
}
