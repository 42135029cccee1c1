// GCViT global-query window attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// torchok_tpu/ops/swin_attention.py::_fwd_kernel_global (reached through
// _fwd_pallas_global and the public fused_window_attention_global). Contract:
//   kv (B, Hp, Wp, 2C) bf16|f32, qg (B, L, C) in kv's dtype, scale (H,) f32,
//   bias (H, L, L) f32  ->  out (B, Hp, Wp, C) in kv's dtype,
//   out = softmax(qg k^T * scale_h + bias_h) v for every window of the image:
// all windows of an image attend with that image's L shared queries, which are
// never repeated per window in device memory. The TPU version takes
// pre-partitioned (B, nW, L, 2C) windows; here kv stays on the spatial layout
// and the kernel computes the pixel addresses.
//
// Rounding points as in window_attention_fwd.cu (the caller casts qg to kv's
// dtype, as the Pallas kernel does before the product). Routing
// (window_attention_global_fwd_route, which the entry follows):
//  * bf16: the global-query mode of the tensor-core forward of
//    swin_attention_fwd_mma.cuh at every ws <= 16. With one key tile (L <=
//    64: GCViT's stages 1, 2 and 4) global_fwd_kernel has a block per (slice
//    of an image's windows, head, image) that loads the image's q tile and
//    the head's bias tile once, keeps q as mma operands in registers and
//    walks its windows in order, one QK^T each for the statistics, bf16(a32)
//    and PV, the next window's k, v and pixel table loading meanwhile; the
//    slices are sized on the host so that stage 1 (64 windows, 2 heads, bs
//    128) fills the card (windows_per_block). Above it (L = 196, stage 3: one
//    window) it is the local mode with q from qg: a block per (window, query
//    tile, head, two images), the key tiles walked twice. The walk loads its
//    bias tile once, 4 bytes a thread from the unpadded rows of L = 49, so
//    no pad_bias runs. Bounded like the local mode by its loads' latency
//    and softmax arithmetic (PERF.md).
//  * f32: the kGlobal = true instantiation of the FMA template of
//    window_attention_fwd.cuh: a block per (window, query tile, head, image)
//    reads the image's queries from qg again, bounded by shared-memory
//    bandwidth inside the block.
// The least traffic: kv and qg read and the output written once.
#include "swin_attention_fwd_mma.cuh"
#include "window_attention_fwd.cuh"

// The route a launch of this dtype (0 = float32, 1 = bfloat16) takes: 0 the
// FMA template, 1 the tensor-core kernel (at every window size).
extern "C" int window_attention_global_fwd_route(int dtype) { return dtype == 1 ? 1 : 0; }

// dtype: 0 = float32, 1 = bfloat16. bf16 only: work (H, L, L rounded up to
// 4) f32 scratch when L > 64 is not a multiple of 4 (none of GCViT's
// windows), null otherwise; windows_per_block, the windows a block walks at
// L <= 64. Returns the first CUDA error (0 on success).
extern "C" int window_attention_global_fwd(const void* kv, const void* qg, const void* scale,
                                           const void* bias, void* out, void* work, int dtype,
                                           int B, int Hp, int Wp, int C, int nheads, int ws,
                                           int windows_per_block, void* stream) {
  using namespace wattn;
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws) || bias == nullptr || qg == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_fwd<float, true, true>(kv, qg, scale, bias, nullptr, out, g, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)swin_fwd::launch_plain<true, true>(kv, qg, scale, bias, out, work, g,
                                                 windows_per_block, st);
}
