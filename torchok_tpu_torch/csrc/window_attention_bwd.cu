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
// Routing (window_attention_bwd_route, which the entry follows):
//  * bf16: the plain local mode of the tensor-core kernel of
//    swin_attention_bwd_mma.cuh (K2's two passes on mma.sync: row statistics
//    and dq; dk, dv and the dbias columns), at every ws <= 16. Its
//    exponentials and f32 softmax arithmetic bound it, not its products or
//    device memory (PERF.md).
//  * f32: the FMA template of window_attention_bwd.cuh (shared with the
//    global-query backward): 10*L*32 FLOPs per token and head in f32 FMAs
//    fed from shared memory, bounded by shared-memory bandwidth inside the
//    block.
// Both write per-block dbias slabs that window_attention_bwd_reduce adds in
// slot order, so the results are bit-identical from run to run (no atomics).
// The least traffic: qkv and dout read and dqkv written once (14 bytes per
// token and channel in bf16).
#include "swin_attention_bwd_mma.cuh"
#include "window_attention_bwd.cuh"

// The route a launch of this dtype (0 = float32, 1 = bfloat16) takes: 0 the
// FMA template, 1 the tensor-core kernel (at every window size).
extern "C" int window_attention_bwd_route(int dtype) { return dtype == 1 ? 1 : 0; }

// dtype: 0 = float32, 1 = bfloat16. bias, dbias and partial are null together
// (no-bias mode). partial is scratch of (nW * ceil(B / images_per_block), H,
// L, L) f32. bf16 only: row_stats (3, B, H, nW, L) f32 and, with a bias and
// L not a multiple of 4, work (H, L, L rounded up to 4) f32; null otherwise.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int window_attention_bwd(const void* qkv, const void* scale, const void* bias,
                                    const void* dout, void* dqkv, void* dbias, void* partial,
                                    void* row_stats, void* work, int dtype, int B, int Hp,
                                    int Wp, int C, int nheads, int ws, int images_per_block,
                                    void* stream) {
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // <kCosine, kShifted, kHasBias, kGlobal>
  cudaError_t err =
      has_bias ? swin_mma::launch<false, false, true, false>(
                     qkv, nullptr, scale, bias, nullptr, dout, dqkv, nullptr, partial, nullptr,
                     row_stats, work, g, images_per_block, st)
               : swin_mma::launch<false, false, false, false>(
                     qkv, nullptr, scale, nullptr, nullptr, dout, dqkv, nullptr, nullptr, nullptr,
                     row_stats, work, g, images_per_block, st);
  if (err != cudaSuccess || !has_bias) return (int)err;
  const int slots = g.nW * ((B + images_per_block - 1) / images_per_block);
  const int n = nheads * g.L * g.L;
  window_attention_bwd_reduce<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dbias), slots, n);
  return (int)cudaGetLastError();
}
