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
// Routing (window_attention_fwd_route, which the entry follows):
//  * bf16: the plain local mode of the tensor-core forward of
//    swin_attention_fwd_mma.cuh (K1's kernel on mma.sync with ldmatrix and
//    cp.async tiles; swin_fwd_kernel<., 2, false, bias?, false>), a block
//    per (window position, query tile, head, two images), at every ws <= 16.
//    With one key tile (L <= 64: DaViT, GCViT's stages 1, 2 and 4) one QK^T
//    held in registers gives the statistics, bf16(a32) and PV; at L = 196 the
//    key tiles are walked twice (statistics, then PV). At L = 49 pad_bias
//    first copies the bias into rows of 52 floats so its tiles load 16 bytes
//    a thread. Per padded logit it does 2 * 64 FLOPs on the tensor cores, one
//    exponential and some ten f32 instructions a thread, with the q, k, v and
//    bias tiles moved from L2 into shared memory: its loads' latency and the
//    softmax arithmetic bound it, not the tensor cores or device memory
//    (PERF.md).
//  * f32: the FMA template of window_attention_fwd.cuh (shared with the
//    global-query forward and with the cosine mode's f32 launches): one
//    block per (window, 64-row query tile, head, image) with all keys of the
//    window in shared memory and 4*L*32 FLOPs per token and head in f32 FMAs
//    fed from it, so shared-memory bandwidth inside the block bounds it, far
//    below the device-memory bound.
// The least traffic: qkv read and the output written once (8 bytes per token
// and channel in bf16).
#include "swin_attention_fwd_mma.cuh"
#include "window_attention_fwd.cuh"

// The route a launch of this dtype (0 = float32, 1 = bfloat16) takes: 0 the
// FMA template, 1 the tensor-core kernel (at every window size).
extern "C" int window_attention_fwd_route(int dtype) { return dtype == 1 ? 1 : 0; }

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no-bias mode). bf16
// only: work (H, L, L rounded up to 4) f32 scratch when there is a bias and L
// is not a multiple of 4, null otherwise. Returns the first CUDA error of the
// launches (0 on success).
extern "C" int window_attention_fwd(const void* qkv, const void* scale, const void* bias,
                                    void* out, void* work, int dtype, int B, int Hp, int Wp,
                                    int C, int nheads, int ws, void* stream) {
  using namespace wattn;
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_bias = bias != nullptr;
  if (dtype == 0) {
    return (int)(has_bias ? launch_fwd<float, true, false>(qkv, nullptr, scale, bias, nullptr,
                                                          out, g, st)
                          : launch_fwd<float, false, false>(qkv, nullptr, scale, bias, nullptr,
                                                           out, g, st));
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // <kHasBias, kGlobal>
  return (int)(has_bias
                   ? swin_fwd::launch_plain<true, false>(qkv, nullptr, scale, bias, out, work, g,
                                                         1, st)
                   : swin_fwd::launch_plain<false, false>(qkv, nullptr, scale, nullptr, out,
                                                          nullptr, g, 1, st));
}
