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
// The kernel is the cosine mode (kCosine, kHasMask) of the window attention
// templates that also serve GCViT and DaViT: up to L = 256 the register-tile
// kernel of window_attention_fwd.cuh (all keys of a window in one block; 4,
// 13 or 16 key columns a thread), above it the key-tiled kernel of
// window_attention_tiled.cuh (two passes over tiles of 64 keys: online max
// and sum, then the rounded weights against v). The Pallas kernel's VMEM
// gate, which sends L = 576 to an XLA formulation on the TPU, has no
// counterpart: every L runs here.
//
// What bounds it: it moves qkv in and the output out (8 bytes per token and
// channel in bf16) and does 4*L*32 FLOPs per token and head (6*L*32 on the
// key-tiled path, which computes QK^T twice) in f32 FMAs fed from shared
// memory, so it sits far below the tensor-core ridge and shared-memory
// bandwidth inside the block limits it, not device memory.
#include "window_attention_fwd.cuh"
#include "window_attention_tiled.cuh"

namespace {

using namespace wattn;

template <typename T>
cudaError_t dispatch(const void* qkv, const void* scale, const void* bias, const void* mask,
                     void* out, const Geometry& g, cudaStream_t st) {
  const bool masked = mask != nullptr;
  if (g.L <= kMaxL) {
    return masked ? launch_fwd<T, true, false, true, true>(qkv, nullptr, scale, bias, mask, out,
                                                           g, st)
                  : launch_fwd<T, true, false, true, false>(qkv, nullptr, scale, bias, mask, out,
                                                            g, st);
  }
  return masked ? launch_fwd_tiled<T, true>(qkv, scale, bias, mask, out, g, st)
                : launch_fwd_tiled<T, false>(qkv, scale, bias, mask, out, g, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null (unshifted blocks).
// Returns the launch's CUDA error (0 on success).
extern "C" int swin_attention_fwd(const void* qkv, const void* scale, const void* bias,
                                  const void* mask, void* out, int dtype, int B, int Hp,
                                  int Wp, int C, int nheads, int ws, void* stream) {
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws, kMaxLTiled) || bias == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(qkv, scale, bias, mask, out, g, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(qkv, scale, bias, mask, out, g, st);
  return (int)cudaErrorInvalidValue;
}
