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
// The kernel is the cosine mode of the window attention backward templates:
// up to L = 256 window_attention_bwd.cuh (one block per window position and
// head over a slice of the images, all keys in shared memory, dk/dv in
// registers, dl summed into a per-block slab; at L <= 64 the dl sums stay in
// registers across the images), above it the key-tiled kernel of
// window_attention_tiled.cuh (row statistics first, then key tile by key
// tile). At L = 64 exactly (ws 8) the first SwinV2 backward kernel, in
// swin_attention_bwd_ws8.cuh, runs instead: it is faster there (PERF.md).
// All write one (L, L) dbias slab and one dscale slot per block;
// swin_attention_bwd_reduce adds them in slot order, so the results are
// bit-identical from run to run (no atomics).
//
// What bounds it: it reads qkv and dout and writes dqkv once (14 bytes per
// token and channel in bf16) and does 10*L*32 FLOPs per token and head (14*L*32
// on the key-tiled path) in f32 FMAs fed from shared memory, far below the
// tensor-core ridge: shared-memory bandwidth inside the block limits it.
#include "swin_attention_bwd_ws8.cuh"
#include "window_attention_bwd.cuh"
#include "window_attention_tiled.cuh"

namespace {

using namespace wattn;

// Adds the per-block slabs and dscale slots in slot order.
__global__ void swin_attention_bwd_reduce(const float* __restrict__ partial_bias,
                                          const float* __restrict__ partial_scale,
                                          float* __restrict__ dbias, float* __restrict__ dscale,
                                          int slots, int nheads, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) {
    float total = 0.f;
    for (int p = 0; p < slots; ++p) total += partial_bias[(size_t)p * n + idx];
    dbias[idx] = total;
  }
  if (idx < nheads) {
    float total = 0.f;
    for (int p = 0; p < slots; ++p) total += partial_scale[(size_t)p * nheads + idx];
    dscale[idx] = total;
  }
}

template <typename T, bool kHasMask>
cudaError_t launch(const void* qkv, const void* scale, const void* bias, const void* mask,
                   const void* dout, void* dqkv, void* pbias, void* pscale, const Geometry& g,
                   int images_per_block, cudaStream_t st) {
  const T* q = static_cast<const T*>(qkv);
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  const T* d = static_cast<const T*>(dout);
  T* dq = static_cast<T*>(dqkv);
  float* pb = static_cast<float*>(pbias);
  float* ps = static_cast<float*>(pscale);
  if (g.ws == swin8::kWs) {
    return swin8::launch_one<T, kHasMask>(q, s, bi, m, d, dq, pb, ps, g.B, g.Hp, g.Wp, g.C,
                                          g.nheads, images_per_block, st);
  }
  if (g.L <= 64) {
    return launch_bwd_kc<T, 4, true, false, true, kHasMask>(q, nullptr, s, bi, m, d, dq, nullptr,
                                                            pb, ps, g, images_per_block, st);
  }
  if (g.L <= 208) {
    return launch_bwd_kc<T, 13, true, false, true, kHasMask>(q, nullptr, s, bi, m, d, dq, nullptr,
                                                             pb, ps, g, images_per_block, st);
  }
  if (g.L <= kMaxL) {
    return launch_bwd_kc<T, 16, true, false, true, kHasMask>(q, nullptr, s, bi, m, d, dq, nullptr,
                                                             pb, ps, g, images_per_block, st);
  }
  return launch_bwd_tiled<T, kHasMask>(qkv, scale, bias, mask, dout, dqkv, pbias,
                                                   pscale, g, images_per_block, st);
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* scale, const void* bias, const void* mask,
                     const void* dout, void* dqkv, void* pbias, void* pscale, const Geometry& g,
                     int images_per_block, cudaStream_t st) {
  return mask != nullptr
             ? launch<T, true>(qkv, scale, bias, mask, dout, dqkv, pbias, pscale, g,
                               images_per_block, st)
             : launch<T, false>(qkv, scale, bias, mask, dout, dqkv, pbias, pscale, g,
                                images_per_block, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null (unshifted blocks).
// partial_bias holds (slots, H, L, L) f32 and partial_scale (slots, H) f32
// with slots = nW * ceil(B / images_per_block); both are scratch.
// Returns the first CUDA error of the two launches (0 on success).
extern "C" int swin_attention_bwd(const void* qkv, const void* scale, const void* bias,
                                  const void* mask, const void* dout, void* dqkv, void* dbias,
                                  void* dscale, void* partial_bias, void* partial_scale,
                                  int dtype, int B, int Hp, int Wp, int C, int nheads, int ws,
                                  int images_per_block, void* stream) {
  Geometry g;
  if (!make_geometry(&g, B, Hp, Wp, C, nheads, ws, kMaxLTiled) || images_per_block < 1 ||
      bias == nullptr || nheads > 65535 || (B + images_per_block - 1) / images_per_block > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(qkv, scale, bias, mask, dout, dqkv, partial_bias, partial_scale, g,
                          images_per_block, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(qkv, scale, bias, mask, dout, dqkv, partial_bias,
                                  partial_scale, g, images_per_block, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int slots = g.nW * ((B + images_per_block - 1) / images_per_block);
  const int n = nheads * g.L * g.L;
  swin_attention_bwd_reduce<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial_bias), static_cast<const float*>(partial_scale),
      static_cast<float*>(dbias), static_cast<float*>(dscale), slots, nheads, n);
  return (int)cudaGetLastError();
}
