#!/usr/bin/env python
"""Where K6's bf16 tensor-core forward (``csrc/window_attention_mw_mma.cuh``)
spends its time: ``window_attention_mw_fwd`` built once as it is and once
without each phase, side by side with the package's nvcc flags, and timed
at swinv2_tiny's stage shapes (masked and unmasked) in bf16 at batch 128 in
turns (the builds in order, then in reverse; the mean of the two medians of
20 CUDA-event timings), with the sums over the 12 blocks of a forward.

A phase is left out by editing a copy of the sources under
``build/wmw_variants/<build>/`` (each edit must match its text exactly
once): ``no_qkv_loads`` issues no q, k, v loads after the first step (the
products then read whatever the ring holds), ``no_tile_loads`` no bias and
mask tile loads, ``no_norms`` takes rq = rk = 1 (no squares, no shuffles
for them), ``no_lo`` drops the second (lo) PV product, ``no_exp`` replaces
the exponentials by a subtraction. The outputs of a build without a phase
are wrong by design: only its time means anything. Two builds change the
design instead of leaving a phase out: ``rk_shared`` (the keys' inverse
norms once a step into shared memory, behind a second barrier),
``loop_loads`` (the ring loads as a loop over the block's 16-byte parts)
and ``bias_mask_sum`` (the mask added into the bias tile once a block).

    python tools/time_window_mw_variants.py [build ...]   # default: every build
"""
import ctypes
import os
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "window_attention_mw_mma.cuh"
EDITS = {
    "base": [],
    "no_qkv_loads": [("      load_step(cur ^ 1, step + 1);\n", "")],
    "no_tile_loads": [("  load_tile<L>(tb, bias + (size_t)h * L * L);\n"
                       "  if (kHasMask) load_tile<L>(tm, mask + (size_t)w * L * L);\n", "")],
    "no_norms": [("    qs[r] = rsqrtf(qs[r] + kNormEps) * s;", "    qs[r] = s;"),
                 ("      for (int e = 0; e < 2; ++e) rk[2 * p + i][e] = __shfl_sync(0xffffffffu, "
                  "rn, 4 * (2 * tc + e));",
                  "      for (int e = 0; e < 2; ++e) rk[2 * p + i][e] = 1.f;")],
    "no_lo": [("      mma16816(acc[2 * nc], lo, f[0], f[1]);\n"
               "      mma16816(acc[2 * nc + 1], lo, f[2], f[3]);\n", "")],
    "no_exp": [("      sc[n][e] = exp_minus(sc[n][e], m2[e >> 1]);",
                "      sc[n][e] = sc[n][e] - m2[e >> 1];")],
    # not phases: rk of the step's keys once a block into shared memory (a
    # warp its 16 keys, two lanes a key) behind a second barrier a step,
    # instead of every warp deriving all of them from its B fragments
    "rk_shared": [
        ("constexpr float kLn100 = 4.605170185988092f;\n",
         "constexpr float kLn100 = 4.605170185988092f;\n__shared__ float srk[kRingRows];\n"),
        ("#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n        const float2 x = "
         "unpack_bf16(fx[i]);\n        ss[i >> 1] = fmaf(x.y, x.y, fmaf(x.x, x.x, "
         "ss[i >> 1]));\n      }\n", ""),
        ("      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 1);\n"
         "      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 2);\n"
         "      const float rn = rsqrtf(ss[i] + kNormEps);  // key 16 p + 8 i + gr\n"
         "#pragma unroll\n"
         "      for (int e = 0; e < 2; ++e) rk[2 * p + i][e] = __shfl_sync(0xffffffffu, rn, "
         "4 * (2 * tc + e));\n",
         "      const float2 r2 = *reinterpret_cast<const float2*>(srk + ((threadIdx.x >> 5) / "
         "(L / 16)) * L + 16 * p + 8 * i + 2 * tc);\n"
         "      rk[2 * p + i][0] = r2.x;\n      rk[2 * p + i][1] = r2.y;\n"),
        ("    const int j = step * kWindowsPerStep + slot;\n    if (j < nwin) {\n",
         "    const int j = step * kWindowsPerStep + slot;\n    {\n"
         "      const int key = r0 + (threadIdx.x & 31) / 2, hf = threadIdx.x & 1;\n"
         "      const bf16* kr = ring + cur * kStage + kRingRows * kRow + (slot * L + key) * kRow"
         " + 16 * hf;\n      float ss = 0.f;\n"
         "      for (int c = 0; c < 2; ++c) {\n"
         "        const uint4 raw = *reinterpret_cast<const uint4*>(kr + 8 * c);\n"
         "        const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};\n"
         "        for (int i = 0; i < 4; ++i) {\n"
         "          const float2 x = unpack_bf16(w4[i]);\n"
         "          ss = fmaf(x.y, x.y, fmaf(x.x, x.x, ss));\n        }\n      }\n"
         "      ss += __shfl_xor_sync(0xffffffffu, ss, 1);\n"
         "      if (hf == 0) srk[slot * L + key] = rsqrtf(ss + kNormEps);\n    }\n"
         "    __syncthreads();\n    if (j < nwin) {\n")],
    # the ring loads as a loop over the block's 768 16-byte parts, each
    # thread working out its part's row and tensor (the first build's loads)
    "loop_loads": [
        ("    const int part = threadIdx.x & 3;\n#pragma unroll\n"
         "    for (int half = 0; half < 2; ++half) {\n"
         "      const int row = (threadIdx.x >> 2) + half * (kThreads / 4);\n"
         "      const int j = step * kWindowsPerStep + row / L;\n      if (j < nwin) {\n"
         "        const size_t src = slab_of(j) + (size_t)(row % L) * kD + part * 8;\n"
         "        bf16* dst = ring + st * kStage + row * kRow + part * 8;\n"
         "        cp_async16(dst, q + src, true);\n"
         "        cp_async16(dst + kRingRows * kRow, k + src, true);\n"
         "        cp_async16(dst + 2 * kRingRows * kRow, v + src, true);\n      }\n    }\n",
         "    for (int idx = threadIdx.x; idx < 3 * kRingRows * 4; idx += kThreads) {\n"
         "      const int part = idx & 3;\n      const int row = (idx >> 2) % kRingRows;\n"
         "      const int which = (idx >> 2) / kRingRows;\n"
         "      const int j = step * kWindowsPerStep + row / L;\n      if (j < nwin) {\n"
         "        const bf16* src = which == 0 ? q : which == 1 ? k : v;\n"
         "        cp_async16(ring + st * kStage + (which * kRingRows + row) * kRow + part * 8,\n"
         "                   src + slab_of(j) + (size_t)(row % L) * kD + part * 8, true);\n"
         "      }\n    }\n")],
    # the mask added to the bias tile once a block, one tile read a logit
    # (not the plain version's order of the additions)
    "bias_mask_sum": [
        ("  cp_async_wait_all();\n  __syncthreads();\n  const int steps",
         "  cp_async_wait_all();\n  __syncthreads();\n  if (kHasMask) {\n"
         "    for (int idx = threadIdx.x; idx < L * L; idx += kThreads) tb[idx] += tm[idx];\n"
         "    __syncthreads();\n  }\n  const int steps"),
        ("      if (kHasMask) {\n        const float2 mv", "      if (false) {\n        const float2 mv")],
}
BATCH = 128


def main():
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from torchok_tpu_torch.ops import window_attention as wa
    names = ["base"] + [n for n in sys.argv[1:] if n != "base"] if sys.argv[1:] else list(EDITS)
    edits = {name: EDITS[name] for name in names}
    print(cs.card_line(), flush=True)
    bwd_variants = cs.load_tool("time_window_bwd_variants")  # its build()
    out_dir = os.path.join(REPO, "build", "wmw_variants")
    with ThreadPoolExecutor(len(edits)) as pool:
        built = list(pool.map(lambda name: bwd_variants.build(
            name, out_dir, edits, HEADER, (wa.KERNEL,)), edits))
    functions = {}
    for name, libs, regs in built:
        print(f"{name}: registers {regs}", flush=True)
        fn = getattr(ctypes.CDLL(libs[wa.KERNEL]), wa.KERNEL)
        fn.argtypes = wa._ARGTYPES
        fn.restype = ctypes.c_int
        functions[name] = fn
    real = wa._function
    sums = {name: 0.0 for name in edits}
    for stage, (hp, wp, c, heads), masked, n in cs.shape_cases(BATCH):
        nw = (hp // 8) * (wp // 8)
        args = cs.mw_inputs(BATCH * nw, heads, nw if masked else 0, torch.bfloat16, 30 + stage)
        times = {}
        for order in (names, names[::-1]):
            for name in order:
                wa._function = lambda _name=name: functions[_name]
                times.setdefault(name, []).append(
                    cs.median_ms(lambda: wa.window_attention_mw_cuda(*args)))
        wa._function = real
        base = statistics.mean(times["base"])
        for name, t in times.items():
            sums[name] += n * statistics.mean(t)
        print(f"K6 bf16 stage{stage} q=({BATCH * nw},{heads},64,32) mask={masked} x{n}: "
              + ", ".join(f"{name} {statistics.mean(t):.4f} ms (saves "
                          f"{base - statistics.mean(t):.4f})" for name, t in times.items()),
              flush=True)
        del args
    print("K6 bf16 SUM over the 12 blocks: " + ", ".join(
        f"{name} {t:.4f} ms (saves {sums['base'] - t:.4f})" for name, t in sums.items()),
        flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
