#!/usr/bin/env python
"""Where the bf16 tensor-core forward spends its time in its plain-dot modes
(K3a, K4; ``csrc/swin_attention_fwd_mma.cuh``): the two entries built once
as they are and once without each phase, side by side with the package's
nvcc flags, and timed at gcvit_tiny's stage shapes (K3a with its bias, K4)
and davit_t's stage 1 (K3a without a bias) in bf16 at batch 128 in turns
(the builds in order, then in reverse; the mean of the two medians of 20
CUDA-event timings).

A phase is left out by editing a copy of the sources under
``build/wfwd_variants/<build>/`` (each edit must match its text exactly
once): ``no_kv_loads`` skips the k and v rows' loads of both kernels (the
products then read whatever shared memory holds), ``no_bias_loads`` the
bias tiles' loads, ``no_exp`` replaces the one-sweep path's exponentials by
a subtraction, ``no_pv`` replaces its PV product by one addition (the
softmax stays alive through it); ``bias_4byte`` (not a phase) skips
``pad_bias`` at L = 49, so K3a's bias tiles load 4 bytes a thread from the
unpadded rows, and ``walk_pad`` runs it for K4's window walk too, which
otherwise loads its one tile a slice unpadded (the tool then gives it the
scratch). At L = 196 ``no_statistics_sweep`` walks the key tiles once, for
the output only, and ``no_last_query_tile`` launches no block for the last
query tile of a single window (4 real rows of 64). The outputs of a build
without a phase are wrong by design: only its time means anything.

    python tools/time_window_fwd_variants.py
"""
import ctypes
import os
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "swin_attention_fwd_mma.cuh"
_KV_LOCAL = """        load_rows(sk + (st * kImages + i) * per, qkv + base * width, width,
                  (kGlobal ? 0 : C) + h * kD, spix, k0, tr, L);"""
_V_LOCAL = """      if (ntiles == 1 || step >= ntiles) {
        load_rows(sv + (st * kImages + i) * per,"""
_KV_WALK = """    load_rows(sk + st * per, image, width, h * kD, pix, 0, tr, L);
    load_rows(sv + st * per, image, width, C + h * kD, pix, 0, tr, L);"""
EDITS = {
    "base": [],
    "no_kv_loads": [(_KV_LOCAL, "        if (kCosine) {}"),
                    (_V_LOCAL, _V_LOCAL.replace("if (ntiles == 1 || step >= ntiles) {",
                                                "if (kCosine) {")),
                    (_KV_WALK, "")],
    "no_bias_loads": [("    if (kHasBias) load_bias_rows<tr>(sb + st * tr * kBiasRow,",
                       "    if (kCosine) load_bias_rows<tr>(sb + st * tr * kBiasRow,"),
                      ("  load_bias_rows<tr>(sb, bias + (size_t)h * L * ldb, 0, 0, L, ldb);", "")],
    "no_exp": [("      sc[n][e] = exp_minus(sc[n][e], m2[e >> 1]);\n      l[e >> 1] += sc[n][e];",
                "      sc[n][e] = sc[n][e] - m2[e >> 1];\n      l[e >> 1] += sc[n][e];")],
    "no_pv": [("  product_into<kPairs>(acc, sc, sv, 0, np);\n}\n\n// The warp's output rows",
               "  acc[0][0] += sc[0][0] + sc[2 * kPairs - 1][3];\n}\n\n// The warp's output rows")],
    # not phases: K3a's bias rows of L = 49 read 4 bytes a thread, unpadded;
    # the K4 walk's padded first
    "bias_4byte": [("  if (kHasBias && !walk && (g.L & 3) != 0) {", "  if (false) {")],
    "walk_pad": [("  if (kHasBias && !walk && (g.L & 3) != 0) {",
                  "  if (kHasBias && (g.L & 3) != 0) {")],
    # the two-sweep path (L = 196): no statistics sweep (the output sweep
    # alone), no block for the last query tile (4 real rows of 64; one
    # window, as at gcvit_tiny's stage 3)
    "no_statistics_sweep": [("  for (int step = 0; step < nsteps; ++step) {\n    const int k0 =",
                             "  for (int step = one_sweep ? 0 : ntiles; step < nsteps; ++step) {\n"
                             "    const int k0 =")],
    "no_last_query_tile": [("  kernel<<<dim3(g.nW * tiles_of(g.L), g.nheads, z),",
                            "  kernel<<<dim3(g.nW * tiles_of(g.L) - (tiles_of(g.L) > 1), "
                            "g.nheads, z),")],
}
# (kind, label, Hp, Wp, C, heads, ws, bias) at 224x224
SHAPES = [("K3a", "gcvit_tiny stage1", 56, 56, 64, 2, 7, True),
          ("K3a", "gcvit_tiny stage3", 14, 14, 256, 8, 14, True),
          ("K3a", "gcvit_tiny stage4", 7, 7, 512, 16, 7, True),
          ("K3a", "davit_t stage1", 56, 56, 96, 3, 7, False),
          ("K4", "gcvit_tiny stage1", 56, 56, 64, 2, 7, True),
          ("K4", "gcvit_tiny stage2", 28, 28, 128, 4, 7, True),
          ("K4", "gcvit_tiny stage3", 14, 14, 256, 8, 14, True)]
BATCH = 128


def main():
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from torchok_tpu_torch.ops import window_attention_dot as dot
    print(cs.card_line(), flush=True)
    bwd_variants = cs.load_tool("time_window_bwd_variants")  # its build()
    out_dir = os.path.join(REPO, "build", "wfwd_variants")
    with ThreadPoolExecutor(len(EDITS)) as pool:
        built = list(pool.map(lambda name: bwd_variants.build(
            name, out_dir, EDITS, HEADER, ("window_attention_fwd", "window_attention_global_fwd")),
            EDITS))
    functions = {}
    for name, libs, regs in built:
        print(f"{name}: registers {regs}", flush=True)
        for entry, lib in libs.items():
            fn = getattr(ctypes.CDLL(lib), entry)
            fn.argtypes = dot._ARGTYPES[entry]
            fn.restype = ctypes.c_int
            functions[(name, entry)] = fn
    real, plan = dot._function, dot.forward_scratch

    def padded_plan(b, hp, wp, nheads, ws, device, has_bias=True, global_queries=False):
        """walk_pad's plan: pad scratch for the walk too."""
        L = ws * ws
        got = plan(b, hp, wp, nheads, ws, device, has_bias, global_queries)
        return got._replace(work=nheads * L * (-(-L // 4) * 4)) if has_bias and L % 4 else got

    for idx, (kind, label, hp, wp, c, heads, ws, with_bias) in enumerate(SHAPES):
        parts = 2 if kind == "K4" else 3
        entry = dot.KERNEL_GLOBAL if kind == "K4" else dot.KERNEL
        proj, qg, scale, bias, _ = cs.dot_inputs(BATCH, hp, wp, c, heads, ws, torch.bfloat16,
                                                 parts, with_bias, 60 + idx)
        args = (proj,) + ((qg,) if parts == 2 else ()) + (scale, bias, ws, heads)
        wrapper = dot.window_attention_global_fwd_cuda if parts == 2 else \
            dot.window_attention_fwd_cuda
        times = {}
        for order in (list(EDITS), list(reversed(EDITS))):
            for name in order:
                dot._function = lambda n, _name=name: functions[(_name, n)] \
                    if n == entry else real(n)
                dot.forward_scratch = padded_plan if name == "walk_pad" else plan
                times.setdefault(name, []).append(cs.median_ms(lambda: wrapper(*args)))
        dot._function, dot.forward_scratch = real, plan
        base = statistics.mean(times["base"])
        print(f"{kind} bf16 {label} B{BATCH} L={ws * ws} heads={heads} bias={with_bias}: "
              + ", ".join(f"{name} {statistics.mean(t):.4f} ms (saves "
                          f"{base - statistics.mean(t):.4f})" for name, t in times.items()),
              flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
