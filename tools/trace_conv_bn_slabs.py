#!/usr/bin/env python
"""Where one block of K7's bf16 route (``csrc/matmul_bn_wgmma.cuh``) spends
its cycles: ``matmul_bn_fwd`` built from a copy of the sources, under
``build/k7_trace/``, with ``clock64()`` stamps written by block 0 into a
device array (each edit must match the header's text exactly once), and run
in bf16 (affine and ReLU on) at four ResNet-50 1x1 shapes at batch 256.

Stamps: the producer thread after each empty-wait and after issuing a slab's
TMA loads; consumer thread 0 before and after its wait for a slab, after the
prologue, after issuing the products and after waiting for them; at each
tile's epilogue start, after its stores and local sums, and after the sums
over the warps. Printed in thousands of cycles of block 0's SM: the
block's whole walk, and medians per slab and per tile. The stamps cost a
few instructions each: the times are those of the stamped build.

    python tools/trace_conv_bn_slabs.py
"""
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "matmul_bn_wgmma.cuh"
SHAPES = ((4, 1024, 256), (4, 256, 1024), (2, 64, 256), (5, 2048, 512))  # stage, K, N
# (row, what it marks): stamp rows of the device array
P_WAITED, P_ISSUED, C_START, C_DATA, C_PROLOGUE, C_ISSUED, C_DONE = range(7)
E_START, E_LOCAL, E_SUMS = 8, 9, 10
STAMP = ("#define K7_STAMP(k, j) do { if (blockIdx.x == 0 && (j) < 256) "
         "k7_trace[k][j] = clock64(); } while (0)\n")
EDITS = [
    ("namespace bnwg {\n",
     "__device__ long long k7_trace[16][256];\n" + STAMP + "namespace bnwg {\n"),
    ("    if (tid == kConsumerThreads) {\n      int stage = 0;\n      uint32_t phase = 0;\n",
     "    if (tid == kConsumerThreads) {\n      int stage = 0;\n      uint32_t phase = 0;\n"
     "      int pj = 0;\n"),
    ("          mbar_wait(empty + 8 * stage, phase ^ 1);\n",
     "          mbar_wait(empty + 8 * stage, phase ^ 1);\n"
     "          K7_STAMP(%d, pj);\n" % P_WAITED),
    ("            tma_load_1d(s + Cfg::kVecOffset + kBK * 4, &b_map, kc * kBK, bar);\n"
     "          }\n",
     "            tma_load_1d(s + Cfg::kVecOffset + kBK * 4, &b_map, kc * kBK, bar);\n"
     "          }\n          K7_STAMP(%d, pj);\n          ++pj;\n" % P_ISSUED),
    ("  int stage = 0;\n  uint32_t phase = 0;\n"
     "  for (int mt = group; mt < m_tiles; mt += groups) {\n",
     "  int stage = 0;\n  uint32_t phase = 0;\n  int cj = 0, ct = 0;\n"
     "  for (int mt = group; mt < m_tiles; mt += groups) {\n"),
    ("      mbar_wait(full + 8 * stage, phase);\n      const uint32_t s = ring",
     "      if (tid == 0) K7_STAMP(%d, cj);\n      mbar_wait(full + 8 * stage, phase);\n"
     "      if (tid == 0) K7_STAMP(%d, cj);\n      const uint32_t s = ring" % (C_START, C_DATA)),
    ("      fence_operands(a);\n      wgmma_fence();\n",
     "      fence_operands(a);\n      if (tid == 0) K7_STAMP(%d, cj);\n      wgmma_fence();\n"
     % C_PROLOGUE),
    ("      wgmma_commit();\n      wgmma_wait<0>();\n",
     "      wgmma_commit();\n      if (tid == 0) K7_STAMP(%d, cj);\n      wgmma_wait<0>();\n"
     "      if (tid == 0) K7_STAMP(%d, cj);\n      ++cj;\n" % (C_ISSUED, C_DONE)),
    ("    const int row0 = mt * kBM + warp * 16 + lane / 4;\n",
     "    if (tid == 0) K7_STAMP(%d, ct);\n    const int row0 = mt * kBM + warp * 16 + lane / 4;\n"
     % E_START),
    ("    if (K7_RUN(stats)) {\n      consumers_sync();\n",
     "    if (tid == 0) K7_STAMP(%d, ct);\n    if (K7_RUN(stats)) {\n      consumers_sync();\n"
     % E_LOCAL),
    ("      consumers_sync();  // red is written again by the next tile\n    }\n",
     "      consumers_sync();  // red is written again by the next tile\n    }\n"
     "    if (tid == 0) K7_STAMP(%d, ct);\n    ++ct;\n" % E_SUMS),
]


def build(out_dir):
    """The stamped ``matmul_bn_fwd`` library, with ``k7_trace_copy`` to read
    the stamps back."""
    from torchok_tpu_torch.utils.cuda_build import CSRC, NVCC_FLAGS, find_nvcc
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(CSRC, out_dir)
    path = os.path.join(out_dir, HEADER)
    with open(path) as f:
        text = f.read()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"the edit {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    entry = os.path.join(out_dir, "matmul_bn_fwd.cu")
    with open(entry, "a") as f:
        f.write('\nextern "C" int k7_trace_copy(void* dst) {\n'
                "  return (int)cudaMemcpyFromSymbol(dst, k7_trace, sizeof(k7_trace));\n}\n")
    lib = os.path.join(out_dir, "libmatmul_bn_fwd.so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib, entry], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"build failed:\n{proc.stderr}")
    return ctypes.CDLL(lib)


def main():
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from torchok_tpu_torch.ops import conv_bn
    print(cs.card_line(), flush=True)
    lib = build(os.path.join(REPO, "build", "k7_trace"))
    fn = getattr(lib, conv_bn.KERNEL)
    fn.argtypes = conv_bn._ARGTYPES
    fn.restype = ctypes.c_int
    conv_bn._function = lambda: fn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for stage, k, n in SHAPES:
        m = cs.RESNET_BATCH * dict((s_, px) for s_, px, _, _ in cs.BN_STAGES)[stage]
        args = cs.bn_inputs(m, k, n, torch.bfloat16, 10 + stage)
        for _ in range(3):
            conv_bn.matmul_bn_cuda(*args, True, True)
        torch.cuda.synchronize()
        stamps = np.zeros((16, 256), np.int64)
        lib.k7_trace_copy(stamps.ctypes.data_as(ctypes.c_void_p))
        plan = conv_bn.forward_plan(m, k, n, sms)
        tiles = len(range(0, -(-m // conv_bn.TILE_M), plan.groups))
        slabs = -(-k // 64)
        nj = min(tiles * slabs, 256)

        def kc(a, b):
            return np.median(stamps[b, :nj] - stamps[a, :nj]) / 1e3
        epi = np.median(stamps[E_SUMS, :tiles] - stamps[E_START, :tiles]) / 1e3
        local = np.median(stamps[E_LOCAL, :tiles] - stamps[E_START, :tiles]) / 1e3
        total = (stamps[E_SUMS, tiles - 1] - stamps[P_WAITED, 0]) / 1e3
        print(f"K7 bf16 stage{stage} x=({m},{k}) w=({k},{n}) tiles 128x{plan.tile_n}: block 0 "
              f"{tiles} tiles x {slabs} slabs in {total:.1f} kcycles; per slab (median): wait "
              f"{kc(C_START, C_DATA):.3f}, prologue {kc(C_DATA, C_PROLOGUE):.3f}, issue "
              f"{kc(C_PROLOGUE, C_ISSUED):.3f}, products wait {kc(C_ISSUED, C_DONE):.3f}, "
              f"producer issue {kc(P_WAITED, P_ISSUED):.3f}; per tile epilogue {epi:.3f} "
              f"(stores and local sums {local:.3f})", flush=True)
        del args
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
