#!/usr/bin/env python
"""Where the bf16 tensor-core backward spends its time in its plain-dot
modes (K3b, K5; ``csrc/swin_attention_bwd_mma.cuh``): the two entries built
once as they are and once without each phase, side by side with the
package's nvcc flags, and timed at gcvit_tiny's stage shapes in bf16 at
batch 128 in turns (the builds in order, then in reverse; the mean of the
two medians of 20 CUDA-event timings).

A phase is left out by editing a copy of the sources under
``build/wbwd_variants/<build>/`` (each edit must match its text exactly once):
``no_dq_pass`` / ``no_dkdv_pass`` skip one kernel's launch, ``no_bias_dq`` /
``no_bias_dkdv`` skip the bias tiles' loads of one pass (the products then
read whatever the ring holds), ``no_dbias`` skips the dbias column's sums;
``dkdv_two_blocks`` (not a phase) holds the dk/dv pass to 128 registers so
that two of its blocks share an SM where shared memory allows (L = 49).
The outputs of a build without a phase are wrong by design: only its time
means anything.

    python tools/time_window_bwd_variants.py
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "swin_attention_bwd_mma.cuh"
EDITS = {
    "base": [],
    "no_dq_pass": [("  dq_kernel<<<dq_grid,", "  if (false) dq_kernel<<<dq_grid,")],
    "no_dkdv_pass": [("  dkdv_kernel<<<dim3(", "  if (false) dkdv_kernel<<<dim3(")],
    "no_bias_dq": [("if (kHasBias) {\n      load_bias_tile(sb + st * kTile * kDqBiasRow,",
                    "if (false) {\n      load_bias_tile(sb + st * kTile * kDqBiasRow,")],
    "no_bias_dkdv": [("if (kHasBias) {\n        load_bias_tile(sb + st * kTile * kDkvBiasRow,",
                      "if (false) {\n        load_bias_tile(sb + st * kTile * kDkvBiasRow,")],
    "no_dbias": [("if (kHasBias) sdb[(q0 + c + odd) * kDkvBiasRow + kr] += dl;",
                  "if (false) sdb[(q0 + c + odd) * kDkvBiasRow + kr] += dl;")],
    # not a phase: the dk/dv pass held to 128 registers, two blocks an SM
    "dkdv_two_blocks": [("__global__ void __launch_bounds__(256, 1)\nbwd_dkdv_kernel",
                         "__global__ void __launch_bounds__(256, 2)\nbwd_dkdv_kernel")],
}
# (label, Hp, Wp, C, heads, ws) of gcvit_tiny at 224x224
SHAPES = [("stage1", 56, 56, 64, 2, 7), ("stage3", 14, 14, 256, 8, 14),
          ("stage4", 7, 7, 512, 16, 7)]
BATCH = 128


def build(name, out_dir):
    """Both entries of ``name`` built from an edited copy of the sources;
    returns (name, {entry: library path}, registers ptxas reports)."""
    from torchok_tpu_torch.utils.cuda_build import CSRC, NVCC_FLAGS, find_nvcc
    src = os.path.join(out_dir, name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    path = os.path.join(src, HEADER)
    with open(path) as f:
        text = f.read()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    libs, regs = {}, set()
    for entry in ("window_attention_bwd", "window_attention_global_bwd"):
        lib = os.path.join(src, f"lib{entry}.so")
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib,
                               os.path.join(src, f"{entry}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"build {name} failed:\n{proc.stderr}")
        libs[entry] = lib
        regs |= {ln.split("Used")[1].split()[0] for ln in proc.stderr.splitlines()
                 if "Used" in ln and "registers" in ln}
    return name, libs, sorted(regs)


def main():
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from torchok_tpu_torch.ops import window_attention_dot as dot
    print(cs.card_line(), flush=True)
    out_dir = os.path.join(REPO, "build", "wbwd_variants")
    with ThreadPoolExecutor(len(EDITS)) as pool:
        built = list(pool.map(lambda name: build(name, out_dir), EDITS))
    functions = {}
    for name, libs, regs in built:
        print(f"{name}: registers {regs}", flush=True)
        for entry, lib in libs.items():
            fn = getattr(ctypes.CDLL(lib), entry)
            fn.argtypes = dot._ARGTYPES[entry]
            fn.restype = ctypes.c_int
            functions[(name, entry)] = fn
    real = dot._function
    for kind, entry, parts in (("K3b", dot.KERNEL_BWD, 3), ("K5", dot.KERNEL_GLOBAL_BWD, 2)):
        for idx, (label, hp, wp, c, heads, ws) in enumerate(SHAPES):
            proj, qg, scale, bias, dout = cs.dot_inputs(BATCH, hp, wp, c, heads, ws,
                                                        torch.bfloat16, parts, True, 60 + idx)
            args = (proj,) + ((qg,) if parts == 2 else ()) + (scale, bias, dout, ws, heads)
            wrapper = dot.window_attention_global_bwd_cuda if parts == 2 else \
                dot.window_attention_bwd_cuda
            times = {}
            for order in (list(EDITS), list(reversed(EDITS))):
                for name in order:
                    dot._function = lambda n, _name=name: functions[(_name, n)] \
                        if n == entry else real(n)
                    times.setdefault(name, []).append(cs.median_ms(lambda: wrapper(*args)))
            dot._function = real
            base = statistics.mean(times["base"])
            print(f"{kind} bf16 gcvit_tiny {label} B{BATCH} L={ws * ws} heads={heads}: "
                  + ", ".join(f"{name} {statistics.mean(t):.4f} ms (saves "
                              f"{base - statistics.mean(t):.4f})" for name, t in times.items()),
                  flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
