#!/usr/bin/env python
"""Where K7's bf16 route (``csrc/matmul_bn_wgmma.cuh``) spends its time:
``matmul_bn_fwd`` built once as it is and once without each of its phases
(prologue, products, store, stats, x and w loads), side by side with the
package's nvcc flags, and timed in bf16 (affine and ReLU on) at ResNet-50's
four 1x1 stages at batch 256, both ways, in turns (the builds in order, then
in reverse; the mean of the two medians of 20 CUDA-event timings), with the
sums over the 8 launches of the stage-4 chain.

Each shape is timed two ways: one call between two events, as
``chip_smoke.py`` times it (the wrapper's host work before the launch
counts), and ten calls back to back between two events, divided by ten
(the host runs ahead of the card: device time).

A phase is left out through the header's ``K7_RUN(phase)`` hook: each build
force-includes a header, written under ``build/k7_variants/<build>/``, that
defines it false for that phase at run time (``M < 0``, never true), so the
rest compiles as before: ``no_prologue`` feeds the raw x to the products,
``no_products`` issues no wgmma, ``no_store`` stores no y, ``no_stats``
takes no column sums, ``no_x_loads`` and ``no_w_loads`` load x or w for a
block's first tile only (its later tiles reuse whatever the ring holds).
The outputs of a build without a phase are wrong by design: only its time
means anything.

    python tools/time_conv_bn_variants.py [build ...]   # default: every build
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("prologue", "products", "store", "stats", "x_loads", "w_loads")
BUILDS = ("base",) + tuple(f"no_{phase}" for phase in PHASES)
BACK_TO_BACK = 10


def build(name, out_dir):
    """Build ``name`` into ``out_dir/name/``; returns (name, library path,
    the registers and spill lines ptxas reports)."""
    from torchok_tpu_torch.utils.cuda_build import CSRC, NVCC_FLAGS, find_nvcc
    src = os.path.join(out_dir, name)
    shutil.rmtree(src, ignore_errors=True)
    os.makedirs(src)
    skip = name[len("no_"):] if name.startswith("no_") else None
    hook = os.path.join(src, "k7_run.h")
    with open(hook, "w") as f:
        f.write("#define K7_RUN(phase) (M < 0 || !K7_SKIP_##phase)\n")
        f.writelines(f"#define K7_SKIP_{phase} {int(phase == skip)}\n" for phase in PHASES)
    lib = os.path.join(src, "libmatmul_bn_fwd.so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-include", hook, "-o", lib,
                           str(CSRC / "matmul_bn_fwd.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"build {name} failed:\n{proc.stderr}")
    usage = sorted({ln.split("info    :")[-1].strip() for ln in proc.stderr.splitlines()
                    if "Used" in ln or "spill stores" in ln})
    return name, lib, usage


def main():
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from torchok_tpu_torch.ops import conv_bn
    names = ["base"] + [n for n in sys.argv[1:] if n != "base"] if sys.argv[1:] else list(BUILDS)
    print(cs.card_line(), flush=True)
    out_dir = os.path.join(REPO, "build", "k7_variants")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda name: build(name, out_dir), names))
    functions = {}
    for name, lib, usage in built:
        print(f"{name}: {'; '.join(usage)}", flush=True)
        fn = getattr(ctypes.CDLL(lib), conv_bn.KERNEL)
        fn.argtypes = conv_bn._ARGTYPES
        fn.restype = ctypes.c_int
        functions[name] = fn
    real = conv_bn._function
    chain = {name: [0.0, 0.0] for name in names}
    for stage, pixels, wide, narrow in cs.BN_STAGES:
        for k, n in ((wide, narrow), (narrow, wide)):
            m = cs.RESNET_BATCH * pixels
            args = cs.bn_inputs(m, k, n, torch.bfloat16, 10 + stage)

            def one():
                conv_bn.matmul_bn_cuda(*args, True, True)

            def several():
                for _ in range(BACK_TO_BACK):
                    conv_bn.matmul_bn_cuda(*args, True, True)
            times = {}
            for order in (names, names[::-1]):
                for name in order:
                    conv_bn._function = lambda _name=name: functions[_name]
                    times.setdefault(name, []).append(
                        (cs.median_ms(one), cs.median_ms(several) / BACK_TO_BACK))
            conv_bn._function = real
            means = {name: tuple(statistics.mean(t[i] for t in ts) for i in range(2))
                     for name, ts in times.items()}
            if stage == cs.CHAIN_STAGE:
                for name, (a, b) in means.items():
                    chain[name][0] += cs.CHAIN_LAYERS // 2 * a
                    chain[name][1] += cs.CHAIN_LAYERS // 2 * b
            base = means["base"]
            print(f"K7 bf16 stage{stage} x=({m},{k}) w=({k},{n}) ms one call / back to back: "
                  + ", ".join(f"{name} {a:.4f} / {b:.4f} (saves {base[1] - b:.4f})"
                              for name, (a, b) in means.items()), flush=True)
            del args
    print(f"K7 bf16 SUM stage-{cs.CHAIN_STAGE} chain ({cs.CHAIN_LAYERS} launches), ms one call / "
          "back to back: " + ", ".join(
              f"{name} {a:.4f} / {b:.4f} (saves {chain['base'][1] - b:.4f})"
              for name, (a, b) in chain.items()), flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
