#!/usr/bin/env python
"""Where K9's cluster route (``csrc/mbconv_fused_cluster.cuh``) spends its
time: the kernel built once as is and once without each of its phases
(expand, depthwise, se, project), side by side with the package's nvcc
flags, and timed in bf16 at batch 256 at B0's five block shapes in turns
(the builds in order, then in reverse; the mean of the two medians).

A phase is left out through the header's ``K9_RUN(phase)`` hook: each build
force-includes a header, written under ``build/k9_variants/<build>/``, that
defines it false for that phase at run time (``d.N < 0``, never true for a
real batch), so the rest compiles as before. The outputs of a build without
a phase are wrong by design: only its time means anything.

    python tools/time_mbconv_cluster_variants.py
"""
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("expand", "depthwise", "se", "project")
BUILDS = ("base",) + tuple(f"no_{phase}" for phase in PHASES)
# (label, H = W, C, mid, rd, k): B0's five block shapes of K9's form, and
# how many of B0's nine blocks have each
SHAPES = [("56x56 mid144 k3", 56, 24, 144, 8, 3, 1), ("28x28 mid240 k5", 28, 40, 240, 16, 5, 1),
          ("14x14 mid480 k3", 14, 80, 480, 24, 3, 2), ("14x14 mid672 k5", 14, 112, 672, 32, 5, 2),
          ("7x7 mid1152 k5", 7, 192, 1152, 48, 5, 3)]
BATCH = 256


def build(name, out_dir):
    """Build ``name`` into ``out_dir/name/libk9.so``; returns (name, path,
    the registers ptxas reports)."""
    from torchok_tpu_torch.utils.cuda_build import CSRC, NVCC_FLAGS, find_nvcc
    src = os.path.join(out_dir, name)
    os.makedirs(src, exist_ok=True)
    skip = name[len("no_"):] if name.startswith("no_") else None
    hook = os.path.join(src, "k9_run.h")
    with open(hook, "w") as f:
        f.write("#define K9_RUN(phase) (d.N < 0 || !K9_SKIP_##phase)\n")
        f.writelines(f"#define K9_SKIP_{phase} {int(phase == skip)}\n" for phase in PHASES)
    lib = os.path.join(src, "libk9.so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-include", hook, "-o", lib,
                           str(CSRC / "mbconv_fused_fwd.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"build {name} failed:\n{proc.stderr}")
    regs = sorted({ln.split("Used")[1].split()[0] for ln in proc.stderr.splitlines()
                   if "Used" in ln and "registers" in ln})
    return name, lib, regs


def median_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    sys.path.insert(0, REPO)
    import ctypes

    import numpy as np
    import torch
    from torchok_tpu_torch.ops import mbconv_fused as mb
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(REPO, "build", "k9_variants")
    with ThreadPoolExecutor(max_workers=len(BUILDS)) as pool:
        built = list(pool.map(lambda name: build(name, out_dir), BUILDS))
    functions = {}
    for name, lib, regs in built:
        fn = getattr(ctypes.CDLL(lib), mb.CLUSTER_SYMBOL)
        fn.argtypes = mb._CLUSTER_ARGTYPES
        fn.restype = ctypes.c_int
        functions[name] = fn
        print(f"{name}: registers {', '.join(regs)}", flush=True)
    totals = dict.fromkeys(BUILDS, 0.0)
    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    for label, hw, c, mid, rd, k, blocks in SHAPES:
        rng = np.random.default_rng(0)

        def g(*shape, scale=0.05):
            return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)
        x = g(BATCH, hw, hw, c, scale=0.5).to(torch.bfloat16)
        p = dict(w_exp=g(c, mid), s1=1.0 + g(mid), b1=g(mid), w_dw=g(k, k, mid, scale=0.3),
                 s2=1.0 + g(mid), b2=g(mid), w_se1=g(mid, rd), b_se1=g(rd), w_se2=g(rd, mid),
                 b_se2=g(mid), w_proj=g(mid, c), s3=1.0 + g(c), b3=g(c))
        q = mb._f32(p, device)
        cut = mb.plan_cluster(hw, hw, c, mid, rd, k)
        y = torch.empty_like(x)
        args = (x.data_ptr(), y.data_ptr(), *[q[n_].data_ptr() for n_ in mb.NAMES], BATCH, hw,
                hw, c, mid, rd, k, cut.strips, cut.rows, cut.chunk, cut.kc, cut.warps_m, stream)
        assert functions["base"](*args) == 0
        torch.cuda.synchronize()
        base_y = y.clone()
        # the base build is the package's kernel: its y is the wrapper's
        assert torch.equal(base_y, mb.mbconv_fused_cuda(x, p))
        times = {name: [] for name in BUILDS}
        for name in BUILDS + BUILDS[::-1]:
            times[name].append(median_ms(lambda: functions[name](*args)))
        means = {name: statistics.mean(t) for name, t in times.items()}
        for name in BUILDS:
            totals[name] += means[name] * blocks
        print(f"{label} bs{BATCH} bf16 plan {cut}: launch alone "
              + ", ".join(f"{name} {means[name]:.4f}" for name in BUILDS) + " ms", flush=True)
    print("B0's nine blocks summed (each shape times its blocks): "
          + ", ".join(f"{name} {totals[name]:.4f}" for name in BUILDS) + " ms", flush=True)


if __name__ == "__main__":
    main()
