#!/usr/bin/env python
"""Probe of the port's implicit-GEMM 3x3 conv (``torchok_tpu_torch.ops.
conv_gemm``) on ResNet-50's bottleneck 3x3 shapes (batch 256, bf16 in and out,
f32 accumulation). The counterpart of ``tools/probe_r50_conv_gemm.py``; it
imports the port only.

Per shape: the kernel against ``F.conv2d`` on channels-last bf16 (largest
difference relative to the largest output, then milliseconds and TFLOP/s of
both by CUDA events). On an NVIDIA GPU:
    python tools/probe_torch_r50_conv_gemm.py [--hw 7]
On the CPU (the plain version, the JAX probe's two small odd shapes):
    python tools/probe_torch_r50_conv_gemm.py --cpu
"""
import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from torchok_tpu_torch.ops.conv_gemm import conv3x3_gemm  # noqa: E402

# (N, H = W, Cin = Cout): ResNet-50's bottleneck 3x3 convs at bs 256
CASES = [(256, 56, 64), (256, 28, 128), (256, 14, 256), (256, 7, 512)]
SMALL_CASES = [(2, 9, 16), (2, 8, 24)]


def make_case(n, hw, c, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(n, hw, hw, c)) * 0.5).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, c, c)) * 0.05).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


def library_inputs(x, w):
    """The same conv as one ``F.conv2d`` call: NCHW-shaped views of the NHWC
    data (channels-last memory format), OIHW weights in the same format."""
    return (x.permute(0, 3, 1, 2),
            w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last))


def library_conv(xl, wl):
    return F.conv2d(xl, wl, padding=1)


def median_ms(fn, iters=20, warmup=3):
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, default=None, help="only the shape of this spatial size")
    ap.add_argument("--cpu", action="store_true", help="run the plain version on the CPU")
    args = ap.parse_args()
    if args.cpu:
        device, dtype, cases = torch.device("cpu"), torch.float32, SMALL_CASES
    else:
        if not torch.cuda.is_available():
            sys.exit("needs an NVIDIA GPU (or --cpu for the plain version at small shapes)")
        device, dtype, cases = torch.device("cuda", 0), torch.bfloat16, CASES
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0])
    for n, hw, c in cases:
        if args.hw and hw != args.hw:
            continue
        x, w = make_case(n, hw, c, device, dtype)
        xl, wl = library_inputs(x, w)
        got = conv3x3_gemm(x, w).float()
        ref = library_conv(xl, wl).permute(0, 2, 3, 1).float()
        rel = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-6)
        print(f"{hw}x{hw}x{c} (N={n}): max rel diff {rel:.4f}", flush=True)
        if rel >= 0.05:
            sys.exit("numerics mismatch")
        if args.cpu:
            continue
        flops = 2 * n * hw * hw * 9 * c * c
        t_lib = median_ms(lambda: library_conv(xl, wl))
        t_ker = median_ms(lambda: conv3x3_gemm(x, w))
        print(f"  F.conv2d: {t_lib:8.3f} ms  ({flops / t_lib / 1e9:6.1f} TFLOP/s)")
        print(f"  kernel  : {t_ker:8.3f} ms  ({flops / t_ker / 1e9:6.1f} TFLOP/s)"
              f"   kernel / F.conv2d time x{t_ker / t_lib:.3f}")


if __name__ == "__main__":
    main()
