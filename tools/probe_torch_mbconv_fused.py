#!/usr/bin/env python
"""Probe of the port's fused inference MBConv block (``torchok_tpu_torch.ops.
mbconv_fused``, K9). The counterpart of ``tools/probe_mbconv_fused.py``; it
imports the port only.

1. At the JAX probe's two shapes (EfficientNet-B0's 56x56 mid 144 k3 and
   14x14 mid 672 k5 blocks, batch 256, bf16 in and out and bf16 parameters):
   the kernel against the unfused library chain (``library_block``: 1x1
   ``F.conv2d``, affine, ``F.silu``, depthwise ``F.conv2d``, affine,
   ``F.silu``, mean, two small products, sigmoid, gate, 1x1, affine, add, on
   channels-last bf16), largest difference relative to the largest output,
   then milliseconds and TFLOP/s of both by CUDA events (the JAX probe's
   FLOP count).
2. B0's nine blocks of the kernel's form (``b0_blocks``: ``ir``, stride 1,
   input channels equal to output channels, SE) from the port's
   ``efficientnet_b0`` with random weights and non-trivial BatchNorm
   statistics: each block's BatchNorms folded into (scale, bias)
   (``fold_block``), the kernel run at batch 256 in bf16 on the block's own
   input shape and held to the block's eval forward in f32 (2^-7 of its
   largest output: one bf16 ulp).

On an NVIDIA GPU:
    python tools/probe_torch_mbconv_fused.py
On the CPU (the plain version, small shapes, blocks at batch 2):
    python tools/probe_torch_mbconv_fused.py --cpu
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
import torchok_tpu_torch  # noqa: E402,F401 — registers the backbones
from torchok_tpu_torch.constructor import BACKBONES  # noqa: E402
from torchok_tpu_torch.models.backbones.efficientnet_blocks import InvertedResidual  # noqa: E402
from torchok_tpu_torch.ops.mbconv_fused import mbconv_fused  # noqa: E402

# (name, N, H = W, C, mid, rd, k): the JAX probe's cases
CASES = [("stage3_56x56_mid144_k3", 256, 56, 24, 144, 6, 3),
         ("stage5_14x14_mid672_k5", 256, 14, 112, 672, 28, 5)]
SMALL_CASES = [("tiny_8x8_mid48_k3", 2, 8, 16, 48, 8, 3),
               ("tiny_9x9_mid40_k5", 2, 9, 24, 40, 8, 5)]
BLOCK_BATCH = 256
# 2^-7 of the largest output (one bf16 ulp of it or more): the kernel rounds
# once (half an ulp), the f32 reference not at all, and the folded affine
# differs from BatchNorm's normalise-then-scale by f32 rounding
BLOCK_TOLERANCE = 2.0 ** -7


def make_params(rng, cin, mid, rd, k, device, dtype):
    """The JAX probe's law: every parameter N(0, 0.05), vectors as (1, C)."""
    def g(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.05).astype(np.float32)).to(
            device, dtype)
    return dict(w_exp=g(cin, mid), s1=g(1, mid), b1=g(1, mid), w_dw=g(k, k, mid), s2=g(1, mid),
                b2=g(1, mid), w_se1=g(mid, rd), b_se1=g(1, rd), w_se2=g(rd, mid),
                b_se2=g(1, mid), w_proj=g(mid, cin), s3=g(1, cin), b3=g(1, cin))


def make_input(rng, n, hw, cin, device, dtype):
    """An NHWC input (its NCHW channels-last view is what a model hands a
    block)."""
    return torch.from_numpy((rng.normal(size=(n, hw, hw, cin)) * 0.5).astype(np.float32)).to(
        device, dtype)


def make_se_case(rng, n, h, w, cin, mid, rd, k, device, dtype):
    """``(x, p)`` whose output hangs on the SE mean over the whole image: x
    runs from -2 to +2 down the rows along a random direction of channels
    (each row strip's own mean differs from the image's), the SE weights
    scaled by 1 / sqrt(fan in) so that the gate's input is about 1 (the
    sigmoid neither flat nor saturated, b_se2 = 0), and w_proj so that the
    gated projection is about as large as x. (Under ``make_params``' law the
    gate is about sigmoid(b_se2): an error in the mean hardly moves y.)"""
    def g(*shape, scale):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(
            device, dtype)
    ramp = np.linspace(-1.0, 1.0, h, dtype=np.float32)[None, :, None, None]
    x = 2.0 * ramp * rng.normal(size=(1, 1, 1, cin)) + 0.25 * rng.normal(size=(n, h, w, cin))
    x = torch.from_numpy(x.astype(np.float32)).to(device, dtype)
    p = dict(w_exp=g(cin, mid, scale=cin ** -0.5), s1=1.0 + g(1, mid, scale=0.05),
             b1=g(1, mid, scale=0.05), w_dw=g(k, k, mid, scale=1.0 / k),
             s2=1.0 + g(1, mid, scale=0.05), b2=g(1, mid, scale=0.05),
             w_se1=g(mid, rd, scale=4.0 * mid ** -0.5), b_se1=g(1, rd, scale=0.05),
             w_se2=g(rd, mid, scale=2.0 * rd ** -0.5),
             b_se2=torch.zeros((1, mid), device=device, dtype=dtype),
             w_proj=g(mid, cin, scale=2.0 * mid ** -0.5), s3=1.0 + g(1, cin, scale=0.05),
             b3=g(1, cin, scale=0.05))
    return x, p


def library_weights(p):
    """The parameters as the library calls take them: OIHW conv weights in
    channels-last format, vectors flat."""
    cl = torch.channels_last
    vec = {k: v.reshape(-1) for k, v in p.items() if v.dim() <= 2 and k[0] in "sb"}
    k = p["w_dw"].shape[0]
    return dict(vec, w_exp=p["w_exp"].t()[:, :, None, None].contiguous(memory_format=cl),
                w_dw=p["w_dw"].permute(2, 0, 1)[:, None].contiguous(memory_format=cl),
                w_se1=p["w_se1"].t().contiguous(), w_se2=p["w_se2"].t().contiguous(),
                w_proj=p["w_proj"].t()[:, :, None, None].contiguous(memory_format=cl), k=k)


def library_block(x, lw):
    """The same block as unfused library calls on the NCHW channels-last view
    of NHWC ``x``, in x's type (the counterpart of the JAX probe's
    ``xla_block``); returns NHWC."""
    def affine(a, s, b):
        return a * s[None, :, None, None] + b[None, :, None, None]
    xc = x.permute(0, 3, 1, 2)
    a = F.silu(affine(F.conv2d(xc, lw["w_exp"]), lw["s1"], lw["b1"]))
    a = F.conv2d(a, lw["w_dw"], padding=(lw["k"] - 1) // 2, groups=a.shape[1])
    a = F.silu(affine(a, lw["s2"], lw["b2"]))
    r = F.silu(F.linear(a.mean((2, 3)), lw["w_se1"], lw["b_se1"]))
    a = a * torch.sigmoid(F.linear(r, lw["w_se2"], lw["b_se2"]))[:, :, None, None]
    y = affine(F.conv2d(a, lw["w_proj"]), lw["s3"], lw["b3"]) + xc
    return y.permute(0, 2, 3, 1)


def flops(n, hw, cin, mid, k):
    """The JAX probe's count: the two 1x1 products and the depthwise taps."""
    return n * hw * hw * (cin * mid + mid * cin) * 2 + n * hw * hw * mid * k * k * 2


def b0_blocks(model, size=224):
    """``[(name, block, (H, W)), ...]``: the blocks of an EfficientNet whose
    form the kernel takes (``ir``, stride 1, input channels equal to output
    channels, an expansion, SE), with their input's spatial size at
    ``size``x``size``."""
    out = []
    hw = size // 2  # after the stem
    for s, stage in enumerate(model.blocks):
        for b, block in enumerate(stage):
            hw = -(-hw // block.conv_dw.stride[0]) if hasattr(block, "conv_dw") else hw
            if (isinstance(block, InvertedResidual) and block.has_residual
                    and block.se is not None and block.conv_pw is not None):
                out.append((f"blocks_{s}_{b}", block, (hw, hw)))
    return out


def randomize_statistics(model, seed):
    """Non-trivial BatchNorm statistics and affines (the initial ones are the
    identity), drawn from a numpy generator."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_var"):
                c = m.num_features
                for t, v in ((m.running_mean, 0.2 * rng.normal(size=c)),
                             (m.running_var, rng.uniform(0.5, 1.5, size=c)),
                             (m.weight, 1.0 + 0.2 * rng.normal(size=c)),
                             (m.bias, 0.1 * rng.normal(size=c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))


def fold_block(block):
    """The kernel's parameters (f32) of an eval ``InvertedResidual``: its
    three BatchNorms folded into (scale, bias) with their own eps (1e-3),
    conv weights in the probe's layouts."""
    def fold(bn):
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        return scale, bn.bias - bn.running_mean * scale
    with torch.no_grad():
        s1, b1 = fold(block.bn1)
        s2, b2 = fold(block.bn2)
        s3, b3 = fold(block.bn3)
        return {k: v.detach().float().contiguous() for k, v in dict(
            w_exp=block.conv_pw.weight[:, :, 0, 0].t(), s1=s1, b1=b1,
            w_dw=block.conv_dw.weight[:, 0].permute(1, 2, 0), s2=s2, b2=b2,
            w_se1=block.se.fc1.weight[:, :, 0, 0].t(), b_se1=block.se.fc1.bias,
            w_se2=block.se.fc2.weight[:, :, 0, 0].t(), b_se2=block.se.fc2.bias,
            w_proj=block.conv_pwl.weight[:, :, 0, 0].t(), s3=s3, b3=b3).items()}


def b0_model(device, seed=0):
    """efficientnet_b0 in eval mode with weights from ``seed`` (the port's
    initial law) and randomized BatchNorm statistics."""
    model = BACKBONES.get("efficientnet_b0")()
    model.init_weights(torch.Generator().manual_seed(seed))
    randomize_statistics(model, seed + 1)
    return model.to(device).eval()


def block_reference(block, x):
    """The block's eval forward in f32 on the NCHW view of NHWC ``x``; NHWC."""
    with torch.no_grad(), torch.autocast(x.device.type, enabled=False):
        return block(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


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
    ap.add_argument("--cpu", action="store_true", help="run the plain version on the CPU")
    args = ap.parse_args()
    if args.cpu:
        device, cases, batch = torch.device("cpu"), SMALL_CASES, 2
    else:
        if not torch.cuda.is_available():
            sys.exit("needs an NVIDIA GPU (or --cpu for the plain version at small shapes)")
        device, cases, batch = torch.device("cuda", 0), CASES, BLOCK_BATCH
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0])
    rng = np.random.default_rng(0)
    for name, n, hw, cin, mid, rd, k in cases:
        x = make_input(rng, n, hw, cin, device, torch.bfloat16)
        p = make_params(rng, cin, mid, rd, k, device, torch.bfloat16)
        lw = library_weights(p)
        with torch.inference_mode():
            got = mbconv_fused(x, p).float()
            ref = library_block(x, lw).float()
        rel = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-6)
        print(f"{name}: max rel diff kernel vs library chain {rel:.4f}", flush=True)
        if rel >= 0.05:
            sys.exit("numerics mismatch")
        if args.cpu:
            continue
        fl = flops(n, hw, cin, mid, k)
        with torch.inference_mode():
            t_lib = median_ms(lambda: library_block(x, lw))
            t_ker = median_ms(lambda: mbconv_fused(x, p))
        print(f"  library chain: {t_lib:8.3f} ms  ({fl / t_lib / 1e9:6.2f} TFLOP/s)")
        print(f"  kernel       : {t_ker:8.3f} ms  ({fl / t_ker / 1e9:6.2f} TFLOP/s)"
              f"   library / kernel time x{t_lib / t_ker:.3f}", flush=True)
    model = b0_model(device)
    for name, block, (h, w) in b0_blocks(model):
        cin = block.conv_pw.in_channels
        x = make_input(rng, batch, h, cin, device, torch.bfloat16)
        with torch.inference_mode():
            got = mbconv_fused(x, fold_block(block)).float()
        ref = block_reference(block, x)
        top = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        print(f"B0 {name} x=({batch},{h},{w},{cin}) mid={block.conv_pw.out_channels} "
              f"k={block.conv_dw.kernel_size[0]}: max abs err {err:.3e} against the block's f32 "
              f"eval forward (tol {BLOCK_TOLERANCE:g} x max {top:.3e})", flush=True)
        if not err <= BLOCK_TOLERANCE * top:
            sys.exit(f"B0 {name}: the kernel differs from the block's eval forward")


if __name__ == "__main__":
    main()
