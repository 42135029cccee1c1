#!/usr/bin/env python
"""A/B probe of the port's fused matmul + BatchNorm-statistics op
(``torchok_tpu_torch.ops.conv_bn``) against the unfused formulation, on
ResNet-50's bottleneck 1x1 shapes at batch 256. The counterpart of
``tools/probe_conv_bn.py``; it imports the port only.

Chain: L alternating 1x1 "convs" (wide -> narrow -> wide products over
M = B*H*W rows) with BatchNorm (+ReLU) between: the normalize of layer i feeds
layer i+1's input, exactly a bottleneck's conv1 -> conv3 edge. Both variants
compute the same function (Flax's statistics, bf16 activations, f32
statistics); the fused one folds the normalize into the next product's input
and the statistics into the product's output, one kernel launch per layer.

Prints loss and gradient parity, then forward+backward steps per second of
both (CUDA events around whole steps). On an NVIDIA GPU:
    python tools/probe_torch_conv_bn.py [--stage 4] [--layers 8]
On the CPU (the plain version of the kernel, small):
    python tools/probe_torch_conv_bn.py --cpu --rows 512 --dtype float32
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from torchok_tpu_torch.ops.conv_bn import bn_from_stats, matmul_bn  # noqa: E402

# (M, wide, narrow) per ResNet-50 stage at bs 256
STAGES = {
    2: (256 * 56 * 56, 256, 64),
    3: (256 * 28 * 28, 512, 128),
    4: (256 * 14 * 14, 1024, 256),
    5: (256 * 7 * 7, 2048, 512),
}
EPS = 1e-5


def make_params(seed, wide, narrow, layers, device):
    """f32 leaves: per layer a (K, N) weight, a BatchNorm gamma and beta."""
    rng = np.random.default_rng(seed)
    params = {"w": [], "gamma": [], "beta": []}
    for i in range(layers):
        k, n = (wide, narrow) if i % 2 == 0 else (narrow, wide)
        w = rng.normal(size=(k, n)).astype(np.float32) * (2.0 / k) ** 0.5
        params["w"].append(torch.from_numpy(w).to(device).requires_grad_(True))
        params["gamma"].append(torch.ones(n, device=device, requires_grad=True))
        params["beta"].append(torch.zeros(n, device=device, requires_grad=True))
    return params


def make_input(seed, m, wide, device, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(m, wide)).astype(np.float32)).to(device, dtype)


def loss_unfused(params, x):
    """Statistics as a reduction over the stored activation, normalize + ReLU
    written out before the next product."""
    m = x.shape[0]
    scale = torch.ones(x.shape[1], device=x.device)
    bias = torch.zeros(x.shape[1], device=x.device)
    y = x
    for w, gamma, beta in zip(params["w"], params["gamma"], params["beta"]):
        a = torch.relu(y.float() * scale + bias)
        y = torch.matmul(a.to(x.dtype), w.to(x.dtype))
        yf = y.float()
        scale, bias, _, _ = bn_from_stats(yf.sum(0), (yf * yf).sum(0), m, gamma, beta, EPS)
    return y.float().sum() / m


def loss_fused(params, x):
    m = x.shape[0]
    scale = torch.ones(x.shape[1], device=x.device)
    bias = torch.zeros(x.shape[1], device=x.device)
    y = x
    for w, gamma, beta in zip(params["w"], params["gamma"], params["beta"]):
        y, s1, s2 = matmul_bn(y, w.to(x.dtype), scale, bias, True, True)
        scale, bias, _, _ = bn_from_stats(s1, s2, m, gamma, beta, EPS)
    return y.float().sum() / m


def value_and_grads(loss_fn, params, x):
    """The loss and, per parameter group, its gradients. The last layer's
    gamma and beta feed nothing and get zeros."""
    leaves = [t for group in params.values() for t in group]
    loss = loss_fn(params, x)
    flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    grads = {name: [next(flat) for _ in group] for name, group in params.items()}
    for name, group in params.items():
        grads[name] = [torch.zeros_like(t) if g is None else g
                       for g, t in zip(grads[name], group)]
    return loss.detach(), grads


def parity(params, x):
    """Losses of both variants and, per parameter group, the largest gradient
    difference relative to the unfused gradient's largest magnitude."""
    loss_u, grads_u = value_and_grads(loss_unfused, params, x)
    loss_f, grads_f = value_and_grads(loss_fused, params, x)
    rel = {}
    for name in grads_u:
        err = max((a - b).abs().max().item() for a, b in zip(grads_u[name], grads_f[name]))
        top = max(a.abs().max().item() for a in grads_u[name])
        rel[name] = err / max(top, 1e-30)
    return {"loss_unfused": loss_u.item(), "loss_fused": loss_f.item(), "grad_rel_err": rel}


def steps_per_second(loss_fn, params, x, reps):
    value_and_grads(loss_fn, params, x)  # warm-up
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        value_and_grads(loss_fn, params, x)
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    return reps / (time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", type=int, default=4, choices=sorted(STAGES))
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rows", type=int, default=None, help="rows M (default: the stage's)")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--cpu", action="store_true", help="run the plain version on the CPU")
    args = ap.parse_args()

    if args.cpu:
        device, where = torch.device("cpu"), "cpu"
    else:
        if not torch.cuda.is_available():
            sys.exit("needs an NVIDIA GPU (or --cpu for the plain version at a small --rows)")
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        where = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0]
    m, wide, narrow = STAGES[args.stage]
    m = args.rows or m
    print(f"stage {args.stage}: M={m}, {wide}<->{narrow}, {args.layers} layers, "
          f"{args.dtype}, {where}", flush=True)
    params = make_params(0, wide, narrow, args.layers, device)
    x = make_input(1, m, wide, device, getattr(torch, args.dtype))

    result = parity(params, x)
    print(f"loss unfused={result['loss_unfused']:.6f} fused={result['loss_fused']:.6f}")
    print("max grad err / max |grad|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in result["grad_rel_err"].items()), flush=True)
    sps_u = steps_per_second(loss_unfused, params, x, args.reps)
    sps_f = steps_per_second(loss_fused, params, x, args.reps)
    print(f"unfused: {sps_u:.2f} fwd+bwd steps/s ({1e3 / sps_u:.2f} ms/step)")
    print(f"fused  : {sps_f:.2f} fwd+bwd steps/s ({1e3 / sps_f:.2f} ms/step)")
    print(f"fused / unfused: {sps_f / sps_u:.3f}x")


if __name__ == "__main__":
    main()
