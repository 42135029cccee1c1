#!/usr/bin/env python3
"""Smoke run of torchok_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the versions.
2. Builds the port's ten CUDA kernels from ``torchok_tpu_torch/csrc`` with
   nvcc, one compiler per source, side by side, and prints each kernel's
   registers and spills; for K1's bf16 tensor-core kernel
   (``csrc/swin_attention_fwd_mma.cuh``) and the two passes of the
   tensor-core backward (``csrc/swin_attention_bwd_mma.cuh``) in each of its
   instantiations (K2's cosine mode, K3b's plain local mode with and without
   a bias, K5's global-query mode) their registers and spill bytes, that
   ``cuobjdump -sass`` finds HMMA in each, and the route each window size
   takes per dtype (bf16 must take ``mma``, f32 the FMA kernels).
3. Holds each kernel against its plain PyTorch version on the card and times
   kernel, plain version and the closest library call
   (``F.scaled_dot_product_attention`` on prepared windows; for a backward
   kernel its forward + backward) with CUDA events (median after warm-up),
   beside the bound from the bytes each must move and the operations it does:
   * K1/K2 (SwinV2 cosine attention, forward/backward) at each stage shape of
     four SwinV2 models (``SWIN_MODELS``: windows 8; 16 and 8; 12 and 6; 24
     and 12, so L = 36 to 576; in f32, 576 on the key-tiled path), batch 8 in f32
     (TF32 off) and each model's batch (128; 32 at 384x384) in bf16. K1: max
     abs error <= 1e-4 in f32, <= 2e-2 in bf16. K2: dqkv, dbias and dscale
     each within a stated fraction of the reference's largest magnitude.
     Both bit-equal between two launches.
   * K3a/K3b (plain window attention, forward/backward) at gcvit_tiny's four
     local shapes (windows 7/7/14/7, with the bias) and davit_t's four
     (window 7, no bias); K4/K5 (global-query attention, forward/backward)
     at gcvit_tiny's four; batch 8 in f32 and batch 128 in bf16, the same
     tolerances, backward kernels bit-equal between two launches and on the
     route printed per shape (bf16 the tensor-core backward, f32 the FMA
     template), by the launches counted per route.
   * K6 (cosine attention on pre-partitioned head-major windows) at
     swinv2_tiny's four window shapes, masked and unmasked: f32 at batch 8
     <= 1e-4 (the FMA template), bf16 at batch 128 <= 2e-2 (one bf16 ulp of
     the largest output) and every output within one bf16 ulp of the plain
     version's (``outside_one_ulp``; the tensor-core kernel
     ``window_attention_mw_mma.cuh``, whose four kernels must hold HMMA in
     their SASS), with the route of each stage printed.
   * K7 (1x1-conv GEMM with the BatchNorm prologue and statistics) at
     ResNet-50's four stages in both directions at batch 256 in bf16 and
     batch 8 in f32, all four flag combinations at stage 4, one ragged M: y
     within 1e-4 (f32) or 2^-7 (bf16: one ulp) of the largest |y|; s1/s2
     within rtol 1e-4 plus an atol that grows with sqrt(M) (ulp flips and
     summation order are a random walk over the rows); bit-equal twice.
   * K8 (3x3 conv as an implicit GEMM) at ResNet-50's four 3x3 shapes at
     batch 256 in bf16 (its wgmma loop: the script first prints ``K8 SASS
     has HGMMA: true`` from ``cuobjdump -sass`` of the built library), batch
     8 in f32, odd sizes, a ragged M and Cout 64 and 512, same y tolerances,
     bit-equal twice; its library call is ``F.conv2d`` on channels-last bf16.
   * K9 (one inference MBConv block, fused) at the JAX probe's two shapes
     and EfficientNet-B0's nine blocks of its form (BatchNorms folded, eps
     1e-3), batch 8 in f32 (<= 1e-4 of the largest |y|; the three-launch
     route) and batch 256 in bf16 (<= two ulps; the one-launch cluster
     route of ``mbconv_fused_cluster.cuh``, whose four kernels must hold
     HMMA in their SASS), bit-equal between two launches, and in bf16 at
     B0's shapes of 2 to 8 strips with inputs whose output hangs on the SE
     mean across the strips (``make_se_case``); its library time is
     the unfused chain of library calls (``tools/probe_torch_mbconv_fused.py::
     library_block``) at the probe's shapes and the blocks' own eval forwards
     for the record.
4. Drives the four op paths at full width, counters zeroed before and read
   after: ``window_attention(..., use_kernel=True)`` forward and backward
   through the hybrid at swinv2_tiny's stage-1 shape (against the einsum
   formulation; the f32 launch on the FMA route, the bf16 one on the
   tensor cores); the 8-layer stage-4 bottleneck chain of
   ``tools/probe_torch_conv_bn.py`` forward and backward (8 K7 launches, no
   plain call, loss and gradients against the unfused chain); ``conv3x3_gemm``
   over the four shapes (against ``F.conv2d``); ``mbconv_fused`` over B0's
   nine blocks at batch 256 in bf16 (9 K9 launches, all by the cluster
   route, each within one bf16 ulp of the block's f32 eval forward).
5. Drives the slices through ``torchok_tpu_torch.__main__.run`` with the
   dicts below (each equal to its ``configs/classification_*_synthetic*.yaml``),
   at full width, batch 128 (ResNet-50, EfficientNet-B0, MobileNetV3: 256),
   bf16 autocast, random weights from the seed. The
   launch counters are zeroed just before each run and read just after; the
   counts must be exactly the expected kernel launches and no plain call:
   * inference (``SLICE_CONFIG`` swinv2_tiny 256x256, ``WINDOW16_SLICE_CONFIG``
     swinv2_tiny_window16 256x256, ``BASE384_SLICE_CONFIG``
     swinv2_base_window12to24 384x384 at batch 32, ``GCVIT_SLICE_CONFIG``
     gcvit_tiny 224x224), 3 batches in modes test and predict: 12 K1, 12 K1,
     24 K1 (22 at L = 576), or 17 K3a + 14 K4, per batch; finite logits,
     Accuracy and F1Score reported, and the model in f32 on the card within
     1e-3 of its CPU run (plain attention) on two images;
   * every registered SwinV2 variant (twelve) at batch 1 at its own input
     size: one K1 launch per block, no plain call, finite features;
   * training (``TRAIN_CONFIG``, ``WINDOW16_TRAIN_CONFIG``,
     ``GCVIT_TRAIN_CONFIG``, ``DAVIT_TRAIN_CONFIG`` with the train set cut to
     one batch repeated for 10 one-step epochs, one sanity and one final
     validation batch): per step 12 K1 + 12 K2 (both SwinV2s), or
     17 K3a + 14 K4 + 17 K3b + 14 K5, or 6 K3a + 6 K3b (davit_t), the K3b
     and K5 launches all on the tensor-core route; every loss
     finite and the last below the first; the validation metrics reported;
     every parameter finite and the named ones moved;
   * ResNet-50 (``RESNET_SLICE_CONFIG``, ``RESNET_TRAIN_CONFIG``, 224x224,
     batch 256) in modes test, predict and train the same way. The JAX ResNet
     reaches no Pallas kernel, so the port's reaches no hand-written kernel:
     every launch counter must stay at 0 through these runs. Its f32 logits
     on the card (cuDNN and matmul TF32 off) are held to 1e-3 of the CPU run's
     as the others are;
   * EfficientNet-B0 (``EFFNET_SLICE_CONFIG``, ``EFFNET_TRAIN_CONFIG``) in
     modes test, predict and train and MobileNetV3-large
     (``MNV3_SLICE_CONFIG``) in mode test, 224x224, batch 256, the same way:
     the JAX EfficientNet and MobileNetV3 reach no Pallas kernel, so every
     counter stays at 0;
   * one f32 forward + backward of swinv2_tiny (windows 8 and 16) and of
     gcvit_tiny on two images on the card (kernels) against the CPU (plain
     versions), over all parameter gradients, within 1e-3 of the largest
     gradient.
6. Prints ``{"kernels": [...]}`` (K1 to K9; K1/K2's times are summed over
   one swinv2_tiny_window8 forward or backward, as before the other windows ran, the K3 to K5 times
   over one gcvit_tiny forward or backward, K6's over one swinv2_tiny forward,
   K7's over the chain's forward, K8's over its four shapes, K9's over B0's
   nine blocks), the card line,
   and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line. Without a CUDA
device, or without the package beside this script, it exits 1 at once.
"""
from __future__ import annotations

import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

_METRIC = {"params": {"task": "multiclass", "num_classes": 1000},
           "mapping": {"preds": "prediction", "target": "target"}}


def _synthetic(num_samples, shuffle, drop_last, size=256, batch=128, **extra):
    return [{
        "dataloader": {"batch_size": batch, "num_workers": 2, "drop_last": drop_last,
                       "shuffle": shuffle},
        "dataset": {
            "name": "SyntheticClassificationDataset",
            "params": {"num_samples": num_samples, "num_classes": 1000,
                       "image_size": [size, size], **extra},
            "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}],
        },
    }]


def _task(backbone, size, **backbone_params):
    return {
        "name": "ClassificationTask",
        "params": {
            "backbone_name": backbone,
            "backbone_params": {"pretrained": False, "in_channels": 3, **backbone_params},
            "pooling_name": "Pooling",
            "head_name": "ClassificationHead",
            "head_params": {"num_classes": 1000},
            "inputs": [{"shape": [3, size, size], "dtype": "float32"}],
        },
    }


def slice_config(backbone, size, batch=128, **backbone_params):
    """The inference recipe (configs/classification_<model>_synthetic.yaml)."""
    data = _synthetic(3 * batch, False, False, size, batch)
    return {
        "task": _task(backbone, size, **backbone_params),
        "data": {"TEST": data, "PREDICT": data},
        "trainer": {"accelerator": "gpu", "precision": 16,
                    "limit_test_batches": 3, "limit_predict_batches": 3},
        "seed_params": {"seed": 42},
        "metrics": [{"name": "Accuracy", **_METRIC}, {"name": "F1Score", **_METRIC}],
    }


def train_config(backbone, size, batch=128, **backbone_params):
    """The train recipe (configs/classification_<model>_synthetic_train.yaml)."""
    return {
        "task": _task(backbone, size, **backbone_params),
        "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                                   "mapping": {"input": "prediction", "target": "target"}}]},
        "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.0001}}}],
        "data": {"TRAIN": _synthetic(10 * batch, True, True, size, batch),
                 "VALID": _synthetic(2 * batch, False, False, size, batch, seed=1)},
        "trainer": {"accelerator": "gpu", "precision": 16, "max_epochs": 2},
        "seed_params": {"seed": 42},
        "metrics": [{"name": "Accuracy", **_METRIC}],
    }


SLICE_CONFIG = slice_config("swinv2_tiny_window8_256", 256)
TRAIN_CONFIG = train_config("swinv2_tiny_window8_256", 256)
WINDOW16_SLICE_CONFIG = slice_config("swinv2_tiny_window16_256", 256)
WINDOW16_TRAIN_CONFIG = train_config("swinv2_tiny_window16_256", 256)
BASE384_SLICE_CONFIG = slice_config("swinv2_base_window12to24_192to384_22kft1k", 384, batch=32)
GCVIT_SLICE_CONFIG = slice_config("gcvit_tiny", 224, img_size=224)
GCVIT_TRAIN_CONFIG = train_config("gcvit_tiny", 224, img_size=224)
DAVIT_TRAIN_CONFIG = train_config("davit_t", 224)
RESNET_SLICE_CONFIG = slice_config("resnet50", 224, batch=256)
RESNET_TRAIN_CONFIG = train_config("resnet50", 224, batch=256)
EFFNET_SLICE_CONFIG = slice_config("efficientnet_b0", 224, batch=256)
EFFNET_TRAIN_CONFIG = train_config("efficientnet_b0", 224, batch=256)
MNV3_SLICE_CONFIG = slice_config("mobilenetv3_large_100", 224, batch=256)
TRAIN_STEPS = 10
BATCHES = 3
BLOCKS = (2, 2, 6, 2)  # SwinBlocks per stage of swinv2_tiny
# (Hp, Wp, C, heads) of each stage at 256x256 input; window 8, head dim 32
STAGES = ((64, 64, 96, 3), (32, 32, 192, 6), (16, 16, 384, 12), (8, 8, 768, 24))
# SwinV2 models whose K1/K2 are held and timed at their stage shapes: (batch,
# stages of (Hp, Wp, C, heads, ws, blocks)) at each model's input size (256,
# 256, 192, 384); a window shrinks to a map no larger than it. L = ws * ws:
# 64; 256 and 64; 144 and 36; 576 (in f32 the key-tiled path) and 144.
SWIN_MODELS = {
    "swinv2_tiny_window8_256": (128, ((64, 64, 96, 3, 8, 2), (32, 32, 192, 6, 8, 2),
                                      (16, 16, 384, 12, 8, 6), (8, 8, 768, 24, 8, 2))),
    "swinv2_tiny_window16_256": (128, ((64, 64, 96, 3, 16, 2), (32, 32, 192, 6, 16, 2),
                                       (16, 16, 384, 12, 16, 6), (8, 8, 768, 24, 8, 2))),
    "swinv2_base_window12_192_22k": (128, ((48, 48, 128, 4, 12, 2), (24, 24, 256, 8, 12, 2),
                                           (12, 12, 512, 16, 12, 18), (6, 6, 1024, 32, 6, 2))),
    "swinv2_base_window12to24_192to384_22kft1k": (32, ((96, 96, 128, 4, 24, 2),
                                                       (48, 48, 256, 8, 24, 2),
                                                       (24, 24, 512, 16, 24, 18),
                                                       (12, 12, 1024, 32, 12, 2))),
}
RECORD_MODEL = "swinv2_tiny_window8_256"  # K1/K2's JSON records sum its blocks
CHECK_BATCH = 8
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
# K2's tolerances are relative to the largest magnitude of the reference
# tensor. dqkv is rounded to the input dtype (one bf16 ulp is 2^-8 relative).
# dbias and dscale are f32 sums of f32 terms over up to 8,192 windows in both
# versions, in another order, so they differ by f32 rounding only even for
# bf16 inputs; many terms cancel, hence 1e-3 rather than 1e-4 of the maximum.
K2_TOLERANCE = {"float32": {"dqkv": 1e-4, "dbias": 1e-3, "dscale": 1e-3},
                "bfloat16": {"dqkv": 2e-2, "dbias": 1e-3, "dscale": 1e-3}}
TIMING_ITERS = 20
TIMING_ITERS_SMALL = 10

# gcvit_tiny at 224x224: (Hp, Wp, C, heads, ws, local blocks, global blocks)
# of each stage; head dim 32. Blocks alternate local (even) and global (odd).
GCVIT_STAGES = ((56, 56, 64, 2, 7, 2, 1), (28, 28, 128, 4, 7, 2, 2),
                (14, 14, 256, 8, 14, 10, 9), (7, 7, 512, 16, 7, 3, 2))
# davit_t at 224x224: (Hp, Wp, C, heads, ws, spatial blocks); no bias
DAVIT_STAGES = ((56, 56, 96, 3, 7, 1), (28, 28, 192, 6, 7, 1),
                (14, 14, 384, 12, 7, 3), (7, 7, 768, 24, 7, 1))
# the plain modes' tensor-core forward kernels in a build (mangled names:
# swin_fwd_kernel<., ., kCosine false, ...> and the global window walk)
PLAIN_FWD_MMA = r"swin_fwd_kernelILi\dELi\dELb0E|global_fwd_kernel"
GCVIT_LOCAL = sum(st[5] for st in GCVIT_STAGES)    # 17 K3 launches per forward
GCVIT_GLOBAL = sum(st[6] for st in GCVIT_STAGES)   # 14 K4 launches per forward
DAVIT_SPATIAL = sum(st[5] for st in DAVIT_STAGES)  # 6 K3 launches per forward
# K3b/K5 tolerances, relative to the largest magnitude of the reference
# tensor. dqkv/dkv are rounded to the input dtype (one bf16 ulp is 2^-8
# relative). dqg and dbias are f32 sums of f32 terms in both versions, in
# another order; in bf16 the two versions round a few dls entries to
# neighbouring bf16 values (their f32 dl differ in the last bits), and each
# such entry moves dqg by a bf16 ulp (2^-8) of its term, hence 2^-8 of the
# largest entry there (1.3e-3 to 6.4e-4 of it were seen).
DOT_BWD_TOLERANCE = {"float32": {"dqkv": 1e-4, "dkv": 1e-4, "dqg": 1e-4, "dbias": 1e-3},
                     "bfloat16": {"dqkv": 2e-2, "dkv": 2e-2, "dqg": 2.0 ** -8, "dbias": 1e-3}}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(b, hp, wp, c, heads, ws, dtype, masked, seed):
    import torch
    from torchok_tpu_torch.models.backbones.swin import shift_window_mask
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    L = ws * ws
    qkv = (0.5 * torch.randn((b, hp, wp, 3 * c), generator=g, device=dev)).to(dtype)
    logit_scale = math.log(10.0) + 0.5 * torch.randn((heads,), generator=g, device=dev)
    scale = torch.exp(torch.clamp(logit_scale, max=math.log(100.0)))
    bias = 16 * torch.sigmoid(torch.randn((heads, L, L), generator=g, device=dev))
    mask = shift_window_mask(hp, wp, ws, ws // 2).to(dev) if masked else None
    return qkv, scale, bias, mask


def sdpa_inputs(qkv, scale, bias, mask, heads, ws):
    """The closest single library call, on what it needs prepared: windows
    already partitioned, q and k already normalised, q already scaled, and
    bias (+ mask) as one additive ``attn_mask``. The (window, head) pairs
    ride the head axis so the mask broadcasts over the images."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops.swin_attention import to_windows
    q, k, v = to_windows(qkv, ws, 3, heads)  # (B, H, nW, L, D)
    q = F.normalize(q.float(), dim=-1) * scale.view(1, heads, 1, 1, 1)
    k = F.normalize(k.float(), dim=-1)
    b, _, nw, L, d = q.shape
    attn = bias.view(heads, 1, L, L)
    if mask is not None:
        attn = attn + mask.view(1, nw, L, L)
    attn = attn.expand(heads, nw, L, L).reshape(1, heads * nw, L, L).to(qkv.dtype).contiguous()
    q, k, v = (t.reshape(b, heads * nw, L, d).to(qkv.dtype).contiguous() for t in (q, k, v))
    return q, k, v, attn


def attention_cost(b, hp, wp, c, heads, ws, itemsize, backward, masked):
    """Bytes the function must move (each input read once, each output
    written once) and the operations of its products on these inputs."""
    tokens, L = b * hp * wp, ws * ws
    small = 4 * (heads + heads * L * L + (hp // ws) * (wp // ws) * L * L * masked)
    if backward:  # qkv and dout in, dqkv out, dbias and dscale out; five products
        return 7 * c * itemsize * tokens + small + 4 * (heads * L * L + heads), \
            5 * 2 * tokens * L * c
    return 4 * c * itemsize * tokens + small, 2 * 2 * tokens * L * c


# published dense peaks of the H100 SXM: device memory 3.35 TB/s; 989 TFLOP/s
# for bf16 operands, 67 TFLOP/s for f32 operands outside the tensor cores
MEMORY_RATE = 3.35e12
PEAK_RATE = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(nbytes, flops, dtype_name):
    by_bytes = 1e3 * nbytes / MEMORY_RATE
    by_ops = 1e3 * flops / PEAK_RATE[dtype_name]
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def shape_cases(batch):
    """(stage, (hp, wp, c, heads), masked, blocks of that kind per forward)."""
    for stage, ((hp, wp, c, heads), depth) in enumerate(zip(STAGES, BLOCKS), 1):
        for masked in ((False, True) if hp > 8 else (False,)):
            yield stage, (hp, wp, c, heads), masked, depth // 2 if hp > 8 else depth


def swin_cases(model):
    """(stage, (hp, wp, c, heads, ws), masked, blocks of that kind per
    forward) of one SwinV2 model: a stage whose map is larger than its
    window shifts every other block."""
    _, stages = SWIN_MODELS[model]
    for stage, (hp, wp, c, heads, ws, depth) in enumerate(stages, 1):
        shifted = hp > ws
        for masked in ((False, True) if shifted else (False,)):
            yield stage, (hp, wp, c, heads, ws), masked, depth // 2 if shifted else depth


def check_swin(backward: bool):
    """K1 (``backward`` False) or K2 against its plain version at every stage
    shape of the SwinV2 models of ``SWIN_MODELS`` (windows 6 to 24, L 36 to
    576), batch 8 in f32 (TF32 off) and each model's batch in bf16, K2 twice
    for bit equality; at the model's batch the kernel, the plain version and
    SDPA are timed beside the bound. Prints the sums over each model's
    forward (K1) or backward (K2); the record sums swinv2_tiny_window8_256's,
    as before the other windows ran."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import swin_attention as ops
    kind = "K2" if backward else "K1"
    names = ("dqkv", "dbias", "dscale")
    failures = []
    worst_bf16 = 0.0
    sums = {}

    def run(fn, args, dout, ws, heads):
        return fn(*args, dout, ws, heads) if backward else (fn(*args, ws, heads),)

    kernel = ops.swin_attention_bwd_cuda if backward else ops.swin_attention_fwd_cuda
    plain = ops.swin_attention_bwd_plain if backward else ops.swin_attention_fwd_plain
    for model, (batch, _) in SWIN_MODELS.items():
        total = sums.setdefault(model, {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0,
                                        "n": 0})
        for dtype, b in ((torch.float32, CHECK_BATCH), (torch.bfloat16, batch)):
            name = dtype_name(dtype)
            for stage, (hp, wp, c, heads, ws), masked, n in swin_cases(model):
                seed = 10 * stage + masked + (0 if b == CHECK_BATCH else 100)
                args = attention_inputs(b, hp, wp, c, heads, ws, dtype, masked, seed)
                g = torch.Generator(device="cuda")
                g.manual_seed(1000 + seed)
                dout = torch.randn((b, hp, wp, c), generator=g, device="cuda").to(dtype)
                got = run(kernel, args, dout, ws, heads)
                again = run(kernel, args, dout, ws, heads)
                ref = run(plain, args, dout, ws, heads)
                torch.cuda.synchronize()
                ok = all(torch.equal(a, b_) for a, b_ in zip(got, again))
                ok = ok and all(bool(torch.isfinite(t).all().item()) for t in got)
                parts = []
                for key, g_, r_ in zip(names if backward else ("out",), got, ref):
                    err = (g_.float() - r_.float()).abs().max().item()
                    if backward:
                        rel = K2_TOLERANCE[name][key]
                        mag = r_.float().abs().max().item()
                        ok = ok and err <= rel * mag
                        parts.append(f"{key} err={err:.3e} (tol {rel:g} x max|ref| {mag:.3e})")
                    else:
                        ok = ok and err <= TOLERANCE[name]
                        parts.append(f"max_abs_err={err:.3e} (tol {TOLERANCE[name]:g})")
                    if name == "bfloat16" and key in ("out", "dqkv"):
                        worst_bf16 = max(worst_bf16, err)
                del got, again, ref
                line = (f"{kind} {name} {model} B{b} stage{stage} qkv=({b},{hp},{wp},{3 * c}) "
                        f"heads={heads} ws={ws} L={ws * ws} mask={masked} x{n}: "
                        + ", ".join(parts) + ", bit-equal twice")
                if b == batch:
                    k_ms = median_ms(lambda: run(kernel, args, dout, ws, heads), TIMING_ITERS)
                    p_ms = median_ms(lambda: run(plain, args, dout, ws, heads),
                                     TIMING_ITERS_SMALL)
                    q, k, v, attn = sdpa_inputs(*args, heads, ws)
                    if backward:
                        for t in (q, k, v):
                            t.requires_grad_(True)
                        dwin = torch.randn_like(q)

                        def library():
                            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn,
                                                                 scale=1.0)
                            torch.autograd.grad(out, (q, k, v), dwin)
                    else:
                        def library():
                            F.scaled_dot_product_attention(q, k, v, attn_mask=attn, scale=1.0)
                    lib_ms = median_ms(library, TIMING_ITERS_SMALL)
                    del q, k, v, attn
                    nbytes, flops = attention_cost(b, hp, wp, c, heads, ws, 2, backward, masked)
                    b_ms, by = bound_ms(nbytes, flops, "bfloat16")
                    line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                             f"sdpa{'_fwd_bwd' if backward else ''}_ms={lib_ms:.4f} "
                             f"bound_ms={b_ms:.4f} ({by})")
                    for key, value in (("k", k_ms), ("p", p_ms), ("lib", lib_ms),
                                       ("bytes", nbytes), ("flops", flops), ("n", 1)):
                        total[key] += n * value
                print(line, flush=True)
                if not ok:
                    failures.append(line)
                del args, dout
    if failures:
        fail(f"{kind} disagrees with its plain version or with itself: " + "; ".join(failures))
    for model, t in sums.items():
        b_ms, by = bound_ms(t["bytes"], t["flops"], "bfloat16")
        print(f"{kind} bf16 bs{SWIN_MODELS[model][0]} per {'backward' if backward else 'forward'}"
              f" of {model} ({t['n']} blocks): kernel_ms={t['k']:.4f} plain_ms={t['p']:.4f} "
              f"sdpa{'_fwd_bwd' if backward else ''}_ms={t['lib']:.4f} bound_ms={b_ms:.4f} "
              f"({by}: {t['bytes'] / 1e9:.3f} GB, {t['flops'] / 1e9:.1f} GFLOP)", flush=True)
    t = sums[RECORD_MODEL]
    total_bound, bound_by = bound_ms(t["bytes"], t["flops"], "bfloat16")
    source = ops.KERNEL_BWD if backward else ops.KERNEL
    return {"name": source, "route": "cuda",
            "source": f"torchok_tpu_torch/csrc/{source}.cu",
            "replaces": f"torchok_tpu/ops/swin_attention.py:{159 if backward else 93}",
            "launches": 0, "max_abs_err": worst_bf16,
            "ms": t["k"], "plain_ms": t["p"], "bound_ms": total_bound,
            "bound_by": bound_by, "library_ms": t["lib"]}


def check_k1():
    return check_swin(False)


def check_k2():
    return check_swin(True)


def dot_inputs(b, hp, wp, c, heads, ws, dtype, parts, with_bias, seed):
    """(proj, qg or None, scale, bias or None, dout) on the card for the plain
    window attention kernels; ``parts`` 3 is qkv, 2 is kv with global queries."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    L = ws * ws
    proj = torch.randn((b, hp, wp, parts * c), generator=g, device=dev).to(dtype)
    qg = torch.randn((b, L, c), generator=g, device=dev).to(dtype) if parts == 2 else None
    scale = torch.full((heads,), 32 ** -0.5, device=dev)
    bias = torch.randn((heads, L, L), generator=g, device=dev) if with_bias else None
    dout = torch.randn((b, hp, wp, c), generator=g, device=dev).to(dtype)
    return proj, qg, scale, bias, dout


def dot_sdpa_inputs(proj, qg, bias, ws, heads):
    """The closest single library call on what it needs prepared: windows
    already partitioned (and for the global mode the queries already repeated
    over the windows), bias as an additive ``attn_mask``; SDPA's default scale
    is the kernels' head_dim**-0.5."""
    from torchok_tpu_torch.ops.swin_attention import to_windows
    if qg is None:
        q, k, v = to_windows(proj, ws, 3, heads)  # (B, H, nW, L, D)
    else:
        k, v = to_windows(proj, ws, 2, heads)
        b, _, _, L, d = k.shape
        q = qg.reshape(b, L, heads, d).permute(0, 2, 1, 3)[:, :, None].expand_as(k)
    b, _, nw, L, d = k.shape
    attn = None
    if bias is not None:
        attn = bias.view(heads, 1, L, L).expand(heads, nw, L, L)
        attn = attn.reshape(1, heads * nw, L, L).to(proj.dtype).contiguous()
    q, k, v = (t.reshape(b, heads * nw, L, d).contiguous() for t in (q, k, v))
    return q, k, v, attn


def dot_cost(kind, b, hp, wp, c, heads, ws, itemsize, with_bias):
    """Bytes each kernel must move (each input read once, each output written
    once) and the operations of its products."""
    tokens, L = b * hp * wp, ws * ws
    small = 4 * heads * L * L * with_bias
    if kind == "K3a":
        return itemsize * tokens * 4 * c + small + 4 * heads, 4 * tokens * L * c
    if kind == "K3b":
        return itemsize * tokens * 7 * c + 2 * small + 4 * heads, 10 * tokens * L * c
    if kind == "K4":
        return itemsize * (tokens * 3 * c + b * L * c) + small + 4 * heads, 4 * tokens * L * c
    return (itemsize * (tokens * 5 * c + b * L * c) + 4 * b * L * c + 2 * small + 4 * heads,
            10 * tokens * L * c)


_DOT = {
    # kind: (wrapper, plain, source, replaces, parts, backward, output names)
    "K3a": ("window_attention_fwd_cuda", "window_attention_fwd_plain", "window_attention_fwd",
            "torchok_tpu/ops/swin_attention.py:93", 3, False, ("out",)),
    "K3b": ("window_attention_bwd_cuda", "window_attention_bwd_plain", "window_attention_bwd",
            "torchok_tpu/ops/swin_attention.py:159", 3, True, ("dqkv", "dbias")),
    "K4": ("window_attention_global_fwd_cuda", "window_attention_global_fwd_plain",
           "window_attention_global_fwd", "torchok_tpu/ops/swin_attention.py:267", 2, False,
           ("out",)),
    "K5": ("window_attention_global_bwd_cuda", "window_attention_global_bwd_plain",
           "window_attention_global_bwd", "torchok_tpu/ops/swin_attention.py:294", 2, True,
           ("dkv", "dqg", "dbias")),
}


def check_dot(kind, cases, timing=True):
    """One plain window attention kernel against its plain version at every
    shape in ``cases`` = [(label, (hp, wp, c, heads, ws), with_bias, launches
    per forward or backward of its model, counts towards the record)], in f32
    at B 8 and bf16 at B 128, twice for bit equality, with the route each
    launch took (bf16 on the tensor cores, f32 on the FMA template). Returns
    the JSON record, whose times are summed over the cases that count."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import window_attention_dot as dot
    wrapper_name, plain_name, source, replaces, parts, backward, names = _DOT[kind]
    wrapper, plain = getattr(dot, wrapper_name), getattr(dot, plain_name)
    route_of, counter = ((dot.backward_route, dot.ROUTE_LAUNCHES) if backward
                         else (dot.forward_route, dot.FWD_ROUTE_LAUNCHES))
    failures = []
    worst_bf16 = 0.0
    total = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0, "launches": 0}
    by_model = {}

    def call(fn, proj, qg, scale, bias, dout, ws, heads):
        args = (proj,) + ((qg,) if parts == 2 else ()) + (scale, bias)
        out = fn(*args, *((dout,) if backward else ()), ws, heads)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(t for t in out if t is not None)

    for dtype, batch in ((torch.float32, CHECK_BATCH), (torch.bfloat16, 128)):
        name = str(dtype).split(".")[-1]
        for idx, (label, (hp, wp, c, heads, ws), with_bias, n, counts) in enumerate(cases):
            inputs = dot_inputs(batch, hp, wp, c, heads, ws, dtype, parts, with_bias, 20 + idx)
            before = dict(counter)
            got = call(wrapper, *inputs, ws, heads)
            again = call(wrapper, *inputs, ws, heads)
            routed = {k: v - before.get(k, 0) for k, v in counter.items()
                      if v != before.get(k, 0)}
            ref = call(plain, *inputs, ws, heads)
            torch.cuda.synchronize()
            ok = all(torch.equal(a, b) for a, b in zip(got, again))
            # bf16 on the tensor cores, f32 on the FMA template
            route = route_of(source, dtype)
            want = "mma" if dtype == torch.bfloat16 else "templates"
            ok = ok and route == want and routed == {(source, route): 2}
            ok = ok and all(bool(torch.isfinite(t).all().item()) for t in got)
            parts_txt = []
            for key, g, r in zip((k for k in names if with_bias or k != "dbias"), got, ref):
                err = (g.float() - r.float()).abs().max().item()
                if backward:
                    rel = DOT_BWD_TOLERANCE[name][key]
                    mag = r.float().abs().max().item()
                    ok = ok and err <= rel * mag
                    parts_txt.append(f"{key} err={err:.3e} (tol {rel:g} x max|ref| {mag:.3e})")
                else:
                    ok = ok and err <= TOLERANCE[name]
                    parts_txt.append(f"max_abs_err={err:.3e} (tol {TOLERANCE[name]:g})")
                if name == "bfloat16" and key in ("out", "dqkv", "dkv"):
                    worst_bf16 = max(worst_bf16, err)
            del got, again, ref
            width = parts * c
            line = (f"{kind} {name} B{batch} {label} proj=({batch},{hp},{wp},{width}) "
                    f"heads={heads} ws={ws} bias={with_bias} x{n} route {route}: "
                    + ", ".join(parts_txt) + ", bit-equal twice")
            if timing:
                iters = TIMING_ITERS if batch > CHECK_BATCH else TIMING_ITERS_SMALL
                k_ms = median_ms(lambda: call(wrapper, *inputs, ws, heads), iters)
                p_ms = median_ms(lambda: call(plain, *inputs, ws, heads), iters)
                line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
                if batch == 128:
                    proj, qg, _, bias, _ = inputs
                    q, k, v, attn = dot_sdpa_inputs(proj, qg, bias, ws, heads)
                    if backward:
                        for t in (q, k, v):
                            t.requires_grad_(True)
                        dwin = torch.randn_like(q)

                        def library():
                            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn)
                            torch.autograd.grad(out, (q, k, v), dwin)
                    else:
                        def library():
                            F.scaled_dot_product_attention(q, k, v, attn_mask=attn)
                    lib_ms = median_ms(library, iters)
                    nbytes, flops = dot_cost(kind, batch, hp, wp, c, heads, ws, 2, with_bias)
                    b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
                    line += (f" sdpa{'_fwd_bwd' if backward else ''}_ms={lib_ms:.4f} "
                             f"bound_ms={b_ms:.4f}")
                    model = label.split()[0]
                    sums = by_model.setdefault(model, [0.0, 0.0, 0.0, 0])
                    for i, v_ in enumerate((n * k_ms, n * p_ms, n * lib_ms, n)):
                        sums[i] += v_
                    if counts:
                        total["k"] += n * k_ms
                        total["p"] += n * p_ms
                        total["lib"] += n * lib_ms
                    del q, k, v, attn
            if batch == 128 and counts:
                nbytes, flops = dot_cost(kind, batch, hp, wp, c, heads, ws, 2, with_bias)
                total["bytes"] += n * nbytes
                total["flops"] += n * flops
                total["launches"] += n
            print(line, flush=True)
            if not ok:
                failures.append(line)
            del inputs
    if failures:
        fail(f"{kind} disagrees with its plain version or with itself: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(total["bytes"], total["flops"], "bfloat16")
    for model, (k_ms, p_ms, lib_ms, n) in by_model.items():
        print(f"{kind} bf16 bs128 per {'backward' if backward else 'forward'} of {model} "
              f"({n} launches): kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"sdpa{'_fwd_bwd' if backward else ''}_ms={lib_ms:.4f}", flush=True)
    print(f"{kind} record ({total['launches']} launches of gcvit_tiny): "
          f"bound_ms={total_bound:.4f} ({bound_by}: {total['bytes'] / 1e9:.3f} GB, "
          f"{total['flops'] / 1e9:.1f} GFLOP)", flush=True)
    return {"name": source, "route": "cuda", "source": f"torchok_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": worst_bf16,
            "ms": total["k"], "plain_ms": total["p"], "bound_ms": total_bound,
            "bound_by": bound_by, "library_ms": total["lib"] if timing else None,
            "dtype_routes": {dtype_name(t): route_of(source, t)
                             for t in (torch.bfloat16, torch.float32)}}


def gcvit_cases(column):
    """GCViT-tiny's stage shapes with the launches of one kind per forward
    (``column`` 5: local blocks, 6: global blocks); these make the record."""
    return [(f"gcvit_tiny stage{i}", st[:5], True, st[column], True)
            for i, st in enumerate(GCVIT_STAGES, 1)]


def check_k3(timing=True):
    """K3a and K3b at GCViT-tiny's local shapes (with the bias) and DaViT-t's
    (without); the records sum GCViT-tiny's 17 launches."""
    cases = gcvit_cases(5) + [(f"davit_t stage{i}", st[:5], False, st[5], False)
                              for i, st in enumerate(DAVIT_STAGES, 1)]
    return check_dot("K3a", cases, timing), check_dot("K3b", cases, timing)


def check_k4(timing=True):
    return check_dot("K4", gcvit_cases(6), timing)


def check_k5(timing=True):
    return check_dot("K5", gcvit_cases(6), timing)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def mw_inputs(b_, heads, n_mask, dtype, seed):
    """(q, k, v, logit_scale, bias, mask) on the card for K6: L 64, D 32;
    ``n_mask`` window types (0: no mask)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    q, k, v = ((0.5 * torch.randn((b_, heads, 64, 32), generator=g, device=dev)).to(dtype)
               for _ in range(3))
    logit_scale = math.log(10.0) + 0.5 * torch.randn((heads,), generator=g, device=dev)
    bias = 16 * torch.sigmoid(torch.randn((heads, 64, 64), generator=g, device=dev))
    mask = None
    if n_mask:
        mask = -100.0 * (torch.rand((n_mask, 64, 64), generator=g, device=dev) < 0.3).float()
    return q, k, v, logit_scale, bias, mask


# K6's one-ulp check: each bf16 output within one bf16 ulp of the plain
# version's, the ulp taken at the larger magnitude of the two but at no less
# than ULP_FLOOR x max|v|. Below that floor the f32 roundings of both (a few
# f32 ulps of a logit at a temperature of up to 100: about 1e-5 of an output's
# scale max|v|) exceed an output's own ulp in either version. Rounding the
# weights or the unit vectors to bf16 moves outputs by 2^-9 of that scale or
# more, and fails it.
ULP_FLOOR = 2.0 ** -7


def outside_one_ulp(got, ref, v) -> int:
    """How many elements of ``got`` lie more than one bf16 ulp from ``ref``
    (both bf16 of one shape), the ulp as above with v the values attended
    over."""
    import torch
    g, r = got.float(), ref.float()
    floor = ULP_FLOOR * v.float().abs().max()
    size = torch.maximum(torch.maximum(g.abs(), r.abs()), floor)
    ulp = torch.exp2(torch.floor(torch.log2(size)) - 7)
    return int(((g - r).abs() > ulp).sum().item())


def mw_sdpa_inputs(q, k, v, logit_scale, bias, mask):
    """The closest single library call on what it needs prepared: q and k
    already normalised, q already scaled, bias (+ mask) as one additive
    ``attn_mask``; it leaves out the normalisation, the temperature and the
    assembly of the mask. The (window type, head) pairs ride the head axis so
    the mask broadcasts over the images."""
    import torch
    import torch.nn.functional as F
    b_, heads, L, d = q.shape
    nw = 1 if mask is None else mask.shape[0]
    scale = torch.exp(torch.clamp(logit_scale, max=math.log(100.0)))
    qn = F.normalize(q.float(), dim=-1) * scale.view(1, heads, 1, 1)
    kn = F.normalize(k.float(), dim=-1)
    attn = bias[None] if mask is None else bias[None] + mask[:, None]
    attn = attn.reshape(1, nw * heads, L, L).to(q.dtype).contiguous()
    qn, kn, vv = (t.to(q.dtype).reshape(b_ // nw, nw * heads, L, d).contiguous()
                  for t in (qn, kn, v))
    return qn, kn, vv, attn


def mw_cost(b_, heads, n_mask, itemsize):
    L, d = 64, 32
    return (4 * b_ * heads * L * d * itemsize + 4 * (heads + heads * L * L + n_mask * L * L),
            4 * b_ * heads * L * L * d)


# K6's tensor-core kernels mw_mma::mw_fwd_kernel<L, kHasMask>, mangled (not
# the FMA template's window_attention_mw_fwd_kernel)
MW_MMA = r"6mw_mma13mw_fwd_kernel"


def check_k6():
    """K6 against its plain version at swinv2_tiny's window shapes, masked
    (compact, one row per window type) and unmasked, on the route printed
    per stage (bf16 the tensor-core kernel, f32 the FMA template); bf16 also
    within one ulp of the plain version element by element
    (``outside_one_ulp``, which the einsum formulation's bf16 unit vectors
    and weights fail: their count is printed). The record sums the 12 blocks
    of one forward at batch 128."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import window_attention as wa
    failures = []
    worst_bf16 = 0.0
    total = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0}
    for dtype, batch in ((torch.float32, CHECK_BATCH), (torch.bfloat16, 128)):
        name = dtype_name(dtype)
        route = wa.forward_route(dtype, 64, 32)
        if route != ("mma" if dtype == torch.bfloat16 else "fma") \
                or wa.library_route(dtype, 64, 32) != route:
            fail(f"K6 {name} at L 64, head dim 32 routes to {route}")
        for stage, (hp, wp, c, heads), masked, n in shape_cases(batch):
            nw = (hp // 8) * (wp // 8)
            args = mw_inputs(batch * nw, heads, nw if masked else 0, dtype, 30 + stage)
            before = wa.FWD_ROUTE_LAUNCHES[route]
            got = wa.window_attention_mw_cuda(*args)
            ref = wa.window_attention_mw_plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all().item()) and err <= TOLERANCE[name] \
                and wa.FWD_ROUTE_LAUNCHES[route] == before + 1
            ulp = ""
            if dtype == torch.bfloat16:
                outside = outside_one_ulp(got, ref, args[2])
                einsum = outside_one_ulp(wa.window_attention_einsum(*args), ref, args[2])
                ok = ok and outside == 0
                ulp = (f" outside_one_ulp={outside} of {got.numel()} (einsum formulation "
                       f"{einsum})")
            del got, ref
            iters = TIMING_ITERS if batch > CHECK_BATCH else TIMING_ITERS_SMALL
            k_ms = median_ms(lambda: wa.window_attention_mw_cuda(*args), iters)
            p_ms = median_ms(lambda: wa.window_attention_mw_plain(*args), iters)
            line = (f"K6 {name} B{batch} stage{stage} q=({batch * nw},{heads},64,32) "
                    f"mask={masked} x{n} blocks route {route}: max_abs_err={err:.3e} "
                    f"(tol {TOLERANCE[name]:g}){ulp} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}")
            if batch == 128:
                worst_bf16 = max(worst_bf16, err)
                qn, kn, vv, attn = mw_sdpa_inputs(*args)
                lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                    qn, kn, vv, attn_mask=attn, scale=1.0), iters)
                del qn, kn, vv, attn
                nbytes, flops = mw_cost(batch * nw, heads, nw if masked else 0, 2)
                b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
                line += f" sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.4f}"
                for key, value in (("k", k_ms), ("p", p_ms), ("lib", lib_ms), ("bytes", nbytes),
                                   ("flops", flops)):
                    total[key] += n * value
            print(line, flush=True)
            if not ok:
                failures.append(line)
            del args
    if failures:
        fail("K6 disagrees with its plain version: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(total["bytes"], total["flops"], "bfloat16")
    print(f"K6 bf16 bs128 per forward (12 blocks): kernel_ms={total['k']:.4f} "
          f"plain_ms={total['p']:.4f} sdpa_ms={total['lib']:.4f} bound_ms={total_bound:.4f} "
          f"({bound_by}: {total['bytes'] / 1e9:.3f} GB, {total['flops'] / 1e9:.1f} GFLOP)",
          flush=True)
    return {"name": wa.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/window_attention_mw_fwd.cu",
            "replaces": "torchok_tpu/ops/window_attention.py:88",
            "launches": 0, "max_abs_err": worst_bf16, "ms": total["k"], "plain_ms": total["p"],
            "bound_ms": total_bound, "bound_by": bound_by, "library_ms": total["lib"]}


# ResNet-50's bottleneck 1x1 convs: (stage, pixels per image, wide, narrow)
BN_STAGES = ((2, 56 * 56, 256, 64), (3, 28 * 28, 512, 128), (4, 14 * 14, 1024, 256),
             (5, 7 * 7, 2048, 512))
RESNET_BATCH = 256
CHAIN_STAGE, CHAIN_LAYERS = 4, 8
# y: f32 sums in another order than the library's, or one bf16 ulp where the
# two f32 sums fall on either side of a rounding boundary, as a fraction of
# the largest |y|
GEMM_TOLERANCE = {"float32": 1e-4, "bfloat16": 2.0 ** -7}


def bn_inputs(m, k, n, dtype, seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=g, device=dev) * (2.0 / k) ** 0.5).to(dtype)
    scale = 0.5 + torch.rand((k,), generator=g, device=dev)
    bias = 0.2 * torch.randn((k,), generator=g, device=dev)
    return x, w, scale, bias


def bn_library(x, w, scale, bias, relu_in, with_affine):
    """The unfused chain of library calls: elementwise affine + ReLU, one
    ``torch.matmul``, two column reductions."""
    import torch
    a = x.float()
    if with_affine:
        a = a * scale + bias
    if relu_in:
        a = torch.relu(a)
    y = torch.matmul(a.to(x.dtype), w)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def bn_cost(m, k, n, itemsize):
    return itemsize * (m * k + k * n + m * n) + 4 * (2 * k + 2 * n), 2 * m * k * n


def check_k7():
    """K7 against its plain version, each call on the route its dtype takes
    (bf16 ``wgmma``, f32 ``fma``); the record sums the eight launches of the
    stage-4 chain's forward (four 1024 -> 256, four 256 -> 1024). Each timed
    shape also times the bare bf16 ``torch.matmul(x, w)``: a floor for
    reading x and writing y once, no function K7 computes."""
    import torch
    from torchok_tpu_torch.ops import conv_bn
    failures = []
    worst_bf16 = 0.0
    record = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0}

    def one(label, m, k, n, dtype, flags, seed, timing):
        nonlocal worst_bf16
        name = dtype_name(dtype)
        args = bn_inputs(m, k, n, dtype, seed)
        route = conv_bn.forward_route(dtype, m, k, n)
        before = dict(conv_bn.ROUTE_LAUNCHES)
        got = conv_bn.matmul_bn_cuda(*args, *flags)
        again = conv_bn.matmul_bn_cuda(*args, *flags)
        routes = {r_: conv_bn.ROUTE_LAUNCHES[r_] - before.get(r_, 0) for r_ in conv_bn.ROUTES}
        if route != ("wgmma" if dtype == torch.bfloat16 else "fma") or routes != {
                r_: 2 * (r_ == route) for r_ in conv_bn.ROUTES}:
            fail(f"K7 {name} {label}: expected both launches on the {route} route, got {routes}")
        ref = conv_bn.matmul_bn_plain(*args, *flags)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        top = ref[0].float().abs().max().item()
        err = (got[0].float() - ref[0].float()).abs().max().item()
        ok = same and all(bool(torch.isfinite(t).all().item()) for t in got)
        ok = ok and err <= GEMM_TOLERANCE[name] * top
        # the JAX package's test holds s1/s2 to rtol 1e-4, atol 1e-2 at M <= 256;
        # ulp flips of y and the other summation order are a random walk over
        # the rows, so the atol grows with sqrt(M) (and with |y|)
        atol = 1e-2 * max(1.0, top) * max(1.0, (m / 256) ** 0.5)
        parts = [f"y err={err:.3e} (tol {GEMM_TOLERANCE[name]:g} x max|y| {top:.3e})"]
        for key, g_, r_ in zip(("s1", "s2"), got[1:], ref[1:]):
            excess = ((g_ - r_).abs() - 1e-4 * r_.abs()).max().item()
            ok = ok and excess <= atol
            parts.append(f"{key} err={(g_ - r_).abs().max().item():.3e} of max "
                         f"{r_.abs().max().item():.3e} (rtol 1e-4, atol {atol:.3g})")
        if name == "bfloat16":
            worst_bf16 = max(worst_bf16, err)
        del got, again, ref
        plan = conv_bn.forward_plan(m, k, n, conv_bn._sm_count(args[0].device), route)
        line = (f"K7 {name} {label} x=({m},{k}) w=({k},{n}) relu_in={flags[0]} "
                f"with_affine={flags[1]} route {route} tiles 128x{plan.tile_n} grid "
                f"{plan.tiles_n}x{plan.groups}: " + ", ".join(parts)
                + f", bit-equal twice={same}")
        times = None
        if timing:
            k_ms = median_ms(lambda: conv_bn.matmul_bn_cuda(*args, *flags))
            p_ms = median_ms(lambda: conv_bn.matmul_bn_plain(*args, *flags))
            lib_ms = median_ms(lambda: bn_library(*args, *flags))
            mm_ms = median_ms(lambda: torch.matmul(args[0], args[1]))
            nbytes, flops = bn_cost(m, k, n, args[0].element_size())
            b_ms, by = bound_ms(nbytes, flops, name)
            line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} unfused_ms={lib_ms:.4f} "
                     f"matmul_ms={mm_ms:.4f} bound_ms={b_ms:.4f} ({by})")
            times = (k_ms, p_ms, lib_ms, nbytes, flops)
        print(line, flush=True)
        if not ok:
            failures.append(line)
        return times

    for stage, pixels, wide, narrow in BN_STAGES:
        for k, n in ((wide, narrow), (narrow, wide)):
            one(f"B{CHECK_BATCH} stage{stage}", CHECK_BATCH * pixels, k, n, torch.float32,
                (True, True), stage, False)
            times = one(f"bs{RESNET_BATCH} stage{stage}", RESNET_BATCH * pixels, k, n,
                        torch.bfloat16, (True, True), 10 + stage, True)
            if stage == CHAIN_STAGE:
                for key, value in zip(("k", "p", "lib", "bytes", "flops"), times):
                    record[key] += CHAIN_LAYERS // 2 * value
    _, pixels, wide, narrow = BN_STAGES[CHAIN_STAGE - 2]
    for dtype, batch in ((torch.float32, CHECK_BATCH), (torch.bfloat16, RESNET_BATCH)):
        for flags in ((False, False), (True, False), (False, True)):
            one(f"flags stage{CHAIN_STAGE}", batch * pixels, wide, narrow, dtype, flags, 20, False)
        one("ragged M", batch * pixels - 59, wide, narrow, dtype, (True, True), 21, False)
    if failures:
        fail("K7 disagrees with its plain version or with itself: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(record["bytes"], record["flops"], "bfloat16")
    print(f"K7 bf16 bs{RESNET_BATCH} per forward of the stage-{CHAIN_STAGE} chain "
          f"({CHAIN_LAYERS} launches): kernel_ms={record['k']:.4f} plain_ms={record['p']:.4f} "
          f"unfused_ms={record['lib']:.4f} bound_ms={total_bound:.4f} ({bound_by}: "
          f"{record['bytes'] / 1e9:.3f} GB, {record['flops'] / 1e9:.1f} GFLOP)", flush=True)
    return {"name": conv_bn.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/matmul_bn_fwd.cu",
            "replaces": "torchok_tpu/ops/conv_bn.py:45",
            "launches": 0, "max_abs_err": worst_bf16, "ms": record["k"], "plain_ms": record["p"],
            "bound_ms": total_bound, "bound_by": bound_by, "library_ms": record["lib"]}


# ResNet-50's bottleneck 3x3 convs: (H = W, Cin = Cout)
CONV_SHAPES = ((56, 64), (28, 128), (14, 256), (7, 512))


def conv_inputs(n, h, w_, cin, cout, dtype, seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    x = (0.5 * torch.randn((n, h, w_, cin), generator=g, device=dev)).to(dtype)
    w = (0.05 * torch.randn((3, 3, cin, cout), generator=g, device=dev)).to(dtype)
    return x, w


def conv_library_inputs(x, w):
    """NCHW-shaped views of the NHWC data (channels-last memory format) and
    OIHW weights in the same format, for one ``F.conv2d`` call."""
    import torch
    return (x.permute(0, 3, 1, 2),
            w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last))


def conv_cost(n, h, w_, cin, cout, itemsize):
    return (itemsize * (n * h * w_ * (cin + cout) + 9 * cin * cout),
            2 * n * h * w_ * 9 * cin * cout)


def check_k8():
    """K8 against its plain version (bf16: its wgmma loop, bit-equal twice;
    a ragged M and Cout 64 and 512 besides ResNet-50's shapes); the record
    sums the four ResNet-50 shapes at batch 256."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import conv_gemm
    failures = []
    worst_bf16 = 0.0
    record = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0}
    cases = [(f"B{CHECK_BATCH}", (CHECK_BATCH, hw, hw, c, c), torch.float32, False)
             for hw, c in CONV_SHAPES]
    cases += [("odd", (5, 9, 11, 24, 40), torch.float32, False),
              ("odd", (5, 9, 11, 24, 40), torch.bfloat16, False),
              ("ragged M", (3, 13, 11, 64, 128), torch.bfloat16, False),
              ("Cout 64", (2, 10, 10, 128, 64), torch.bfloat16, False),
              ("Cout 512", (2, 7, 7, 256, 512), torch.bfloat16, False)]
    cases += [(f"bs{RESNET_BATCH}", (RESNET_BATCH, hw, hw, c, c), torch.bfloat16, True)
              for hw, c in CONV_SHAPES]
    for idx, (label, shape, dtype, counts) in enumerate(cases):
        name = dtype_name(dtype)
        x, w = conv_inputs(*shape, dtype, 40 + idx)
        got = conv_gemm.conv3x3_gemm_cuda(x, w)
        again = conv_gemm.conv3x3_gemm_cuda(x, w)
        ref = conv_gemm.conv3x3_gemm_plain(x, w)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        top = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        ok = same and bool(torch.isfinite(got).all().item()) and err <= GEMM_TOLERANCE[name] * top
        del got, again, ref
        line = (f"K8 {name} {label} x={shape[:4]} w=(3,3,{shape[3]},{shape[4]}): "
                f"max_abs_err={err:.3e} (tol {GEMM_TOLERANCE[name]:g} x max|y| {top:.3e}), "
                f"bit-equal twice={same}")
        if counts:
            worst_bf16 = max(worst_bf16, err)
            xl, wl = conv_library_inputs(x, w)
            k_ms = median_ms(lambda: conv_gemm.conv3x3_gemm_cuda(x, w))
            p_ms = median_ms(lambda: conv_gemm.conv3x3_gemm_plain(x, w), TIMING_ITERS_SMALL)
            lib_ms = median_ms(lambda: F.conv2d(xl, wl, padding=1))
            nbytes, flops = conv_cost(*shape, 2)
            b_ms, by = bound_ms(nbytes, flops, name)
            line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} conv2d_ms={lib_ms:.4f} "
                     f"bound_ms={b_ms:.4f} ({by})")
            for key, value in zip(("k", "p", "lib", "bytes", "flops"),
                                  (k_ms, p_ms, lib_ms, nbytes, flops)):
                record[key] += value
        print(line, flush=True)
        if not ok:
            failures.append(line)
        del x, w
    if failures:
        fail("K8 disagrees with its plain version: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(record["bytes"], record["flops"], "bfloat16")
    print(f"K8 bf16 bs{RESNET_BATCH} over the four shapes: kernel_ms={record['k']:.4f} "
          f"plain_ms={record['p']:.4f} conv2d_ms={record['lib']:.4f} bound_ms={total_bound:.4f} "
          f"({bound_by}: {record['bytes'] / 1e9:.3f} GB, {record['flops'] / 1e9:.1f} GFLOP)",
          flush=True)
    return {"name": conv_gemm.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/conv3x3_gemm.cu",
            "replaces": "tools/probe_r50_conv_gemm.py:46",
            "launches": 0, "max_abs_err": worst_bf16, "ms": record["k"], "plain_ms": record["p"],
            "bound_ms": total_bound, "bound_by": bound_by, "library_ms": record["lib"]}


# K9's shapes: the JAX probe's two (N, H = W, C, mid, rd, k) at batch 256
MBCONV_PROBE = (("probe 56x56 mid144 k3", (56, 24, 144, 6, 3)),
                ("probe 14x14 mid672 k5", (14, 112, 672, 28, 5)))
EFFNET_BATCH = 256
# f32 sums in other orders (f32), or up to two bf16 ulps of the largest |y|
# (one where the two f32 results straddle a rounding boundary, and the
# plain version's depthwise sums round per tap where the kernel fuses)
MBCONV_TOLERANCE = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


def b0_cases(probe, device):
    """B0's nine blocks of K9's form from the port's efficientnet_b0 (random
    weights, randomized BatchNorm statistics): (name, block, folded f32
    parameters, (hw, cin, mid, rd, k))."""
    model = probe.b0_model(device)
    out = []
    for name, block, (hw, _) in probe.b0_blocks(model):
        p = probe.fold_block(block)
        mid = p["w_exp"].shape[1]
        out.append((name, block, p, (hw, p["w_exp"].shape[0], mid, p["w_se1"].shape[1],
                                     p["w_dw"].shape[0])))
    return out


def check_k9(probe, b0):
    """K9 against its plain version at the probe's two shapes and B0's nine
    blocks, f32 at batch 8 and bf16 at batch 256, twice for bit equality,
    each by the route it must take (bf16: the one-launch cluster kernel, f32:
    the three launches); at batch 256 the kernel, the plain version and the
    library chain are timed. The record sums B0's nine blocks; their library
    time is the blocks' own eval forwards (bf16 autocast, channels-last)."""
    import numpy as np
    import torch
    from torchok_tpu_torch.ops import mbconv_fused as mb
    device = torch.device("cuda", 0)
    failures = []
    worst_bf16 = 0.0
    record = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0}
    cases = [(label, shape, None, None) for label, shape in MBCONV_PROBE]
    cases += [(f"b0 {name}", shape, block, p) for name, block, p, shape in b0]
    for idx, (label, (hw, cin, mid, rd, k), block, folded) in enumerate(cases):
        for dtype, n in ((torch.float32, CHECK_BATCH), (torch.bfloat16, EFFNET_BATCH)):
            name = dtype_name(dtype)
            rng = np.random.default_rng(70 + idx)
            x = probe.make_input(rng, n, hw, cin, device, dtype)
            p = folded if folded is not None else probe.make_params(rng, cin, mid, rd, k, device,
                                                                    dtype)
            want = "cluster" if dtype == torch.bfloat16 else "three_launch"
            routes = dict(mb.ROUTE_LAUNCHES)
            got = mb.mbconv_fused_cuda(x, p)
            again = mb.mbconv_fused_cuda(x, p)
            routed = {r: v - routes.get(r, 0) for r, v in mb.ROUTE_LAUNCHES.items()
                      if v != routes.get(r, 0)}
            ref = mb.mbconv_fused_plain(x, p)
            torch.cuda.synchronize()
            same = torch.equal(got, again) and routed == {want: 2}
            top = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            ok = same and bool(torch.isfinite(got).all().item()) \
                and err <= MBCONV_TOLERANCE[name] * top
            del got, again, ref
            line = (f"K9 {name} {label} x=({n},{hw},{hw},{cin}) mid={mid} rd={rd} k={k}: "
                    f"max_abs_err={err:.3e} (tol {MBCONV_TOLERANCE[name]:g} x max|y| {top:.3e}), "
                    f"bit-equal twice and route {want}={same}")
            if n == EFFNET_BATCH:
                worst_bf16 = max(worst_bf16, err)
                k_ms = median_ms(lambda: mb.mbconv_fused_cuda(x, p))
                p_ms = median_ms(lambda: mb.mbconv_fused_plain(x, p), TIMING_ITERS_SMALL)
                if block is None:
                    lw = probe.library_weights(p)
                    with torch.inference_mode():
                        lib_ms = median_ms(lambda: probe.library_block(x, lw))
                    lib_name = "library_chain_ms"
                else:
                    xl = x.permute(0, 3, 1, 2)  # the channels-last NCHW view the model hands it
                    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                        lib_ms = median_ms(lambda: block(xl))
                    lib_name = "block_eval_forward_ms"
                # x read and y written in bf16, the weights once; the JAX
                # probe's operation count (the two 1x1 products, the taps)
                nbytes = 2 * 2 * n * hw * hw * cin + sum(t.numel() * t.element_size()
                                                         for t in p.values())
                flops = probe.flops(n, hw, cin, mid, k)
                b_ms, by = bound_ms(nbytes, flops, "bfloat16")
                line += (f" route={want} plan={mb.plan_cluster(hw, hw, cin, mid, rd, k)}"
                         f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} {lib_name}={lib_ms:.4f} "
                         f"bound_ms={b_ms:.4f} ({by}: {nbytes / 1e6:.1f} MB, "
                         f"{flops / 1e9:.2f} GFLOP) TFLOP/s={flops / k_ms / 1e9:.2f}")
                if block is not None:
                    for key, value in zip(("k", "p", "lib", "bytes", "flops"),
                                          (k_ms, p_ms, lib_ms, nbytes, flops)):
                        record[key] += value
            print(line, flush=True)
            if not ok:
                failures.append(line)
            del x
    # bf16 where y hangs on the SE mean over the whole image (a strip's own
    # mean, the wrong rank's or the wrong count would show), at B0's shapes
    # whose image a cluster of 2 to 8 blocks holds
    for hw, cin, mid, rd, k in sorted({shape for _, _, _, shape in b0}):
        strips = mb.plan_cluster(hw, hw, cin, mid, rd, k).strips
        if strips == 1:
            continue
        x, p = probe.make_se_case(np.random.default_rng(11), CHECK_BATCH, hw, hw, cin, mid, rd,
                                  k, device, torch.bfloat16)
        routes = dict(mb.ROUTE_LAUNCHES)
        got, again = mb.mbconv_fused_cuda(x, p), mb.mbconv_fused_cuda(x, p)
        ref = mb.mbconv_fused_plain(x, p)
        torch.cuda.synchronize()
        same = torch.equal(got, again) and mb.ROUTE_LAUNCHES["cluster"] == routes.get(
            "cluster", 0) + 2
        top = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        line = (f"K9 bfloat16 SE mean across {strips} strips x=({CHECK_BATCH},{hw},{hw},{cin}) "
                f"mid={mid} k={k}: max_abs_err={err:.3e} (tol {MBCONV_TOLERANCE['bfloat16']:g} "
                f"x max|y| {top:.3e}), bit-equal twice and route cluster={same}")
        print(line, flush=True)
        if not (same and err <= MBCONV_TOLERANCE["bfloat16"] * top):
            failures.append(line)
    if failures:
        fail("K9 disagrees with its plain version or with itself: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(record["bytes"], record["flops"], "bfloat16")
    print(f"K9 bf16 bs{EFFNET_BATCH} over B0's nine blocks: kernel_ms={record['k']:.4f} "
          f"plain_ms={record['p']:.4f} block_eval_forwards_ms={record['lib']:.4f} "
          f"bound_ms={total_bound:.4f} ({bound_by}: {record['bytes'] / 1e9:.3f} GB, "
          f"{record['flops'] / 1e9:.1f} GFLOP)", flush=True)
    return {"name": mb.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/mbconv_fused_fwd.cu",
            "replaces": "tools/probe_mbconv_fused.py:81",
            "launches": 0, "max_abs_err": worst_bf16, "ms": record["k"], "plain_ms": record["p"],
            "bound_ms": total_bound, "bound_by": bound_by, "library_ms": record["lib"]}


def run_mbconv_path(probe, b0, records):
    """The op path of K9: B0's nine blocks at batch 256 in bf16 through
    ``mbconv_fused`` with their folded parameters, each held to the block's
    own eval forward in f32 (2^-7 of its largest output: one bf16 ulp); all
    nine launches by the one-launch cluster route."""
    import numpy as np
    import torch
    from torchok_tpu_torch.ops import mbconv_fused as mb
    from torchok_tpu_torch.ops.common import LAUNCHES
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(80)
    inputs = [probe.make_input(rng, EFFNET_BATCH, hw, cin, device, torch.bfloat16)
              for _, _, _, (hw, cin, _, _, _) in b0]
    torch.cuda.synchronize()
    LAUNCHES.clear()
    mb.ROUTE_LAUNCHES.clear()
    with torch.inference_mode():
        outs = [mb.mbconv_fused(x, p) for x, (_, _, p, _) in zip(inputs, b0)]
    torch.cuda.synchronize()
    counts = launch_counts()
    routes = {r: v for r, v in mb.ROUTE_LAUNCHES.items() if v}
    for x, y, (name, block, _, (hw, cin, mid, _, k)) in zip(inputs, outs, b0):
        ref = probe.block_reference(block, x)
        top = ref.abs().max().item()
        err = (y.float() - ref).abs().max().item()
        print(f"mbconv_fused {name} ({EFFNET_BATCH},{hw},{hw},{cin}) mid={mid} k={k} bf16 against "
              f"the block's f32 eval forward: max_abs_err={err:.3e} "
              f"(tol {probe.BLOCK_TOLERANCE:g} x {top:.3e})", flush=True)
        if not (err <= probe.BLOCK_TOLERANCE * top and bool(torch.isfinite(y).all().item())):
            fail(f"mbconv_fused differs from B0's {name} eval forward: {err:.3e}")
    require_launches("mbconv_fused op path", counts, {mb.KERNEL: len(b0)})
    print(f"mbconv_fused op path: launches by route {routes}", flush=True)
    if routes != {"cluster": len(b0)}:
        fail(f"mbconv_fused op path: B0's nine blocks must take the cluster route, got {routes}")
    records[mb.KERNEL]["launches"] += counts[mb.KERNEL]


def launch_counts():
    from torchok_tpu_torch.ops.common import LAUNCHES
    return {k: v for k, v in LAUNCHES.items() if v}


def require_launches(label, counts, want):
    """``counts`` must hold exactly the kernel launches in ``want`` and no
    call of a plain version (any other key of the shared counter)."""
    if counts != {k: v for k, v in want.items() if v}:
        fail(f"{label}: expected launches {want} and no plain call, got {counts}")


def load_tool(name):
    """A script of ``tools/`` as a module (``tools`` is not a package)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_op_paths(records):
    """The public ops that reach K6, K7 and K8, at full width: their entry
    points in the JAX package are the ops themselves and two probes."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import conv_bn, conv_gemm
    from torchok_tpu_torch.ops import window_attention as wa
    from torchok_tpu_torch.ops.common import LAUNCHES

    # K6: window_attention with the kernel on, forward and backward through
    # the hybrid, at swinv2_tiny's stage-1 shape (64 window types per image),
    # against the einsum formulation (its own forward and backward). f32 at
    # batch 8: the kernel does not round the unit vectors and normalises with
    # rsqrt(sum + eps), hence 2e-4 as the JAX package holds it; gradients
    # within 1e-3 of the largest. bf16 at batch 128: within two bf16 ulps of
    # the largest value (the einsum formulation rounds qn, kn and the weights).
    hp, wp, c, heads = STAGES[0]
    nw = (hp // 8) * (wp // 8)
    LAUNCHES.clear()
    wa.FWD_ROUTE_LAUNCHES.clear()
    for dtype, batch, out_tol, grad_tol in ((torch.float32, CHECK_BATCH, 2e-4, 1e-3),
                                            (torch.bfloat16, 128, 4e-2, 4e-2)):
        q, k, v, logit_scale, bias, mask = mw_inputs(batch * nw, heads, nw, dtype, 50)
        g = torch.Generator(device="cuda")
        g.manual_seed(51)
        dout = torch.randn(q.shape, generator=g, device=q.device).to(dtype)
        results = []
        for use_kernel in (True, False):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v, logit_scale, bias)]
            out = wa.window_attention(*leaves, mask, use_kernel)
            grads = torch.autograd.grad(out, leaves, dout)
            results.append((out.detach(), grads))
        torch.cuda.synchronize()
        (out_k, grads_k), (out_e, grads_e) = results
        err = (out_k.float() - out_e.float()).abs().max().item()
        parts = [f"out err={err:.3e} (tol {out_tol:g})"]
        ok = err <= out_tol and bool(torch.isfinite(out_k).all().item())
        for key, a, b in zip(("dq", "dk", "dv", "dlogit_scale", "dbias"), grads_k, grads_e):
            gerr = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            ok = ok and gerr <= grad_tol * top
            parts.append(f"{key} err={gerr:.3e} (tol {grad_tol:g} x {top:.3e})")
        print(f"window_attention use_kernel {dtype_name(dtype)} q=({batch * nw},{heads},64,32) "
              f"compact mask of {nw}: " + ", ".join(parts), flush=True)
        if not ok:
            fail("window_attention through the kernel differs from the einsum formulation")
        del results, out_k, out_e, grads_k, grads_e, q, k, v, dout
    counts = launch_counts()
    require_launches("window_attention op path", counts, {wa.KERNEL: 2})
    if dict(wa.FWD_ROUTE_LAUNCHES) != {"fma": 1, "mma": 1}:
        fail("window_attention op path: expected the f32 launch on the FMA route and the bf16 "
             f"one on the tensor cores, got {dict(wa.FWD_ROUTE_LAUNCHES)}")
    records[wa.KERNEL]["launches"] += counts[wa.KERNEL]

    # K7: the probe's bottleneck chain, fused against unfused, forward and
    # backward. Both chains round y to bf16 from f32 sums in different orders,
    # and the unfused backward rounds each layer's input gradient to bf16
    # where the fused one keeps f32: differences of a few bf16 ulps per layer
    # over eight layers, hence 5e-2 of the largest gradient; the loss is a
    # mean over 50,176 rows, held to 1e-2 relative.
    probe = load_tool("probe_torch_conv_bn")
    m, wide, narrow = probe.STAGES[CHAIN_STAGE]
    device = torch.device("cuda", 0)
    params = probe.make_params(0, wide, narrow, CHAIN_LAYERS, device)
    x = probe.make_input(1, m, wide, device, torch.bfloat16)
    LAUNCHES.clear()
    conv_bn.ROUTE_LAUNCHES.clear()
    result = probe.parity(params, x)
    torch.cuda.synchronize()
    counts = launch_counts()
    if dict(conv_bn.ROUTE_LAUNCHES) != {"wgmma": CHAIN_LAYERS}:
        fail(f"conv_bn chain: expected {CHAIN_LAYERS} launches on the wgmma route, got "
             f"{dict(conv_bn.ROUTE_LAUNCHES)}")
    print(f"conv_bn chain stage {CHAIN_STAGE} M={m} {wide}<->{narrow} x{CHAIN_LAYERS} bf16: "
          f"loss unfused={result['loss_unfused']:.6f} fused={result['loss_fused']:.6f}; "
          "max grad err / max |grad|: "
          + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in result["grad_rel_err"].items())
          + f"; launches {counts}", flush=True)
    require_launches("conv_bn chain", counts, {conv_bn.KERNEL: CHAIN_LAYERS})
    records[conv_bn.KERNEL]["launches"] += counts[conv_bn.KERNEL]
    losses = (result["loss_unfused"], result["loss_fused"])
    if not all(math.isfinite(v_) for v_ in losses) \
            or abs(losses[0] - losses[1]) > 1e-2 * max(abs(losses[0]), 1e-3):
        fail(f"conv_bn chain: fused and unfused losses differ: {losses}")
    if not all(v_ <= 5e-2 for v_ in result["grad_rel_err"].values()):
        fail(f"conv_bn chain: fused and unfused gradients differ: {result['grad_rel_err']}")
    sps_u = probe.steps_per_second(probe.loss_unfused, params, x, 5)
    sps_f = probe.steps_per_second(probe.loss_fused, params, x, 5)
    print(f"conv_bn chain fwd+bwd (a smoke reading, host clock around 5 steps): unfused "
          f"{1e3 / sps_u:.3f} ms/step, fused {1e3 / sps_f:.3f} ms/step", flush=True)
    del params, x

    # K8: the op over the probe's four shapes against F.conv2d (cuDNN picks
    # its own algorithm and summation order: 2e-2 of the largest output)
    LAUNCHES.clear()
    for idx, (hw, ch) in enumerate(CONV_SHAPES):
        x, w = conv_inputs(RESNET_BATCH, hw, hw, ch, ch, torch.bfloat16, 60 + idx)
        got = conv_gemm.conv3x3_gemm(x, w).float()
        xl, wl = conv_library_inputs(x, w)
        ref = F.conv2d(xl, wl, padding=1).permute(0, 2, 3, 1).float()
        torch.cuda.synchronize()
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        print(f"conv3x3_gemm ({RESNET_BATCH},{hw},{hw},{ch}) against F.conv2d: max rel diff "
              f"{rel:.3e} (tol 2e-2)", flush=True)
        if not rel <= 2e-2:
            fail(f"conv3x3_gemm differs from F.conv2d at {hw}x{hw}x{ch}: {rel:.3e}")
        del x, w, got, ref, xl, wl
    counts = launch_counts()
    require_launches("conv3x3_gemm op path", counts, {conv_gemm.KERNEL: len(CONV_SHAPES)})
    records[conv_gemm.KERNEL]["launches"] += counts[conv_gemm.KERNEL]


def unzero_last_norms(model, images):
    """Give every zero-initialised last norm of a ResNet block unit scale, so
    the f32 reference exercises the convs inside the blocks (at the initial
    zero each block is the identity)."""
    import torch
    with torch.no_grad():
        for module in model.modules():
            if getattr(module, "zero_init", False):
                module.weight.fill_(1.0)


def calibrate_norms(model, images):
    """Give every BatchNorm the statistics of the reference images. At the
    initial law the eval-mode activations of EfficientNet-B0 and MobileNetV3
    fade through the blocks (their logits are of order 1e-14 and 1e-9), so
    the f32 reference would compare zeros; other images' statistics leave
    logits in the hundreds, where f32 rounding nears the 1e-3 limit."""
    import torch
    from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    kept = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 0.0  # Flax's momentum, the share kept: the batch's statistics
    model.train()
    with torch.no_grad():
        model({"image": images})
    model.eval()
    for m, momentum in zip(norms, kept):
        m.momentum = momentum


def require_fwd_routes(label, per_forward, forwards):
    """The plain-dot forwards' launches by (kernel, route) since the counter
    was cleared (``ops.window_attention_dot.FWD_ROUTE_LAUNCHES``) must be
    ``forwards`` times ``per_forward``; None checks nothing."""
    from torchok_tpu_torch.ops import window_attention_dot as dot
    if per_forward is None:
        return
    routes = {k: v for k, v in dot.FWD_ROUTE_LAUNCHES.items() if v}
    want = {k: n * forwards for k, n in per_forward.items() if n}
    print(f"{label} K3a/K4 launches by route: {routes}", flush=True)
    if routes != want:
        fail(f"{label}: expected K3a/K4 launches by route {want}, got {routes}")


def run_slice(label, config, per_forward, records, image_size, prepare_reference=None,
              fwd_routes=None):
    """The inference slice of one model: ``per_forward`` maps each kernel to
    its launches per forward; ``records`` maps it to its JSON record.
    ``prepare_reference(model, images)`` may change the model before the f32
    reference run on ``images``. ``fwd_routes``, if given, maps each (K3a or
    K4 kernel, route) to its launches per forward."""
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.ops import window_attention_dot as dot
    from torchok_tpu_torch.ops.common import LAUNCHES

    # warm-up run (cuDNN/cuBLAS plans, allocator) outside the measured one
    warm = copy.deepcopy(config)
    warm["trainer"]["limit_test_batches"] = 1
    run(warm, "test")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    dot.FWD_ROUTE_LAUNCHES.clear()
    trainer, logs = run(copy.deepcopy(config), "test")
    torch.cuda.synchronize()
    test_counts = launch_counts()
    require_fwd_routes(f"{label} test", fwd_routes, BATCHES)
    peak = torch.cuda.max_memory_allocated()
    stats = trainer.last_eval
    batch_size = config["data"]["TEST"][0]["dataloader"]["batch_size"]
    print(f"{label} test: {stats['images']} images in {stats['seconds']:.4f} s = "
          f"{stats['images'] / stats['seconds']:.2f} img/s (bs{batch_size} bf16, 3 batches, host "
          f"clock incl. loading); peak device memory {peak / 2**20:.1f} MiB; "
          f"launches {test_counts}; logs {logs}", flush=True)

    LAUNCHES.clear()
    dot.FWD_ROUTE_LAUNCHES.clear()
    trainer, preds = run(copy.deepcopy(config), "predict")
    torch.cuda.synchronize()
    predict_counts = launch_counts()
    require_fwd_routes(f"{label} predict", fwd_routes, BATCHES)
    print(f"{label} predict: {len(preds)} batches; launches {predict_counts}", flush=True)

    want = {k: n * BATCHES for k, n in per_forward.items()}
    require_launches(f"{label} test", test_counts, want)
    require_launches(f"{label} predict", predict_counts, want)
    for key in ("test/Accuracy", "test/F1Score"):
        if key not in logs or not math.isfinite(logs[key]):
            fail(f"{label}: {key} missing or not finite in {logs}")
    if len(preds) != BATCHES:
        fail(f"{label}: predict returned {len(preds)} batches, expected {BATCHES}")
    for p in preds:
        logits = p["prediction"]
        if logits.shape != (batch_size, 1000) or not np.isfinite(logits).all():
            fail(f"{label}: bad logits: shape {logits.shape}, "
                 f"finite {bool(np.isfinite(logits).all())}")

    # reference on a small input: the same weights in f32, kernels on the
    # card against the plain attention on the CPU
    model = trainer.state.model.float()
    image = torch.from_numpy(trainer.task.predict_dataloader()[0].dataset.images[:2])
    if tuple(image.shape[1:3]) != (image_size, image_size):
        fail(f"{label}: images are {tuple(image.shape)}, expected {image_size} px")
    image = (image.float() / 255.0 - 0.45) / 0.225
    batch = {"image": image.permute(0, 3, 1, 2).contiguous()}
    if prepare_reference is not None:
        prepare_reference(model, batch["image"].cuda())
    with torch.inference_mode():
        on_card = model({"image": batch["image"].cuda()})["prediction"].cpu()
        on_cpu = model.cpu()({"image": batch["image"]})["prediction"]
    err = (on_card - on_cpu).abs().max().item()
    # other summation orders through every layer, f32 on both sides (TF32 off
    # for matmul and cuDNN)
    print(f"{label} reference (f32, 2 images, card vs CPU): max_abs_err={err:.3e} "
          f"(tol 1e-3), logit scale {on_cpu.abs().max().item():.3e}", flush=True)
    if not err <= 1e-3:
        fail(f"{label}: model logits on the card differ from the CPU run by {err:.3e}")
    for kernel, count in test_counts.items():
        records[kernel]["launches"] += count


def smoke_train_config(epochs: int, config=None, size: int = 256, batch: int = 128):
    """A train recipe (``TRAIN_CONFIG`` by default) with the train set cut to
    one batch, repeated for ``epochs`` one-step epochs (so each epoch's
    ``train/loss`` is one step's loss), one sanity validation batch and one
    validation batch at the end."""
    cfg = copy.deepcopy(TRAIN_CONFIG if config is None else config)
    cfg["data"]["TRAIN"] = _synthetic(batch, False, True, size, batch)
    cfg["data"]["VALID"] = _synthetic(batch, False, False, size, batch, seed=1)
    cfg["trainer"].update(max_epochs=epochs, check_val_every_n_epoch=epochs)
    return cfg


def run_train_slice(label, config, size, per_forward, per_backward, must_move, records,
                    per_route=None, fwd_routes=None):
    """The train slice of one model: ``per_forward`` / ``per_backward`` map
    each kernel to its launches per forward / per train step; ``must_move``
    lists name fragments of parameters that have to change; ``per_route``,
    if given, maps each (K3b or K5 kernel, route) to its launches per train
    step (``ops.window_attention_dot.ROUTE_LAUNCHES``), ``fwd_routes`` each
    (K3a or K4 kernel, route) to its launches per forward."""
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops import window_attention_dot as dot
    from torchok_tpu_torch.ops.common import LAUNCHES

    class Recorder(Callback):
        def __init__(self):
            self.epochs = []
            self.initial = {}

        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.state_dict().items()}

        def on_epoch_end(self, trainer, task, logs):
            self.epochs.append(dict(logs))

    batch = config["data"]["TRAIN"][0]["dataloader"]["batch_size"]
    # warm-up run (cuBLAS plans, allocator, optimizer kernels) outside the measured one
    run(smoke_train_config(2, config, size, batch), "train")
    torch.cuda.synchronize()

    recorder = Recorder()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    dot.ROUTE_LAUNCHES.clear()
    dot.FWD_ROUTE_LAUNCHES.clear()
    trainer, logs = run(smoke_train_config(TRAIN_STEPS, config, size, batch), "train",
                        [recorder])
    torch.cuda.synchronize()
    counts = launch_counts()
    routes = {k: v for k, v in dot.ROUTE_LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    stats = trainer.last_fit
    losses = [e["train/loss"] for e in recorder.epochs]
    print(f"{label} train: {stats['steps']} steps, {stats['images']} images in "
          f"{stats['seconds']:.4f} s = {stats['images'] / stats['seconds']:.2f} img/s "
          f"(bs{batch} bf16, a smoke reading: host clock, first fetch to each step's loss "
          f"read-back, one step per epoch); peak device memory {peak / 2**20:.1f} MiB; "
          f"launches {counts}", flush=True)
    print(f"{label} train losses per step: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    if per_route is not None:
        print(f"{label} train K3b/K5 launches by route: {routes}", flush=True)
        if routes != {k: n * TRAIN_STEPS for k, n in per_route.items() if n}:
            fail(f"{label} train: expected K3b/K5 launches by route "
                 f"{ {k: n * TRAIN_STEPS for k, n in per_route.items()} }, got {routes}")
    print(f"{label} last epoch logs: {logs}", flush=True)

    eval_batches = 2  # one sanity batch, one validation batch after the last epoch
    require_fwd_routes(f"{label} train", fwd_routes, TRAIN_STEPS + eval_batches)
    want = {k: n * (TRAIN_STEPS + eval_batches) for k, n in per_forward.items()}
    want.update({k: n * TRAIN_STEPS for k, n in per_backward.items()})
    require_launches(f"{label} train", counts, want)
    if stats["steps"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        fail(f"{label} train: expected {TRAIN_STEPS} steps, got {stats['steps']} "
             f"({len(losses)} logged)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label} train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label} train: the loss did not fall on the repeated batch: {losses}")
    for key in ("valid/Accuracy", "valid/loss"):
        if key not in logs or not math.isfinite(logs[key]):
            fail(f"{label}: {key} missing or not finite in {logs}")
    moved = dict.fromkeys(must_move, False)
    for name, value in trainer.state.model.state_dict().items():
        if not bool(torch.isfinite(value).all().item()):
            fail(f"{label} train: parameter {name} is not finite")
        for key in moved:
            if key in name and not torch.equal(value, recorder.initial[name]):
                moved[key] = True
    if not all(moved.values()):
        fail(f"{label} train: parameters that never changed: "
             f"{[k for k, v in moved.items() if not v]}")
    for kernel, count in counts.items():
        records[kernel]["launches"] += count


def gradient_reference(label, config, size, want, probe):
    """One f32 forward + backward of the full-width model on two images: the
    card (the kernels in ``want``, with their launch counts) against the CPU
    (plain versions), all parameter gradients. ``probe`` names a parameter
    that must be among them."""
    import torch
    import torchok_tpu_torch  # noqa: F401 — registers the components
    from torchok_tpu_torch.constructor import TASKS
    from torchok_tpu_torch.constructor.config import config_from_dict
    from torchok_tpu_torch.constructor.config_structure import merge_structured
    from torchok_tpu_torch.ops.common import LAUNCHES

    cfg = copy.deepcopy(config)
    cfg["task"]["params"]["backbone_params"]["drop_path_rate"] = 0.0
    config = merge_structured(config_from_dict(cfg))
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    generator = torch.Generator()
    generator.manual_seed(5)
    task.init_weights(generator)
    image = torch.randn((2, 3, size, size), generator=generator)
    target = torch.tensor([3, 977])

    def grads(device):
        model = task.model.to(device).train()
        model.zero_grad(set_to_none=True)
        out = model({"image": image.to(device), "target": target.to(device)})
        total, _ = task.compute_loss(out)
        total.backward()
        # parameters outside the classification path (SwinV2's three inner
        # feature norms) get no gradient
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                if p.grad is not None}, total.item()

    LAUNCHES.clear()
    on_card, loss_card = grads(torch.device("cuda", 0))
    torch.cuda.synchronize()
    counts = launch_counts()
    on_cpu, loss_cpu = grads(torch.device("cpu"))
    if set(on_card) != set(on_cpu) or not any(probe in n for n in on_cpu):
        fail(f"{label} gradient reference: the card and the CPU gave gradients to "
             "different parameters")
    worst_name, worst, largest = "", 0.0, 0.0
    for name, ref in on_cpu.items():
        err = (on_card[name] - ref).abs().max().item()
        largest = max(largest, ref.abs().max().item())
        if err > worst:
            worst_name, worst = name, err
    tol = 1e-3 * largest  # f32 on both sides, other summation orders through every block
    print(f"{label} gradient reference (f32, 2 images, card kernels vs CPU plain): loss "
          f"{loss_card:.6f} vs {loss_cpu:.6f}; max_abs_err={worst:.3e} at {worst_name} "
          f"(tol 1e-3 x largest gradient {largest:.3e} = {tol:.3e}); launches {counts}",
          flush=True)
    require_launches(f"{label} gradient reference (card)", counts, want)
    if not worst <= tol:
        fail(f"{label}: gradients on the card differ from the CPU run by {worst:.3e} "
             f"at {worst_name}")


def sass_functions(kernel, library=None) -> dict:
    """The SASS of each function in the built library of ``kernel`` (or in
    the library at the path ``library``), by name."""
    import shutil
    from torchok_tpu_torch.utils.cuda_build import library_path
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library or library_path(kernel))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    return {part.split("\n", 1)[0].strip(): part for part in sass.split("Function : ")[1:]}


def sass_has_hgmma(kernel) -> bool:
    """Whether the built library of ``kernel`` holds HGMMA (wgmma) in its SASS."""
    return any("HGMMA" in text for text in sass_functions(kernel).values())


def ptxas_usage(kernel, needle):
    """(function, registers, spill stores, spill loads) of each entry function
    of ``kernel``'s build whose mangled name matches the regular expression
    ``needle``, from the compiler's ``-Xptxas -v`` output."""
    from torchok_tpu_torch.utils.cuda_build import build_log
    found, name, spills = [], None, (0, 0)
    for ln in build_log(kernel).splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "bytes spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            spills = (nums[1], nums[2])  # stack frame, spill stores, spill loads
        elif "Used" in ln and "registers" in ln and name and re.search(needle, name):
            regs = int(ln.split("Used")[1].split()[0])
            found.append((name, regs) + spills)
            name = None
    return found


def check_hmma(kind, library, needle, count=4):
    """The ``count`` tensor-core kernels of ``library``'s build whose mangled
    names match the regular expression ``needle``: registers and spills, and
    HMMA in their SASS."""
    usage = ptxas_usage(library, needle)
    for name, regs, stores, loads in usage:
        print(f"{kind} mma {name}: {regs} registers, spill stores {stores} B, "
              f"spill loads {loads} B", flush=True)
    sass = {n: t for n, t in sass_functions(library).items() if re.search(needle, n)}
    with_hmma = sorted(n for n, t in sass.items() if "HMMA" in t)
    print(f"{kind} SASS has HMMA in {len(with_hmma)} of its {len(sass)} tensor-core kernels",
          flush=True)
    if len(usage) != count or len(sass) != count or len(with_hmma) != count:
        fail(f"{kind}'s tensor-core kernels: {len(usage)} in the build log, {len(sass)} in the "
             f"SASS, {len(with_hmma)} with HMMA (expected {count} each)")


def check_mma_build(kind, library, needle, route, count=4, windows=None):
    """The bf16 tensor-core kernels of K1 to K5 (``check_hmma``) and the
    route each window size (by default those of ``SWIN_MODELS``) takes per
    dtype (``route``: bf16 on the tensor-core kernel, f32 on the FMA
    templates or the key-tiled path)."""
    import torch
    check_hmma(kind, library, needle, count)
    if windows is None:
        windows = sorted({st[4] for _, stages in SWIN_MODELS.values() for st in stages})
    for ws in windows:
        routes = {dtype_name(t): route(t, ws) for t in (torch.bfloat16, torch.float32)}
        print(f"{kind} route L={ws * ws} (ws {ws}): bf16 {routes['bfloat16']}, "
              f"f32 {routes['float32']}", flush=True)
        if routes["bfloat16"] != "mma" or routes["float32"] == "mma":
            fail(f"{kind} at ws {ws}: bf16 must take the tensor-core kernel and f32 the FMA "
                 f"kernels, got {routes}")


def run_swinv2_variants(records):
    """Every registered SwinV2 variant at its own input size, batch 1, bf16
    autocast, random weights from a seed: one K1 launch per block (windows 6
    to 24, L 36 to 576), no plain call, finite features."""
    import torch
    from torchok_tpu_torch.constructor import BACKBONES
    from torchok_tpu_torch.models.backbones.swin import _VARIANTS
    from torchok_tpu_torch.ops import swin_attention as swin
    from torchok_tpu_torch.ops.common import LAUNCHES
    device = torch.device("cuda", 0)
    for name, cfg in sorted(_VARIANTS.items()):
        size = cfg.get("img_size", 256)
        grid = [size // 4 // 2 ** i for i in range(len(cfg["depths"]))]
        windows = [min(g_, cfg["window_size"]) ** 2 for g_ in grid]
        torch.manual_seed(0)
        model = BACKBONES.get(name)().to(device).eval()
        image = torch.randn((1, 3, size, size), device=device)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            feat = model(image)
        torch.cuda.synchronize()
        counts = launch_counts()
        finite = bool(torch.isfinite(feat).all().item())
        print(f"{name} ({size}x{size}, bs1, bf16): L per stage {windows}, features "
              f"{tuple(feat.shape)}, finite {finite}; launches {counts}", flush=True)
        require_launches(f"{name} forward", counts, {swin.KERNEL: sum(cfg["depths"])})
        if not finite:
            fail(f"{name}: features are not finite")
        records[swin.KERNEL]["launches"] += counts[swin.KERNEL]
        del model, image, feat


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "torchok_tpu_torch", "csrc")):
        fail(f"torchok_tpu_torch is not beside {__file__}: run it from a checkout")
    sys.path.insert(0, repo)
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torchok_tpu_torch.ops import conv_bn, conv_gemm, mbconv_fused
    from torchok_tpu_torch.ops import swin_attention as swin
    from torchok_tpu_torch.ops import window_attention as wa
    from torchok_tpu_torch.ops import window_attention_dot as dot
    from torchok_tpu_torch.utils.cuda_build import build_log, load_libraries
    kernels = (swin.KERNEL, swin.KERNEL_BWD) + dot.KERNELS + (wa.KERNEL, conv_bn.KERNEL,
                                                              conv_gemm.KERNEL,
                                                              mbconv_fused.KERNEL)
    start = time.perf_counter()
    load_libraries(kernels)
    print(f"built {', '.join(kernels)} side by side in {time.perf_counter() - start:.2f} s",
          flush=True)
    for kernel in kernels:
        # registers, shared memory and spills of each instantiation
        print("\n".join(ln for ln in build_log(kernel).splitlines()
                        if not ln.startswith("ptxas info    : Compiling")
                        and "Function properties" not in ln), flush=True)

    for kind, kernel in (("K7", conv_bn.KERNEL), ("K8", conv_gemm.KERNEL)):
        has_hgmma = sass_has_hgmma(kernel)
        print(f"{kind} SASS has HGMMA: {str(has_hgmma).lower()}", flush=True)
        if not has_hgmma:
            fail(f"the bf16 route of {kernel} was not compiled to wgmma (no HGMMA in its SASS)")

    # K1: swin_fwd_kernel<tile rows / 16, images a block>; K2: its two passes,
    # masked and unmasked
    check_mma_build("K1", swin.KERNEL, "swin_fwd_kernel", swin.forward_route)
    # the tensor-core backward's passes: bwd_{dq,dkdv}_kernel<kCosine, kShifted,
    # kHasBias, kGlobal>, K2 masked and unmasked, K3b with and without a bias, K5
    check_mma_build("K2", swin.KERNEL_BWD, "bwd_d", swin.backward_route)
    dot_windows = sorted({st[4] for st in GCVIT_STAGES + DAVIT_STAGES})
    for kind, kernel, count in (("K3b", dot.KERNEL_BWD, 4), ("K5", dot.KERNEL_GLOBAL_BWD, 2)):
        check_mma_build(kind, kernel, "bwd_d",
                        lambda dtype, ws, k=kernel: dot.backward_route(k, dtype), count,
                        dot_windows)
    # the tensor-core forward's plain modes: swin_fwd_kernel<tile rows / 16,
    # images, kCosine false, kHasBias, kGlobal>, K3a with and without a bias,
    # K4 above L = 64, and K4's window walk global_fwd_kernel<tile rows / 16>
    for kind, kernel in (("K3a", dot.KERNEL), ("K4", dot.KERNEL_GLOBAL)):
        check_mma_build(kind, kernel, PLAIN_FWD_MMA,
                        lambda dtype, ws, k=kernel: dot.forward_route(k, dtype), 4, dot_windows)
    # K9's cluster kernels (k = 1, 3, 5, 7); K6's mw_fwd_kernel<L, kHasMask>
    check_hmma("K9 cluster", mbconv_fused.KERNEL, "mbconv_cluster_kernel")
    check_hmma("K6", wa.KERNEL, MW_MMA)
    k1, k2 = check_k1(), check_k2()
    k3a, k3b = check_k3()
    k4, k5 = check_k4(), check_k5()
    k6, k7, k8 = check_k6(), check_k7(), check_k8()
    mbconv_probe = load_tool("probe_torch_mbconv_fused")
    b0 = b0_cases(mbconv_probe, torch.device("cuda", 0))
    k9 = check_k9(mbconv_probe, b0)
    all_records = (k1, k2, k3a, k3b, k4, k5, k6, k7, k8, k9)
    records = {r["name"]: r for r in all_records}
    run_op_paths(records)
    run_mbconv_path(mbconv_probe, b0, records)
    del b0

    swin_fwd, swin_bwd = {swin.KERNEL: 12}, {swin.KERNEL_BWD: 12}
    run_slice("swinv2_tiny", SLICE_CONFIG, swin_fwd, records, 256)
    run_train_slice("swinv2_tiny", TRAIN_CONFIG, 256, swin_fwd, swin_bwd,
                    ("qkv", "cpb_mlp", "logit_scale"), records)
    gradient_reference("swinv2_tiny", TRAIN_CONFIG, 256, {**swin_fwd, **swin_bwd}, "cpb_mlp")
    # window 16: 10 blocks at L = 256 and 2 at L = 64 per forward
    run_slice("swinv2_tiny_window16", WINDOW16_SLICE_CONFIG, swin_fwd, records, 256)
    run_train_slice("swinv2_tiny_window16", WINDOW16_TRAIN_CONFIG, 256, swin_fwd, swin_bwd,
                    ("qkv", "cpb_mlp", "logit_scale"), records)
    gradient_reference("swinv2_tiny_window16", WINDOW16_TRAIN_CONFIG, 256,
                       {**swin_fwd, **swin_bwd}, "cpb_mlp")
    # window 24 at 384: 22 blocks at L = 576 and 2 at L = 144
    run_slice("swinv2_base_window12to24_384", BASE384_SLICE_CONFIG, {swin.KERNEL: 24}, records,
              384)
    run_swinv2_variants(records)

    gcvit_fwd = {dot.KERNEL: GCVIT_LOCAL, dot.KERNEL_GLOBAL: GCVIT_GLOBAL}
    gcvit_bwd = {dot.KERNEL_BWD: GCVIT_LOCAL, dot.KERNEL_GLOBAL_BWD: GCVIT_GLOBAL}
    # bf16 autocast: every K3a and K4 launch on the tensor cores
    gcvit_fwd_routes = {(dot.KERNEL, "mma"): GCVIT_LOCAL, (dot.KERNEL_GLOBAL, "mma"): GCVIT_GLOBAL}
    run_slice("gcvit_tiny", GCVIT_SLICE_CONFIG, gcvit_fwd, records, 224,
              fwd_routes=gcvit_fwd_routes)
    # stages.0.blocks.1 is a global block: its qkv emits k and v only
    run_train_slice("gcvit_tiny", GCVIT_TRAIN_CONFIG, 224, gcvit_fwd, gcvit_bwd,
                    ("relative_position_bias_table", "stages.0.blocks.1.attn.qkv",
                     "global_block"), records,
                    {(dot.KERNEL_BWD, "mma"): GCVIT_LOCAL,
                     (dot.KERNEL_GLOBAL_BWD, "mma"): GCVIT_GLOBAL}, gcvit_fwd_routes)
    gradient_reference("gcvit_tiny", GCVIT_TRAIN_CONFIG, 224, {**gcvit_fwd, **gcvit_bwd},
                       "relative_position_bias_table")
    run_train_slice("davit_t", DAVIT_TRAIN_CONFIG, 224, {dot.KERNEL: DAVIT_SPATIAL},
                    {dot.KERNEL_BWD: DAVIT_SPATIAL}, ("main_blocks.0.0.0.attn.qkv",), records,
                    {(dot.KERNEL_BWD, "mma"): DAVIT_SPATIAL}, {(dot.KERNEL, "mma"): DAVIT_SPATIAL})

    # the JAX ResNet reaches no Pallas kernel, so the port's reaches none of
    # the hand-written kernels: every counter stays at 0 through these runs
    run_slice("resnet50", RESNET_SLICE_CONFIG, {}, records, 224, unzero_last_norms)
    run_train_slice("resnet50", RESNET_TRAIN_CONFIG, 224, {}, {},
                    ("layer1.0.conv1.weight", "layer4.2.bn3.weight", "layer3.5.bn2.running_var",
                     "head"), records)
    print("resnet50: 0 launches of every hand-written kernel in test, predict and train, as "
          "the JAX ResNet calls no Pallas kernel either (K7 and K8 are reached through "
          "their ops above)", flush=True)

    # the JAX EfficientNet and MobileNetV3 reach no Pallas kernel either (K9 is
    # reached through its op above): every counter stays at 0
    run_slice("efficientnet_b0", EFFNET_SLICE_CONFIG, {}, records, 224, calibrate_norms)
    run_train_slice("efficientnet_b0", EFFNET_TRAIN_CONFIG, 224, {}, {},
                    ("conv_stem.weight", "blocks.5.3.se.fc1.weight", "blocks.6.0.bn3.running_var",
                     "head"), records)
    run_slice("mobilenetv3_large_100", MNV3_SLICE_CONFIG, {}, records, 224, calibrate_norms)
    print("efficientnet_b0 (test, predict, train) and mobilenetv3_large_100 (test): 0 launches "
          "of every hand-written kernel", flush=True)

    print(json.dumps({"kernels": list(all_records)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
