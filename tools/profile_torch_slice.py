#!/usr/bin/env python3
"""Where the device time of the torchok_tpu_torch slices goes, on one NVIDIA
GPU.

    python tools/profile_torch_slice.py [--model swinv2|swinv2_tiny_window16_256|gcvit_tiny|
        davit_t|resnet50|efficientnet_b0|mobilenetv3_large_100] [--mode eval|train]
        [--batches 3] [--trace PATH]

``--mode eval`` builds the model's inference slice from ``chip_smoke``'s
config (bs 128; resnet50, efficientnet_b0 and mobilenetv3_large_100 bs 256;
bf16 autocast; davit_t and mobilenetv3_large_100 have one recipe only, so
davit_t's eval slice is its train recipe's validation data and
mobilenetv3_large_100 has no train slice) through
``torchok_tpu_torch.__main__.run`` (one warm-up batch) and profiles the
trainer's eval loop; ``--mode train`` builds the train slice from
``chip_smoke``'s train config (two warm-up steps) and profiles the trainer's
train step on ``--batches`` batches of its loader.
Either runs under ``torch.profiler`` and prints: device time by kernel (top
25), device time by kind of kernel, the loop's wall time and the share of it
with no kernel running. ``--trace`` writes a Chrome trace. Timing runs with
the profiler on; the slices' own img/s come from ``chip_smoke.py``, without it.
"""
from __future__ import annotations

import argparse
import collections
import copy
import importlib.util
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KINDS = [  # first match wins
    ("K9 mbconv_fused_fwd", r"mbconv_(pass|gate)"),
    # the bf16 bias of K3b and K5 at L = 49 in rows of 52 floats (one set-up
    # kernel for both)
    ("K3b/K5 bias pad", r"pad_bias"),
    # K2's bf16 set-up (swin_mma::normalize_k, combine_bias_mask), its f32
    # key-tiled kernel, its entry's reduce (its passes: _MMA_BWD below)
    ("K2 swin_attention_bwd", r"swin_attention_bwd|swin_mma|window_attention_bwd_tiled"),
    # K1's bf16 kernel and its set-up (swin_fwd::...), its f32 key-tiled kernel
    ("K1 swin_attention_fwd", r"swin_attention_fwd|swin_fwd|window_attention_fwd_tiled"),
    ("K3b/K5 dbias reduce", r"window_attention_bwd_reduce"),
    ("K6 window_attention_mw_fwd", r"window_attention_mw_fwd"),
    ("K7 matmul_bn_fwd (+ reduce)", r"matmul_bn_(fwd|reduce)"),
    ("K8 conv3x3_gemm", r"conv3x3_gemm"),
    ("optimizer (Adam, foreach)", r"multi_tensor_apply|[Aa]dam"),
    ("max pool", r"max_pool|MaxPool"),
    # cuDNN names its depthwise kernels by one channel per group (c1_k1)
    ("depthwise conv", r"[Dd]epthwise|2d_c1_k1"),
    # before the convs (cuDNN names its BatchNorm kernels too); only the ResNets have any
    ("BatchNorm", r"batch_norm|BatchNorm|batchnorm|bn_fw|bn_bw"),
    ("conv (stem, downsample, embed)", r"conv|cudnn|implicit_gemm|xmma_fprop|wgrad|dgrad"),
    ("GEMM (Linear)", r"gemm|cutlass|nvjet|sm90_xmma|cublas"),
    ("LayerNorm", r"layer_norm|LayerNorm"),
    ("GELU", r"gelu|GeluCUDAKernel"),
    ("SiLU, hard-swish", r"silu|hardswish|hardsigmoid"),
    ("softmax/sigmoid (cpb bias)", r"softmax|sigmoid"),
    ("roll/pad/cat/copy (incl. H2D)", r"roll|pad|cat|copy|Copy|Memcpy|Memset|index|gather|permute"),
    ("other elementwise", r"elementwise|vectorized|unrolled"),
    ("reductions", r"reduce|Reduce"),
]

# The window attention templates serve K1/K2 (cosine), K3a/K3b and K4/K5
# (global queries): template <T, KC, kHasBias, kGlobal, kCosine, kHasMask>.
_TEMPLATE = re.compile(r"window_attention_(fwd|bwd)_kernel")
_TEMPLATE_KINDS = {("fwd", "cosine"): "K1 swin_attention_fwd",
                   ("bwd", "cosine"): "K2 swin_attention_bwd",
                   ("fwd", "global"): "K4 window_attention_global_fwd",
                   ("bwd", "global"): "K5 window_attention_global_bwd",
                   ("fwd", "plain"): "K3a window_attention_fwd",
                   ("bwd", "plain"): "K3b window_attention_bwd"}


# The bf16 tensor-core backward's two passes serve K2 (cosine), K3b and K5
# (global queries): swin_mma::bwd_{dq,dkdv}_kernel<kCosine, kShifted,
# kHasBias, kGlobal>.
_MMA_BWD = re.compile(r"bwd_(?:dq|dkdv)_kernel")


def _bool_flags(name: str, kernel: str):
    """The bool template arguments of a kernel whose name matches ``kernel``,
    from its demangled (``<..., true, false, ...>``) or mangled (``Lb1E``)
    name."""
    m = re.search(kernel + r"<([^>]*)>", name)
    if m:
        return [a.strip() in ("true", "(bool)1") for a in m.group(1).split(",")
                if a.strip() in ("true", "false", "(bool)1", "(bool)0")]
    return [b == "1" for b in re.findall(r"Lb([01])E", name)]


def kind_of(name: str) -> str:
    if _MMA_BWD.search(name):
        flags = _bool_flags(name, r"bwd_(?:dq|dkdv)_kernel")
        if len(flags) == 4:
            cosine, _, _, is_global = flags
            return _TEMPLATE_KINDS[("bwd", "cosine" if cosine else
                                    "global" if is_global else "plain")]
    m = _TEMPLATE.search(name)
    flags = _bool_flags(name, r"window_attention_(?:fwd|bwd)_kernel") if m else []
    if len(flags) == 4:
        _, is_global, cosine, _ = flags
        mode = "cosine" if cosine else "global" if is_global else "plain"
        return _TEMPLATE_KINDS[(m.group(1), mode)]
    for kind, pattern in KINDS:
        if re.search(pattern, name):
            return kind
    return "other"


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=("swinv2", "swinv2_tiny_window16_256", "gcvit_tiny",
                                            "davit_t", "resnet50", "efficientnet_b0",
                                            "mobilenetv3_large_100"),
                        default="swinv2")
    parser.add_argument("--mode", choices=("eval", "train"), default="eval")
    parser.add_argument("--batches", type=int, default=3)
    parser.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a CUDA device")
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from torch.profiler import ProfilerActivity, profile
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.constructor.config_structure import Phase

    print(chip_smoke.card_line())
    train_config = {"swinv2": chip_smoke.TRAIN_CONFIG,
                    "swinv2_tiny_window16_256": chip_smoke.WINDOW16_TRAIN_CONFIG,
                    "gcvit_tiny": chip_smoke.GCVIT_TRAIN_CONFIG,
                    "davit_t": chip_smoke.DAVIT_TRAIN_CONFIG,
                    "resnet50": chip_smoke.RESNET_TRAIN_CONFIG,
                    "efficientnet_b0": chip_smoke.EFFNET_TRAIN_CONFIG}.get(args.model)
    if args.mode == "train" and train_config is None:
        sys.exit(f"profile_torch_slice: {args.model} has no train recipe")
    if args.mode == "eval":
        cfg = {"swinv2": chip_smoke.SLICE_CONFIG,
               "swinv2_tiny_window16_256": chip_smoke.WINDOW16_SLICE_CONFIG,
               "gcvit_tiny": chip_smoke.GCVIT_SLICE_CONFIG,
               "resnet50": chip_smoke.RESNET_SLICE_CONFIG,
               "efficientnet_b0": chip_smoke.EFFNET_SLICE_CONFIG,
               "mobilenetv3_large_100": chip_smoke.MNV3_SLICE_CONFIG}.get(args.model)
        if cfg is None:
            cfg = {k: v for k, v in train_config.items()
                   if k not in ("joint_loss", "optimization", "data")}
            cfg["data"] = {"TEST": train_config["data"]["VALID"]}
        cfg = copy.deepcopy(cfg)
        cfg["trainer"]["limit_test_batches"] = 1  # warm-up: kernels built, plans chosen
        trainer, _ = run(cfg, "test")
        task = trainer.task
        loaders = task.test_dataloader()
        trainer._install_device_fns(loaders, train=False)
        eval_step = trainer._make_eval_step(task)

        def loop():
            trainer._run_eval(task, eval_step, loaders, Phase.TEST, args.batches)
    else:
        cfg = copy.deepcopy(train_config)
        cfg["trainer"].update(max_epochs=1, limit_train_batches=2, limit_val_batches=1,
                              num_sanity_val_steps=0)  # warm-up: two steps, one val batch
        trainer, _ = run(cfg, "train")
        task = trainer.task
        loader = task.train_dataloader()[0]
        trainer._install_device_fns([loader], train=True)
        train_step = trainer._make_train_step(task)
        trainer.state.model.train()

        def loop():
            for i, batch in enumerate(loader):
                if i >= args.batches:
                    break
                train_step(batch)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

    # device events only, without the spans that mirror host annotations
    # (``Optimizer.step#Adam.step``) over the kernels they enclose
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_start, cur_end = 0.0, None, None
    for s, e in spans:  # union of kernel intervals
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy_us += cur_end - cur_start

    by_name = collections.Counter()
    count = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    total_us = sum(by_name.values())
    by_kind = collections.Counter()
    for name, us in by_name.items():
        by_kind[kind_of(name)] += us

    n = args.batches
    batch_size = (cfg["data"].get("TRAIN") or cfg["data"]["TEST"])[0]["dataloader"]["batch_size"]
    print(f"{args.model} {args.mode} loop: {n} batches of {batch_size}, wall {wall_ms:.3f} ms "
          f"(profiler on), "
          f"kernel time {total_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / 1e3 / wall_ms:.4f}")
    print(f"{'kind':32s} {'ms/batch':>10s} {'share':>7s}")
    for kind, us in by_kind.most_common():
        print(f"{kind:32s} {us / 1e3 / n:10.4f} {us / total_us:7.4f}")
    print(f"{'kernel':90s} {'calls':>6s} {'ms/batch':>10s} {'share':>7s}")
    for name, us in by_name.most_common(25):
        print(f"{name[:90]:90s} {count[name]:6d} {us / 1e3 / n:10.4f} {us / total_us:7.4f}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
                          "temperature.gpu", "--format=csv"], capture_output=True,
                         text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
