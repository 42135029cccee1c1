#!/usr/bin/env python3
"""Smoke run of torchok_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the versions.
2. Builds the port's CUDA kernels from ``torchok_tpu_torch/csrc`` with nvcc.
3. Holds each kernel against its plain PyTorch version on the card at each
   stage shape of the SwinV2-tiny slice, at batch 8 in f32 (max abs error
   <= 1e-4 with TF32 off) and bf16, and at the slice's own batch 128 in bf16
   (<= 2e-2 against the plain version in bf16), and times both with CUDA
   events (median of 20 after warm-up).
4. Drives the slice through ``torchok_tpu_torch.__main__.run`` with
   ``SLICE_CONFIG`` (equal to configs/classification_swinv2_tiny_synthetic.yaml):
   swinv2_tiny_window8_256 at full width, 256x256, 1000 classes, batch 128,
   bf16 autocast, 3 batches, random weights from the seed. The launch
   counters are zeroed just before each run and read just after: the kernel
   must launch once per SwinBlock per batch (12 x 3) and the plain version
   never. The logits must be finite, Accuracy and F1Score reported, and the
   model must agree in f32 with its CPU run (plain attention) on two images.
5. Prints ``{"kernels": [...]}``, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line. Without a CUDA
device, or without the package beside this script, it exits 1 at once.
"""
from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

_METRIC = {"params": {"task": "multiclass", "num_classes": 1000},
           "mapping": {"preds": "prediction", "target": "target"}}
_PHASE_DATA = [{
    "dataloader": {"batch_size": 128, "num_workers": 2, "drop_last": False, "shuffle": False},
    "dataset": {
        "name": "SyntheticClassificationDataset",
        "params": {"num_samples": 384, "num_classes": 1000, "image_size": [256, 256]},
        "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}],
    },
}]
SLICE_CONFIG = {
    "task": {
        "name": "ClassificationTask",
        "params": {
            "backbone_name": "swinv2_tiny_window8_256",
            "backbone_params": {"pretrained": False, "in_channels": 3},
            "pooling_name": "Pooling",
            "head_name": "ClassificationHead",
            "head_params": {"num_classes": 1000},
            "inputs": [{"shape": [3, 256, 256], "dtype": "float32"}],
        },
    },
    "data": {"TEST": _PHASE_DATA, "PREDICT": _PHASE_DATA},
    "trainer": {"accelerator": "gpu", "precision": 16,
                "limit_test_batches": 3, "limit_predict_batches": 3},
    "seed_params": {"seed": 42},
    "metrics": [{"name": "Accuracy", **_METRIC}, {"name": "F1Score", **_METRIC}],
}
BATCHES = 3
BLOCKS = (2, 2, 6, 2)  # SwinBlocks per stage of swinv2_tiny
# (Hp, Wp, C, heads) of each stage at 256x256 input; window 8, head dim 32
STAGES = ((64, 64, 96, 3), (32, 32, 192, 6), (16, 16, 384, 12), (8, 8, 768, 24))
CHECK_BATCH = 8
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}


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


def attention_inputs(b, hp, wp, c, heads, dtype, masked, seed):
    import torch
    from torchok_tpu_torch.models.backbones.swin import shift_window_mask
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    qkv = (0.5 * torch.randn((b, hp, wp, 3 * c), generator=g, device=dev)).to(dtype)
    logit_scale = math.log(10.0) + 0.5 * torch.randn((heads,), generator=g, device=dev)
    scale = torch.exp(torch.clamp(logit_scale, max=math.log(100.0)))
    bias = 16 * torch.sigmoid(torch.randn((heads, 64, 64), generator=g, device=dev))
    mask = shift_window_mask(hp, wp, 8, 4).to(dev) if masked else None
    return qkv, scale, bias, mask


def check_k1():
    """K1 against its plain version at every stage shape; returns the JSON
    record for the kernel."""
    import torch
    from torchok_tpu_torch.ops import swin_attention as ops
    worst = {"float32": 0.0, "bfloat16": 0.0}
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for stage, (hp, wp, c, heads) in enumerate(STAGES, 1):
            for masked in ((False, True) if hp > 8 else (False,)):
                args = attention_inputs(CHECK_BATCH, hp, wp, c, heads, dtype, masked, stage)
                got = ops.swin_attention_fwd_cuda(*args, 8, heads)
                ref = ops.swin_attention_fwd_plain(*args, 8, heads)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                finite = bool(torch.isfinite(got).all().item())
                k_ms = median_ms(lambda: ops.swin_attention_fwd_cuda(*args, 8, heads))
                p_ms = median_ms(lambda: ops.swin_attention_fwd_plain(*args, 8, heads))
                worst[name] = max(worst[name], err)
                print(f"K1 {name} stage{stage} qkv=({CHECK_BATCH},{hp},{wp},{3 * c}) "
                      f"heads={heads} mask={masked}: max_abs_err={err:.3e} "
                      f"(tol {TOLERANCE[name]:g}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}",
                      flush=True)
                if not finite or not err <= TOLERANCE[name]:
                    failures.append(f"{name} stage{stage} mask={masked}: err {err:.3e}")

    # the slice's own shapes: bf16, batch 128, every block of a forward
    batch = SLICE_CONFIG["data"]["TEST"][0]["dataloader"]["batch_size"]
    total_k = total_p = 0.0
    for stage, ((hp, wp, c, heads), depth) in enumerate(zip(STAGES, BLOCKS), 1):
        for masked in ((False, True) if hp > 8 else (False,)):
            n = depth // 2 if hp > 8 else depth  # shifted blocks alternate
            args = attention_inputs(batch, hp, wp, c, heads, torch.bfloat16, masked, 10 + stage)
            got = ops.swin_attention_fwd_cuda(*args, 8, heads)
            ref = ops.swin_attention_fwd_plain(*args, 8, heads)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(got).all().item())
            del got, ref
            k_ms = median_ms(lambda: ops.swin_attention_fwd_cuda(*args, 8, heads))
            p_ms = median_ms(lambda: ops.swin_attention_fwd_plain(*args, 8, heads))
            worst["bfloat16"] = max(worst["bfloat16"], err)
            total_k += n * k_ms
            total_p += n * p_ms
            print(f"K1 bfloat16 bs{batch} stage{stage} qkv=({batch},{hp},{wp},{3 * c}) "
                  f"heads={heads} mask={masked} x{n} blocks: max_abs_err={err:.3e} "
                  f"(tol {TOLERANCE['bfloat16']:g}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}",
                  flush=True)
            if not finite or not err <= TOLERANCE["bfloat16"]:
                failures.append(f"bfloat16 bs{batch} stage{stage} mask={masked}: err {err:.3e}")
    if failures:
        fail("K1 disagrees with its plain version: " + "; ".join(failures))
    print(f"K1 bf16 bs{batch} per forward (12 blocks): kernel_ms={total_k:.4f} "
          f"plain_ms={total_p:.4f}", flush=True)
    return {"name": ops.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/swin_attention_fwd.cu",
            "replaces": "torchok_tpu/ops/swin_attention.py:93",
            "launches": 0, "max_abs_err": worst["bfloat16"],
            "ms": total_k, "plain_ms": total_p}


def run_slice(record):
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.ops import swin_attention as ops

    # warm-up run (cuDNN/cuBLAS plans, allocator) outside the measured one
    warm = copy.deepcopy(SLICE_CONFIG)
    warm["trainer"]["limit_test_batches"] = 1
    run(warm, "test")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES.clear()
    trainer, logs = run(copy.deepcopy(SLICE_CONFIG), "test")
    torch.cuda.synchronize()
    test_counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    stats = trainer.last_eval
    print(f"slice test: {stats['images']} images in {stats['seconds']:.4f} s = "
          f"{stats['images'] / stats['seconds']:.2f} img/s (bs128 bf16, 3 batches, host "
          f"clock incl. loading); peak device memory {peak / 2**20:.1f} MiB; "
          f"launches {test_counts}; logs {logs}", flush=True)

    ops.LAUNCHES.clear()
    trainer, preds = run(copy.deepcopy(SLICE_CONFIG), "predict")
    torch.cuda.synchronize()
    predict_counts = dict(ops.LAUNCHES)
    print(f"slice predict: {len(preds)} batches; launches {predict_counts}", flush=True)

    want = 12 * BATCHES
    for mode, counts in (("test", test_counts), ("predict", predict_counts)):
        if counts.get(ops.KERNEL, 0) != want or counts.get(ops.PLAIN, 0) != 0:
            fail(f"{mode}: expected {want} kernel launches and 0 plain calls, got {counts}")
    for key in ("test/Accuracy", "test/F1Score"):
        if key not in logs or not math.isfinite(logs[key]):
            fail(f"{key} missing or not finite in {logs}")
    if len(preds) != BATCHES:
        fail(f"predict returned {len(preds)} batches, expected {BATCHES}")
    for p in preds:
        logits = p["prediction"]
        if logits.shape != (128, 1000) or not np.isfinite(logits).all():
            fail(f"bad logits: shape {logits.shape}, finite {bool(np.isfinite(logits).all())}")

    # reference on a small input: the same weights in f32, kernel on the
    # card against the plain attention on the CPU
    model = trainer.state.model.float()
    image = torch.from_numpy(trainer.task.predict_dataloader()[0].dataset.images[:2])
    image = (image.float() / 255.0 - 0.45) / 0.225
    batch = {"image": image.permute(0, 3, 1, 2).contiguous()}
    with torch.inference_mode():
        on_card = model({"image": batch["image"].cuda()})["prediction"].cpu()
        on_cpu = model.cpu()({"image": batch["image"]})["prediction"]
    err = (on_card - on_cpu).abs().max().item()
    print(f"slice reference (f32, 2 images, card vs CPU): max_abs_err={err:.3e} "
          f"(tol 1e-3), logit scale {on_cpu.abs().max().item():.3e}", flush=True)
    if not err <= 1e-3:
        fail(f"model logits on the card differ from the CPU run by {err:.3e}")
    record["launches"] = test_counts[ops.KERNEL]


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

    from torchok_tpu_torch.ops import swin_attention as ops
    from torchok_tpu_torch.utils.cuda_build import build_log
    start = time.perf_counter()
    ops.build()
    print(f"built {ops.KERNEL} in {time.perf_counter() - start:.2f} s", flush=True)
    print(build_log(ops.KERNEL).strip(), flush=True)

    record = check_k1()
    run_slice(record)

    print(json.dumps({"kernels": [record]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
