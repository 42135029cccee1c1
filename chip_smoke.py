#!/usr/bin/env python3
"""Smoke run of torchok_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the versions.
2. Builds the port's CUDA kernels from ``torchok_tpu_torch/csrc`` with nvcc,
   one compiler per source, side by side.
3. Holds each kernel against its plain PyTorch version on the card at each
   stage shape of the SwinV2-tiny slice, at batch 8 in f32 (TF32 off) and
   bf16 and at the slices' own batch 128 in bf16, and times kernel, plain
   version and the closest library call (``F.scaled_dot_product_attention``
   on prepared windows; for K2 its forward + backward) with CUDA events
   (median after warm-up). K1 (forward): max abs error <= 1e-4 in f32,
   <= 2e-2 in bf16. K2 (backward): dqkv, dbias and dscale each within a
   stated fraction of the reference's largest magnitude, and bit-equal
   between two launches on the same inputs.
4. Drives the inference slice through ``torchok_tpu_torch.__main__.run`` with
   ``SLICE_CONFIG`` (equal to configs/classification_swinv2_tiny_synthetic.yaml):
   swinv2_tiny_window8_256 at full width, 256x256, 1000 classes, batch 128,
   bf16 autocast, 3 batches, random weights from the seed. The launch
   counters are zeroed just before each run and read just after: the kernel
   must launch once per SwinBlock per batch (12 x 3) and the plain version
   never. The logits must be finite, Accuracy and F1Score reported, and the
   model must agree in f32 with its CPU run (plain attention) on two images.
5. Drives the train slice through ``run(..., "train")`` with ``SMOKE_TRAIN``
   (``TRAIN_CONFIG``, equal to configs/classification_swinv2_tiny_synthetic_train.yaml,
   with the train set cut to one batch repeated for 10 one-step epochs and
   one validation batch at the end): K1 must launch 12 x (train steps + eval
   batches), K2 12 x train steps, the plain versions never; every loss
   finite and the last below the first; the validation metrics reported;
   every parameter finite and qkv, cpb_mlp and logit_scale moved. Then one
   f32 forward + backward of the model on two images on the card (K1 + K2)
   against the CPU (plain versions), over all parameter gradients.
6. Prints ``{"kernels": [...]}``, the card line, and last
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


def _synthetic(num_samples, shuffle, drop_last, **extra):
    return [{
        "dataloader": {"batch_size": 128, "num_workers": 2, "drop_last": drop_last,
                       "shuffle": shuffle},
        "dataset": {
            "name": "SyntheticClassificationDataset",
            "params": {"num_samples": num_samples, "num_classes": 1000,
                       "image_size": [256, 256], **extra},
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
TRAIN_CONFIG = {
    "task": SLICE_CONFIG["task"],
    "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                               "mapping": {"input": "prediction", "target": "target"}}]},
    "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.0001}}}],
    "data": {"TRAIN": _synthetic(1280, True, True), "VALID": _synthetic(256, False, False, seed=1)},
    "trainer": {"accelerator": "gpu", "precision": 16, "max_epochs": 2},
    "seed_params": {"seed": 42},
    "metrics": [{"name": "Accuracy", **_METRIC}],
}
TRAIN_STEPS = 10
BATCHES = 3
BLOCKS = (2, 2, 6, 2)  # SwinBlocks per stage of swinv2_tiny
# (Hp, Wp, C, heads) of each stage at 256x256 input; window 8, head dim 32
STAGES = ((64, 64, 96, 3), (32, 32, 192, 6), (16, 16, 384, 12), (8, 8, 768, 24))
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


def sdpa_inputs(qkv, scale, bias, mask, heads):
    """The closest single library call, on what it needs prepared: windows
    already partitioned, q and k already normalised, q already scaled, and
    bias (+ mask) as one additive ``attn_mask``. The (window, head) pairs
    ride the head axis so the mask broadcasts over the images."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops.swin_attention import to_windows
    q, k, v = to_windows(qkv, 8, 3, heads)  # (B, H, nW, L, D)
    q = F.normalize(q.float(), dim=-1) * scale.view(1, heads, 1, 1, 1)
    k = F.normalize(k.float(), dim=-1)
    b, _, nw, L, d = q.shape
    attn = bias.view(heads, 1, L, L)
    if mask is not None:
        attn = attn + mask.view(1, nw, L, L)
    attn = attn.expand(heads, nw, L, L).reshape(1, heads * nw, L, L).to(qkv.dtype).contiguous()
    q, k, v = (t.reshape(b, heads * nw, L, d).to(qkv.dtype).contiguous() for t in (q, k, v))
    return q, k, v, attn


def attention_cost(b, hp, wp, c, heads, itemsize, backward, masked):
    """Bytes the function must move (each input read once, each output
    written once) and the operations of its products on these inputs."""
    tokens = b * hp * wp
    small = 4 * (heads + heads * 64 * 64 + (hp // 8) * (wp // 8) * 64 * 64 * masked)
    if backward:  # qkv and dout in, dqkv out, dbias and dscale out; five products
        return 7 * c * itemsize * tokens + small + 4 * (heads * 64 * 64 + heads), \
            5 * 2 * tokens * 64 * c
    return 4 * c * itemsize * tokens + small, 2 * 2 * tokens * 64 * c


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


def check_k1():
    """K1 against its plain version at every stage shape; returns the JSON
    record for the kernel."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import swin_attention as ops
    worst = {"float32": 0.0, "bfloat16": 0.0}
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for stage, (hp, wp, c, heads), masked, _ in shape_cases(CHECK_BATCH):
            args = attention_inputs(CHECK_BATCH, hp, wp, c, heads, dtype, masked, stage)
            got = ops.swin_attention_fwd_cuda(*args, 8, heads)
            ref = ops.swin_attention_fwd_plain(*args, 8, heads)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(got).all().item())
            k_ms = median_ms(lambda: ops.swin_attention_fwd_cuda(*args, 8, heads), TIMING_ITERS_SMALL)
            p_ms = median_ms(lambda: ops.swin_attention_fwd_plain(*args, 8, heads), TIMING_ITERS_SMALL)
            worst[name] = max(worst[name], err)
            print(f"K1 {name} stage{stage} qkv=({CHECK_BATCH},{hp},{wp},{3 * c}) "
                  f"heads={heads} mask={masked}: max_abs_err={err:.3e} "
                  f"(tol {TOLERANCE[name]:g}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}",
                  flush=True)
            if not finite or not err <= TOLERANCE[name]:
                failures.append(f"{name} stage{stage} mask={masked}: err {err:.3e}")

    # the slice's own shapes: bf16, batch 128, every block of a forward
    batch = SLICE_CONFIG["data"]["TEST"][0]["dataloader"]["batch_size"]
    total_k = total_p = total_lib = total_bound = 0.0
    total_bytes = total_flops = 0
    for stage, (hp, wp, c, heads), masked, n in shape_cases(batch):
        args = attention_inputs(batch, hp, wp, c, heads, torch.bfloat16, masked, 10 + stage)
        got = ops.swin_attention_fwd_cuda(*args, 8, heads)
        ref = ops.swin_attention_fwd_plain(*args, 8, heads)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all().item())
        del got, ref
        k_ms = median_ms(lambda: ops.swin_attention_fwd_cuda(*args, 8, heads))
        p_ms = median_ms(lambda: ops.swin_attention_fwd_plain(*args, 8, heads))
        q, k, v, attn = sdpa_inputs(*args, heads)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn, scale=1.0))
        del q, k, v, attn
        nbytes, flops = attention_cost(batch, hp, wp, c, heads, 2, False, masked)
        b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
        worst["bfloat16"] = max(worst["bfloat16"], err)
        total_k += n * k_ms
        total_p += n * p_ms
        total_lib += n * lib_ms
        total_bytes += n * nbytes
        total_flops += n * flops
        print(f"K1 bfloat16 bs{batch} stage{stage} qkv=({batch},{hp},{wp},{3 * c}) "
              f"heads={heads} mask={masked} x{n} blocks: max_abs_err={err:.3e} "
              f"(tol {TOLERANCE['bfloat16']:g}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.4f}", flush=True)
        if not finite or not err <= TOLERANCE["bfloat16"]:
            failures.append(f"bfloat16 bs{batch} stage{stage} mask={masked}: err {err:.3e}")
    if failures:
        fail("K1 disagrees with its plain version: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(total_bytes, total_flops, "bfloat16")
    print(f"K1 bf16 bs{batch} per forward (12 blocks): kernel_ms={total_k:.4f} "
          f"plain_ms={total_p:.4f} sdpa_ms={total_lib:.4f} bound_ms={total_bound:.4f} "
          f"({bound_by}: {total_bytes / 1e9:.3f} GB, {total_flops / 1e9:.1f} GFLOP)", flush=True)
    return {"name": ops.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/swin_attention_fwd.cu",
            "replaces": "torchok_tpu/ops/swin_attention.py:93",
            "launches": 0, "max_abs_err": worst["bfloat16"],
            "ms": total_k, "plain_ms": total_p, "bound_ms": total_bound,
            "bound_by": bound_by, "library_ms": total_lib}


def backward_errors(got, ref):
    """Per output (dqkv, dbias, dscale): max abs error and the reference's
    max magnitude."""
    out = []
    for g, r in zip(got, ref):
        out.append(((g.float() - r.float()).abs().max().item(), r.float().abs().max().item()))
    return out


def check_k2(timing: bool = True):
    """K2 against its plain version at every stage shape, twice for bit
    equality; returns the JSON record for the kernel."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import swin_attention as ops
    names = ("dqkv", "dbias", "dscale")
    failures = []
    worst_bf16 = 0.0

    def one(label, batch, stage, hp, wp, c, heads, dtype, masked, seed):
        nonlocal worst_bf16
        name = str(dtype).split(".")[-1]
        args = attention_inputs(batch, hp, wp, c, heads, dtype, masked, seed)
        g = torch.Generator(device="cuda")
        g.manual_seed(100 + seed)
        dout = torch.randn((batch, hp, wp, c), generator=g, device="cuda").to(dtype)
        got = ops.swin_attention_bwd_cuda(*args, dout, 8, heads)
        again = ops.swin_attention_bwd_cuda(*args, dout, 8, heads)
        ref = ops.swin_attention_bwd_plain(*args, dout, 8, heads)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(t).all().item()) for t in got)
        parts = []
        ok = same and finite
        for key, (err, mag) in zip(names, backward_errors(got, ref)):
            rel = K2_TOLERANCE[name][key]
            ok = ok and err <= rel * mag
            parts.append(f"{key} err={err:.3e} (tol {rel:g} x max|ref| {mag:.3e})")
            if key == "dqkv" and name == "bfloat16":
                worst_bf16 = max(worst_bf16, err)
        del got, again, ref
        line = (f"K2 {name} {label} stage{stage} qkv=({batch},{hp},{wp},{3 * c}) heads={heads} "
                f"mask={masked}: " + ", ".join(parts) + f", bit-equal twice={same}")
        times = None
        if timing:
            iters = TIMING_ITERS if batch > CHECK_BATCH else TIMING_ITERS_SMALL
            k_ms = median_ms(lambda: ops.swin_attention_bwd_cuda(*args, dout, 8, heads), iters)
            p_ms = median_ms(lambda: ops.swin_attention_bwd_plain(*args, dout, 8, heads), iters)
            line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
            times = (k_ms, p_ms)
        print(line, flush=True)
        if not ok:
            failures.append(line)
        return args, dout, times

    for dtype in (torch.float32, torch.bfloat16):
        for stage, (hp, wp, c, heads), masked, _ in shape_cases(CHECK_BATCH):
            one(f"B{CHECK_BATCH}", CHECK_BATCH, stage, hp, wp, c, heads, dtype, masked, stage)

    batch = TRAIN_CONFIG["data"]["TRAIN"][0]["dataloader"]["batch_size"]
    total_k = total_p = total_lib = 0.0
    total_bytes = total_flops = 0
    for stage, (hp, wp, c, heads), masked, n in shape_cases(batch):
        args, dout, times = one(f"bs{batch} x{n} blocks", batch, stage, hp, wp, c, heads,
                                torch.bfloat16, masked, 10 + stage)
        nbytes, flops = attention_cost(batch, hp, wp, c, heads, 2, True, masked)
        total_bytes += n * nbytes
        total_flops += n * flops
        if timing:
            q, k, v, attn = sdpa_inputs(*args, heads)
            for t in (q, k, v):
                t.requires_grad_(True)
            dwin = torch.randn_like(q)

            def library_fwd_bwd():
                out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn, scale=1.0)
                torch.autograd.grad(out, (q, k, v), dwin)

            lib_ms = median_ms(library_fwd_bwd)
            b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
            print(f"K2 bfloat16 bs{batch} stage{stage} mask={masked}: sdpa fwd+bwd "
                  f"ms={lib_ms:.4f} bound_ms={b_ms:.4f}", flush=True)
            total_k += n * times[0]
            total_p += n * times[1]
            total_lib += n * lib_ms
            del q, k, v, attn, dwin
        del args, dout
    if failures:
        fail("K2 disagrees with its plain version or with itself: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(total_bytes, total_flops, "bfloat16")
    print(f"K2 bf16 bs{batch} per backward (12 blocks): kernel_ms={total_k:.4f} "
          f"plain_ms={total_p:.4f} sdpa_fwd_bwd_ms={total_lib:.4f} bound_ms={total_bound:.4f} "
          f"({bound_by}: {total_bytes / 1e9:.3f} GB, {total_flops / 1e9:.1f} GFLOP)", flush=True)
    return {"name": ops.KERNEL_BWD, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/swin_attention_bwd.cu",
            "replaces": "torchok_tpu/ops/swin_attention.py:159",
            "launches": 0, "max_abs_err": worst_bf16,
            "ms": total_k, "plain_ms": total_p, "bound_ms": total_bound,
            "bound_by": bound_by, "library_ms": total_lib if timing else None}


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


def smoke_train_config(epochs: int):
    """TRAIN_CONFIG with the train set cut to one batch, repeated for
    ``epochs`` one-step epochs (so each epoch's ``train/loss`` is one step's
    loss), one sanity validation batch and one validation batch at the end."""
    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["data"]["TRAIN"] = _synthetic(128, False, True)
    cfg["data"]["VALID"] = _synthetic(128, False, False, seed=1)
    cfg["trainer"].update(max_epochs=epochs, check_val_every_n_epoch=epochs)
    return cfg


def run_train_slice(k1_record, k2_record):
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops import swin_attention as ops

    class Recorder(Callback):
        def __init__(self):
            self.epochs = []
            self.initial = {}

        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.state_dict().items()}

        def on_epoch_end(self, trainer, task, logs):
            self.epochs.append(dict(logs))

    # warm-up run (cuBLAS plans, allocator, optimizer kernels) outside the measured one
    run(smoke_train_config(2), "train")
    torch.cuda.synchronize()

    recorder = Recorder()
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES.clear()
    trainer, logs = run(smoke_train_config(TRAIN_STEPS), "train", [recorder])
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    stats = trainer.last_fit
    losses = [e["train/loss"] for e in recorder.epochs]
    print(f"train slice: {stats['steps']} steps, {stats['images']} images in "
          f"{stats['seconds']:.4f} s = {stats['images'] / stats['seconds']:.2f} img/s "
          f"(bs128 bf16, a smoke reading: host clock, first fetch to each step's loss "
          f"read-back, one step per epoch); peak device memory {peak / 2**20:.1f} MiB; "
          f"launches {counts}", flush=True)
    print("train losses per step: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    print(f"last epoch logs: {logs}", flush=True)

    eval_batches = 2  # one sanity batch, one validation batch after the last epoch
    want_k1 = 12 * (TRAIN_STEPS + eval_batches)
    want_k2 = 12 * TRAIN_STEPS
    if (counts.get(ops.KERNEL, 0) != want_k1 or counts.get(ops.KERNEL_BWD, 0) != want_k2
            or counts.get(ops.PLAIN, 0) or counts.get(ops.PLAIN_BWD, 0)):
        fail(f"train: expected {want_k1} K1 and {want_k2} K2 launches and no plain call, "
             f"got {counts}")
    if stats["steps"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        fail(f"train: expected {TRAIN_STEPS} steps, got {stats['steps']} ({len(losses)} logged)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall on the repeated batch: {losses}")
    for key in ("valid/Accuracy", "valid/loss"):
        if key not in logs or not math.isfinite(logs[key]):
            fail(f"{key} missing or not finite in {logs}")
    moved = {"qkv": False, "cpb_mlp": False, "logit_scale": False}
    for name, value in trainer.state.model.state_dict().items():
        if not bool(torch.isfinite(value).all().item()):
            fail(f"train: parameter {name} is not finite")
        for key in moved:
            if key in name and not torch.equal(value, recorder.initial[name]):
                moved[key] = True
    if not all(moved.values()):
        fail(f"train: parameters that never changed: {[k for k, v in moved.items() if not v]}")
    k1_record["launches"] += counts[ops.KERNEL]
    k2_record["launches"] = counts[ops.KERNEL_BWD]


def gradient_reference():
    """One f32 forward + backward of the full-width model on two images: the
    card (K1 + K2) against the CPU (plain versions), all parameter gradients."""
    import torch
    import torchok_tpu_torch  # noqa: F401 — registers the components
    from torchok_tpu_torch.constructor import TASKS
    from torchok_tpu_torch.constructor.config import config_from_dict
    from torchok_tpu_torch.constructor.config_structure import merge_structured
    from torchok_tpu_torch.ops import swin_attention as ops

    cfg = copy.deepcopy(TRAIN_CONFIG)
    cfg["task"]["params"]["backbone_params"]["drop_path_rate"] = 0.0
    config = merge_structured(config_from_dict(cfg))
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    generator = torch.Generator()
    generator.manual_seed(5)
    task.init_weights(generator)
    image = torch.randn((2, 3, 256, 256), generator=generator)
    target = torch.tensor([3, 977])

    def grads(device):
        model = task.model.to(device).train()
        model.zero_grad(set_to_none=True)
        out = model({"image": image.to(device), "target": target.to(device)})
        total, _ = task.compute_loss(out)
        total.backward()
        # the three inner feature norms take no part in classification: no gradient
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                if p.grad is not None}, total.item()

    ops.LAUNCHES.clear()
    on_card, loss_card = grads(torch.device("cuda", 0))
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    on_cpu, loss_cpu = grads(torch.device("cpu"))
    if set(on_card) != set(on_cpu) or not any("cpb_mlp" in n for n in on_cpu):
        fail("gradient reference: the card and the CPU gave gradients to different parameters")
    worst_name, worst, largest = "", 0.0, 0.0
    for name, ref in on_cpu.items():
        err = (on_card[name] - ref).abs().max().item()
        largest = max(largest, ref.abs().max().item())
        if err > worst:
            worst_name, worst = name, err
    tol = 1e-3 * largest  # f32 on both sides, other summation orders through 12 blocks
    print(f"gradient reference (f32, 2 images, card K1+K2 vs CPU plain): loss {loss_card:.6f} "
          f"vs {loss_cpu:.6f}; max_abs_err={worst:.3e} at {worst_name} (tol 1e-3 x largest "
          f"gradient {largest:.3e} = {tol:.3e}); launches {counts}", flush=True)
    if counts.get(ops.KERNEL, 0) != 12 or counts.get(ops.KERNEL_BWD, 0) != 12:
        fail(f"gradient reference: expected 12 K1 and 12 K2 launches on the card, got {counts}")
    if not worst <= tol:
        fail(f"gradients on the card differ from the CPU run by {worst:.3e} at {worst_name}")


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
    print(f"built {ops.KERNEL} and {ops.KERNEL_BWD} side by side in "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    for kernel in (ops.KERNEL, ops.KERNEL_BWD):
        print(build_log(kernel).strip(), flush=True)

    k1_record = check_k1()
    k2_record = check_k2()
    run_slice(k1_record)
    run_train_slice(k1_record, k2_record)
    gradient_reference()

    print(json.dumps({"kernels": [k1_record, k2_record]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
