#!/usr/bin/env python
"""This tree's CUDA kernels against a parent commit's, in one process on one
card.

The parent's package is a copy of its ``torchok_tpu_torch/`` renamed
``torchok_tpu_torch_parent`` (its kernels then build from its own sources
into its own ``build/``):

    mkdir -p build/parent && git archive <parent> torchok_tpu_torch | tar -x -C build/parent
    mv build/parent/torchok_tpu_torch build/parent/torchok_tpu_torch_parent
    grep -rl torchok_tpu_torch build/parent/torchok_tpu_torch_parent --include='*.py' \\
        | xargs sed -i 's/torchok_tpu_torch\\b/torchok_tpu_torch_parent/g'
    python tools/compare_torch_parent.py --parent build/parent

1. Equality: every kernel wrapper call of ``chip_smoke.py``'s checks of K1 to
   K9 runs both builds on the same inputs; every output must be bit-equal to
   the parent's, except those of the kernels named by ``--changed`` in bf16
   (by default K3b's and K5's, whose bf16 route this tree redesigns).
2. ``--turns attention`` (the default): the window attention kernels in
   bf16 at their models' batch, in turns parent, new, new, parent (median of
   20 CUDA-event timings each): K3b and K5 at gcvit_tiny's four stages, K3b
   at davit_t's, K1 and K2 at swinv2_tiny's (windows 8 and 16); sums over
   each model's forward or train-step backward, with the route of each shape.
   ``--turns k9``: K9 at ``chip_smoke.py``'s eleven shapes (the JAX probe's
   two and B0's nine blocks) at batch 256, beside each B0 block's own eval
   forward; sums over the nine blocks.
3. ``--train gcvit_tiny davit_t``: each model's smoke train slice of
   ``chip_smoke.py`` (bs 128, bf16, 10 one-step epochs after a 2-epoch
   warm-up of each package) through each package's own ``run``, in turns
   parent, new, new, parent: img/s over the train epochs (host clock, first
   fetch to each step's loss read-back).
Exits non-zero when an output differs that must not.
"""
import argparse
import importlib
import os
import statistics
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODS = {"swin_attention": ["swin_attention_fwd_cuda", "swin_attention_bwd_cuda"],
        "window_attention_dot": ["window_attention_fwd_cuda", "window_attention_global_fwd_cuda",
                                 "window_attention_bwd_cuda", "window_attention_global_bwd_cuda"],
        "window_attention": ["window_attention_mw_cuda"], "conv_bn": ["matmul_bn_cuda"],
        "conv_gemm": ["conv3x3_gemm_cuda"], "mbconv_fused": ["mbconv_fused_cuda"]}
LIBRARIES = ["swin_attention_fwd", "swin_attention_bwd", "window_attention_fwd",
             "window_attention_bwd", "window_attention_global_fwd",
             "window_attention_global_bwd", "window_attention_mw_fwd", "matmul_bn_fwd",
             "conv3x3_gemm", "mbconv_fused_fwd"]


def flat(x):
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in flat(y)]
    return []


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


def turns(f_old, f_new):
    """(parent, new, new, parent) medians."""
    return median_ms(f_old), median_ms(f_new), median_ms(f_new), median_ms(f_old)


def equality(cs, new, old, changed):
    """Runs chip_smoke's checks of K1 to K9 with every kernel wrapper calling
    both builds; returns (calls compared, mismatches)."""
    import torch
    mismatches, compared, originals = [], [0], {}
    for m, fns in MODS.items():
        for f in fns:
            n_fn, o_fn = getattr(new[m], f), getattr(old[m], f)
            originals[(m, f)] = n_fn

            def wrapped(*args, _n=n_fn, _o=o_fn, _name=f"{m}.{f}"):
                out_n = _n(*args)
                out_o = _o(*args)
                first = flat(args)[0]
                if not (first.dtype == torch.bfloat16 and _name.split(".")[1] in changed):
                    torch.cuda.synchronize()
                    compared[0] += 1
                    if not all(torch.equal(a, b) for a, b in zip(flat(out_n), flat(out_o))):
                        mismatches.append((_name, [tuple(t.shape) for t in flat(args)],
                                           first.dtype))
                return out_n
            setattr(new[m], f, wrapped)
    real = cs.median_ms
    cs.median_ms = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
    try:
        cs.check_k1(), cs.check_k2(), cs.check_k3(), cs.check_k4(), cs.check_k5()
        cs.check_k6(), cs.check_k7(), cs.check_k8()
        probe = cs.load_tool("probe_torch_mbconv_fused")
        cs.check_k9(probe, cs.b0_cases(probe, torch.device("cuda", 0)))
    finally:
        cs.median_ms = real
        for (m, f), fn in originals.items():
            setattr(new[m], f, fn)
    return compared[0], mismatches


def k9_turns(cs, new_mb, old_mb):
    """K9 bf16 at batch 256 at chip_smoke's eleven shapes, in turns."""
    import numpy as np
    import torch
    device = torch.device("cuda", 0)
    probe = cs.load_tool("probe_torch_mbconv_fused")
    b0 = cs.b0_cases(probe, device)
    cases = [(label, shape, None, None) for label, shape in cs.MBCONV_PROBE]
    cases += [(f"b0 {name}", shape, block, p) for name, block, p, shape in b0]
    sums = [0.0] * 5
    for idx, (label, (hw, cin, mid, rd, k), block, folded) in enumerate(cases):
        rng = np.random.default_rng(70 + idx)
        x = probe.make_input(rng, cs.EFFNET_BATCH, hw, cin, device, torch.bfloat16)
        p = folded if folded is not None else probe.make_params(rng, cin, mid, rd, k, device,
                                                                torch.bfloat16)
        raw = turns(lambda: old_mb.mbconv_fused_cuda(x, p), lambda: new_mb.mbconv_fused_cuda(x, p))
        line = (f"K9 bf16 {label} ({cs.EFFNET_BATCH},{hw},{hw},{cin}) mid={mid} k={k} route "
                f"{new_mb.route(hw, hw, cin, mid, rd, k, torch.bfloat16)}: parent "
                f"{raw[0]:.4f}/{raw[3]:.4f} new {raw[1]:.4f}/{raw[2]:.4f} ms, new/parent "
                f"{(raw[1] + raw[2]) / (raw[0] + raw[3]):.4f}")
        if block is not None:
            xl = x.permute(0, 3, 1, 2)
            with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                ev = median_ms(lambda: block(xl))
            line += f"; block eval forward {ev:.4f} ms"
            for i, v in enumerate(raw + (ev,)):
                sums[i] += v
        print(line, flush=True)
    print(f"K9 bf16 SUM over B0's nine blocks bs{cs.EFFNET_BATCH}: parent "
          f"{sums[0]:.4f}/{sums[3]:.4f} new {sums[1]:.4f}/{sums[2]:.4f} ms, block eval "
          f"forwards {sums[4]:.4f} ms", flush=True)


def attention_turns(cs, new, old):
    """bf16 K3b, K5 (gcvit_tiny, davit_t) and K1, K2 (swinv2_tiny at windows
    8 and 16) at their models' batch, in turns; sums per model."""
    import torch
    bf16 = torch.bfloat16
    new_dot, old_dot = new["window_attention_dot"], old["window_attention_dot"]
    new_swin, old_swin = new["swin_attention"], old["swin_attention"]
    cases = []  # (kind, label, launches per pass of the model, run(module))
    for i, st in enumerate(cs.GCVIT_STAGES, 1):
        for kind, parts, n in (("K5", 2, st[6]), ("K3b", 3, st[5])):
            cases.append((kind, f"gcvit_tiny stage{i}", n, parts, st[:5], True))
    for i, st in enumerate(cs.DAVIT_STAGES, 1):
        cases.append(("K3b", f"davit_t stage{i}", st[5], 3, st[:5], False))
    sums = {}

    def record(kind, label, n, raw, extra=""):
        key = (kind, label.split()[0])
        total = sums.setdefault(key, [0.0] * 4)
        for i, v in enumerate(raw):
            total[i] += n * v
        ratio = (raw[1] + raw[2]) / (raw[0] + raw[3])
        print(f"{kind} bf16 {label} x{n}{extra}: parent {raw[0]:.4f}/{raw[3]:.4f} new "
              f"{raw[1]:.4f}/{raw[2]:.4f} ms, new/parent {ratio:.4f}", flush=True)

    for idx, (kind, label, n, parts, (hp, wp, c, heads, ws), with_bias) in enumerate(cases):
        proj, qg, scale, bias, dout = cs.dot_inputs(128, hp, wp, c, heads, ws, bf16, parts,
                                                    with_bias, 40 + idx)
        if parts == 2:
            def run(m, a=(proj, qg, scale, bias, dout, ws, heads)):
                return lambda: m.window_attention_global_bwd_cuda(*a)
            kernel = new_dot.KERNEL_GLOBAL_BWD
        else:
            def run(m, a=(proj, scale, bias, dout, ws, heads)):
                return lambda: m.window_attention_bwd_cuda(*a)
            kernel = new_dot.KERNEL_BWD
        raw = turns(run(old_dot), run(new_dot))
        record(kind, label, n, raw, f" ws {ws} bias {with_bias} route "
               f"{new_dot.backward_route(kernel, bf16)}")
        del proj, qg, bias, dout
    for model in ("swinv2_tiny_window8_256", "swinv2_tiny_window16_256"):
        batch = cs.SWIN_MODELS[model][0]
        for stage, (hp, wp, c, heads, ws), masked, n in cs.swin_cases(model):
            args = cs.attention_inputs(batch, hp, wp, c, heads, ws, bf16, masked, 50 + stage)
            dout = torch.randn((batch, hp, wp, c), device="cuda").to(bf16)
            label = f"{model} stage{stage} L={ws * ws} mask={masked}"
            for kind, fn, extra in (("K1", "swin_attention_fwd_cuda", ()),
                                    ("K2", "swin_attention_bwd_cuda", (dout,))):
                record(kind, label, n, turns(
                    lambda m=old_swin: getattr(m, fn)(*args, *extra, ws, heads),
                    lambda m=new_swin: getattr(m, fn)(*args, *extra, ws, heads)))
            del args, dout
    for (kind, model), t in sums.items():
        print(f"{kind} bf16 SUM {model}: parent {t[0]:.4f}/{t[3]:.4f} new {t[1]:.4f}/{t[2]:.4f} "
              f"ms, new/parent {(t[1] + t[2]) / (t[0] + t[3]):.4f}", flush=True)


TRAIN_CONFIGS = {"gcvit_tiny": "GCVIT_TRAIN_CONFIG", "davit_t": "DAVIT_TRAIN_CONFIG"}


def train_turns(cs, models):
    """The models' smoke train slices through both packages' ``run``."""
    import torch
    from torchok_tpu_torch.__main__ import run as new_run
    from torchok_tpu_torch_parent.__main__ import run as old_run
    for model in models:
        config = getattr(cs, TRAIN_CONFIGS[model])
        for fit in (old_run, new_run):  # warm-up: plans, allocator, optimizer kernels
            fit(cs.smoke_train_config(2, config, 224), "train")
        rates = []
        for fit in (old_run, new_run, new_run, old_run):
            trainer, _ = fit(cs.smoke_train_config(cs.TRAIN_STEPS, config, 224), "train")
            torch.cuda.synchronize()
            rates.append(trainer.last_fit["images"] / trainer.last_fit["seconds"])
        print(f"{model} train bs128 bf16 img/s: parent {rates[0]:.2f}/{rates[3]:.2f} new "
              f"{rates[1]:.2f}/{rates[2]:.2f}, new/parent "
              f"{(rates[1] + rates[2]) / (rates[0] + rates[3]):.4f}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=os.path.join(REPO, "build", "parent"),
                    help="directory holding torchok_tpu_torch_parent")
    ap.add_argument("--changed", nargs="*",
                    default=["window_attention_bwd_cuda", "window_attention_global_bwd_cuda"],
                    help="wrappers whose bf16 outputs may differ from the parent's")
    ap.add_argument("--turns", choices=("attention", "k9", "none"), default="attention")
    ap.add_argument("--train", nargs="*", default=[], choices=sorted(TRAIN_CONFIGS))
    ap.add_argument("--skip-equality", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.parent))
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    new = {m: importlib.import_module(f"torchok_tpu_torch.ops.{m}") for m in MODS}
    old = {m: importlib.import_module(f"torchok_tpu_torch_parent.ops.{m}") for m in MODS}
    from torchok_tpu_torch.utils.cuda_build import load_libraries as load_new
    from torchok_tpu_torch_parent.utils.cuda_build import load_libraries as load_old
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.time()
    other = threading.Thread(target=load_old, args=(LIBRARIES,))
    other.start()
    load_new(LIBRARIES)
    other.join()
    print(f"built both in {time.time() - start:.1f} s", flush=True)
    mismatches = []
    if not args.skip_equality:
        start = time.time()
        compared, mismatches = equality(cs, new, old, set(args.changed))
        print(f"EQUALITY: {compared} calls compared with the parent's build, "
              f"{len(mismatches)} differ ({time.time() - start:.1f} s)", flush=True)
        for name, shapes, dt in mismatches:
            print("DIFFERS", name, shapes, dt, flush=True)
    if args.turns == "attention":
        attention_turns(cs, new, old)
    elif args.turns == "k9":
        k9_turns(cs, new["mbconv_fused"], old["mbconv_fused"])
    train_turns(cs, args.train)
    print(cs.card_line(), flush=True)
    if mismatches:
        sys.exit(1)


if __name__ == "__main__":
    main()
