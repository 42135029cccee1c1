"""Where the FCOS north star's one-epoch map50 dips come from.

Runs ``configs/detection_toy_fcos.yaml`` at the smoke's short budget (8
epochs) under ``trainer.deterministic`` exactly as ``chip_smoke.run_fcos_recipe``
does, with each train step's losses read back (``log_every_n_steps=1``, which
changes no number) and the weights copied after every train epoch, the
weights that epoch's validation saw. Then, for each epoch's weights:

* valid/map50 again (equal to the fit's reading when the copies are right);
* valid/map50 after the backbone's BatchNorm running statistics are
  recomputed from 256 train images (one train-mode forward with momentum 0):
  when that lifts a dip, the weights are sound and the running averages are
  what the validation lacks;
* how far the running statistics lie from the recomputed ones (mean over
  channels of |running mean - batch mean| / batch std, the stem and each
  stage's last BatchNorm);
* the train losses of the epoch (mean, largest and the step of the largest,
  the last five), the FCOS head's three scales, and the relative change of the backbone's, neck's and head's weights over
  it;
* the detections: kept boxes per image, the mean top score, and the share of
  GT boxes that a detection of their class covers at IoU 0.5.

The weights of the lowest epoch from the third on are written to
``OUT/fcos_epoch<N>.pt`` for ``tools/compare_fcos_dip_jax.py``.

    python tools/probe_fcos_dip.py --out build/fcos_dip
"""
import argparse
import copy
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

BN_IMAGES = 256


def recall50(batches):
    """Kept boxes per image, mean top score, and the share of GT boxes that
    a kept detection of their class covers at IoU >= 0.5."""
    import numpy as np
    kept, tops, covered, total = [], [], 0, 0
    for preds, target in batches:
        for b in range(preds["labels"].shape[0]):
            keep = (preds["labels"][b] >= 0) & (preds["scores"][b] > 0)
            boxes, labels = preds["bboxes"][b][keep], preds["labels"][b][keep]
            kept.append(int(keep.sum()))
            tops.append(float(preds["scores"][b][keep].max()) if keep.any() else 0.0)
            real = target["labels"][b] >= 0
            for box, label in zip(target["bboxes"][b][real], target["labels"][b][real]):
                total += 1
                mine = boxes[labels == label]
                if not len(mine):
                    continue
                wh = np.clip(np.minimum(box[2:], mine[:, 2:]) - np.maximum(box[:2], mine[:, :2]),
                             0, None)
                inter = wh[:, 0] * wh[:, 1]
                union = ((box[2] - box[0]) * (box[3] - box[1])
                         + (mine[:, 2] - mine[:, 0]) * (mine[:, 3] - mine[:, 1]) - inter)
                covered += bool((inter / np.maximum(union, 1e-9) >= 0.5).any())
    return statistics.fmean(kept), statistics.fmean(tops), covered / max(total, 1)


def probe(cfg: dict, out: Path, bn_images: int = BN_IMAGES) -> list:
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.constructor.config_structure import Phase
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.engine.trainer import deterministic_algorithms
    from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d

    class Recorder(Callback):
        def __init__(self):
            self.losses, self.weights, self.map50 = [], [], []

        def on_train_epoch_start(self, trainer, task):
            self.losses.append([])

        def on_train_batch_end(self, trainer, task, step, logs):
            self.losses[-1].append((step, logs))

        def on_train_epoch_end(self, trainer, task, logs):
            self.weights.append({k: v.detach().cpu().clone()
                                 for k, v in trainer.state.model.state_dict().items()})

        def on_validation_epoch_end(self, trainer, task, logs):
            self.map50.append(logs["valid/map50"])

    recorder = Recorder()
    kept, restore = chip_smoke.capture_metric_inputs("MMDetectionMAP")
    start = time.perf_counter()
    try:
        trainer, _ = run(cfg, "train", [recorder])
        print(f"fit: {trainer.global_step} steps in {time.perf_counter() - start:.1f} s; "
              f"valid/map50 by epoch {[round(v, 6) for v in recorder.map50]}", flush=True)
        task, model, device = trainer.task, trainer.state.model, trainer.device
        val_loaders = task.val_dataloader()
        trainer._install_device_fns(val_loaders, train=False)
        eval_step = trainer._make_eval_step(task, task.compute_loss_on_valid)
        # the train images for the BatchNorm recount: the train set's files
        # through its transforms, with no random draw on the device
        bn_loader = copy.copy(task.train_dataloader()[0])
        bn_loader.device_fn = trainer._make_device_fn(bn_loader.dataset, train=False)
        images = []
        for batch in bn_loader:
            images.append(batch["image"])
            if sum(len(x) for x in images) >= bn_images:
                break
        images = torch.cat(images)[:bn_images].to(device)
        norms = {name: m for name, m in model.backbone.named_modules()
                 if isinstance(m, BatchNorm2d)}
        watched = [n for n in norms if n.count(".") <= 1 or n.endswith(("1.bn2",))]

        def validate():
            logs = trainer._run_eval(task, eval_step, val_loaders, Phase.VALID)
            return logs["valid/map50"], recall50(kept["last"])

        rows = []
        with deterministic_algorithms(True, device):
            for epoch, weights in enumerate(recorder.weights):
                model.load_state_dict(weights)
                again, (boxes, top, cover) = validate()
                before = {n: (m.running_mean.clone(), m.running_var.clone())
                          for n, m in norms.items()}
                model.backbone.train()
                for m in norms.values():
                    m.momentum = 0.0
                with torch.no_grad():
                    model.backbone.forward_features(images)
                for m in norms.values():
                    m.momentum = 0.9
                gap = {n: float(((before[n][0] - norms[n].running_mean).abs()
                                 / (norms[n].running_var + norms[n].eps).sqrt()).mean())
                       for n in watched}
                recounted, (_, top_bn, cover_bn) = validate()
                steps = recorder.losses[epoch]
                losses = [logs["loss"] for _, logs in steps]
                worst = max(range(len(losses)), key=losses.__getitem__)
                prev = recorder.weights[epoch - 1] if epoch else None
                moved = {}
                for part in ("backbone.", "neck.", "bbox_head."):
                    keys = [k for k in weights if k.startswith(part)
                            and "running" not in k]
                    if prev is None:
                        continue
                    num = sum(float((weights[k] - prev[k]).double().pow(2).sum()) for k in keys)
                    den = sum(float(prev[k].double().pow(2).sum()) for k in keys)
                    moved[part[:-1]] = (num / den) ** 0.5
                row = {"epoch": epoch, "map50_fit": recorder.map50[epoch], "map50_again": again,
                       "map50_bn_recounted": recounted, "boxes_per_image": boxes,
                       "top_score": top, "gt_covered": cover, "top_score_bn": top_bn,
                       "gt_covered_bn": cover_bn, "bn_mean_gap": gap,
                       "loss_mean": statistics.fmean(losses), "loss_max": losses[worst],
                       "loss_max_step": steps[worst][0],
                       "loss_parts_at_max": steps[worst][1], "loss_last5": losses[-5:],
                       "moved": moved,
                       "scales": [float(v) for k, v in weights.items()
                                  if k.startswith("bbox_head.scales.")]}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        restore()
    out.mkdir(parents=True, exist_ok=True)
    low = min(range(2, len(rows)), key=lambda e: rows[e]["map50_fit"])
    torch.save(recorder.weights[low], out / f"fcos_epoch{low}.pt")
    print(f"wrote the weights after epoch {low} to {out}", flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="build/fcos_dip")
    args = parser.parse_args()
    import torch
    from torchok_tpu_torch.constructor.config import apply_override
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), torch.__version__, flush=True)
    with tempfile.TemporaryDirectory(prefix="toydet_") as toy_root, \
            tempfile.TemporaryDirectory(prefix="fcos_logs_") as logs:
        chip_smoke.ensure_toy_detection(toy_root)
        cfg = chip_smoke.fcos_config(toy_root, logs)
        for override in chip_smoke.FCOS_PHASE_OVERRIDES:
            key, _, value = override.partition("=")
            apply_override(cfg, key, value)
        cfg["trainer"]["log_every_n_steps"] = 1
        probe(cfg, Path(args.out))
    return 0


if __name__ == "__main__":
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.exit(main())
