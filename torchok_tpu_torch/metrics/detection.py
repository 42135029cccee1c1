"""Detection mAP metrics (port of ``torchok_tpu.metrics.detection``;
reference: torchok/metrics/detection.py:12-63 wraps mmdet's eval_map, and
torchok/metrics/torchmetric_060/map.py:130 the COCO evaluation).

Host numpy over padded arrays, as in the JAX package: ``update`` copies one
batch's predictions and targets to the host in one transfer (they are packed
into one f32 tensor on their device first) and keeps them; ``compute``
strips the padding (label -1, score 0) and matches per class.

Update arguments (the metric mapping's keys): ``preds`` (a dict of
``bboxes`` (B, D, 4), ``scores`` (B, D), ``labels`` (B, D)) and ``target``
(``bboxes`` (B, M, 4), ``labels`` (B, M)), or the flat
``prediction_bboxes``/``prediction_scores``/``prediction_labels`` and
``gt_bboxes``/``gt_labels``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from torchok_tpu_torch.constructor import METRICS
from torchok_tpu_torch.metrics.base import Metric


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _match_image(boxes: np.ndarray, scores: np.ndarray, gts: np.ndarray, iou_thr: float,
                 gt_ignore: Optional[np.ndarray] = None,
                 det_outside: Optional[np.ndarray] = None):
    """Greedy score-ordered matching with pycocotools semantics (cocoeval.py
    evaluateImg): each detection takes the highest-IoU unmatched GT above the
    threshold, non-ignored GT first; a detection that falls back to an
    ignored GT is ignored itself, and an unmatched one outside the area range
    is ignored rather than a false positive. Returns (scores, tp) of the
    detections kept."""
    n_d, n_g = len(boxes), len(gts)
    gt_ignore = np.zeros(n_g, bool) if gt_ignore is None else gt_ignore
    det_outside = np.zeros(n_d, bool) if det_outside is None else det_outside
    ious = _iou_matrix(boxes, gts)
    g_order = np.argsort(gt_ignore, kind="stable")
    matched = np.zeros(n_g, bool)
    tp = np.zeros(n_d, np.float32)
    det_ignored = np.zeros(n_d, bool)
    for d in np.argsort(-scores, kind="stable"):
        best_iou = iou_thr - 1e-10
        m = -1
        for g in g_order:
            if matched[g]:
                continue
            # once matched to a non-ignored GT, never trade for an ignored one
            if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                break
            if ious[d, g] < best_iou:
                continue
            best_iou = ious[d, g]
            m = g
        if m == -1:
            det_ignored[d] = det_outside[d]
            continue
        matched[m] = True
        if gt_ignore[m]:
            det_ignored[d] = True
        else:
            tp[d] = 1.0
    keep = ~det_ignored
    return scores[keep], tp[keep]


def _average_precision(recalls: np.ndarray, precisions: np.ndarray, mode: str = "area") -> float:
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    ap = 0.0  # 11-point
    for t in np.linspace(0, 1, 11):
        mask = recalls >= t
        ap += (np.max(precisions[mask]) if mask.any() else 0.0) / 11
    return float(ap)


def _precision_recall(scores_all: List[np.ndarray], tp_all: List[np.ndarray], n_gt: int):
    scores_cat = np.concatenate(scores_all) if scores_all else np.zeros(0)
    tp_cat = np.concatenate(tp_all) if tp_all else np.zeros(0)
    # stable: on score ties the TP/FP interleave (hence AP) must be
    # deterministic and match pycocotools' mergesort ordering
    tp_sorted = tp_cat[np.argsort(-scores_cat, kind="stable")]
    tps = np.cumsum(tp_sorted)
    fps = np.cumsum(1 - tp_sorted)
    return tps / n_gt, tps / np.maximum(tps + fps, 1e-9)


def pack_batch(arrays: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors of one batch on the host as f32 numpy arrays of their
    shapes, copied in one transfer."""
    flat = torch.cat([a.detach().reshape(-1).float() for a in arrays]).cpu().numpy()
    out, at = [], 0
    for a in arrays:
        out.append(flat[at:at + a.numel()].reshape(tuple(a.shape)))
        at += a.numel()
    return out


@METRICS.register_class(name="MMDetectionMAP")
class MMDetectionMAP(Metric):
    """VOC-style AP per class (mmdet's tpfp_default: each detection pairs
    only with its argmax-IoU GT), averaged over the classes with GT."""

    def __init__(self, iou_thr: float = 0.5, num_classes: Optional[int] = None, nproc: int = 4,
                 mode: str = "area", **params):
        super().__init__(**params)
        self.iou_thr = iou_thr
        self.num_classes = num_classes
        self.mode = mode

    def empty_state(self, device=None):
        return {"preds": [], "gts": []}

    def update(self, state, prediction_bboxes=None, prediction_scores=None,
               prediction_labels=None, gt_bboxes=None, gt_labels=None, preds=None,
               target=None, **_):
        if preds is not None:  # the reference's dict mapping (preds/target)
            prediction_bboxes = preds["bboxes"]
            prediction_scores = preds["scores"]
            prediction_labels = preds["labels"]
        if target is not None:
            gt_bboxes, gt_labels = target["bboxes"], target["labels"]
        pb, ps, pl, gb, gl = pack_batch([torch.as_tensor(a) for a in (
            prediction_bboxes, prediction_scores, prediction_labels, gt_bboxes, gt_labels)])
        state["preds"].append((pb, ps, pl.astype(np.int64)))
        state["gts"].append((gb, gl.astype(np.int64)))
        return state

    @staticmethod
    def _images(state):
        """Per image: (boxes, scores, labels, gt boxes, gt labels), padding
        stripped."""
        images = []
        for (pb, ps, pl), (gb, gl) in zip(state["preds"], state["gts"]):
            for i in range(pb.shape[0]):
                keep_p = (pl[i] >= 0) & (ps[i] > 0)
                keep_g = gl[i] >= 0
                images.append((pb[i][keep_p], ps[i][keep_p], pl[i][keep_p],
                               gb[i][keep_g], gl[i][keep_g]))
        return images

    def compute(self, state) -> float:
        images = self._images(state)
        if not images:
            return 0.0
        all_labels = set()
        for _, _, pl, _, gl in images:
            all_labels.update(pl.tolist())
            all_labels.update(gl.tolist())
        classes = sorted(all_labels) if self.num_classes is None \
            else list(range(self.num_classes))
        aps = []
        for cls in classes:
            scores_all, tp_all = [], []
            n_gt = 0
            for pb, ps, pl, gb, gl in images:
                p_mask = pl == cls
                boxes, scores = pb[p_mask], ps[p_mask]
                gts = gb[gl == cls]
                n_gt += len(gts)
                # each detection pairs only with its argmax-IoU GT; a taken
                # GT makes it a false positive (mmdet tpfp_default)
                ious = _iou_matrix(boxes, gts)
                matched = np.zeros(len(gts), bool)
                tp = np.zeros(len(boxes), np.float32)
                for d in np.argsort(-scores, kind="stable"):
                    if len(gts) == 0:
                        continue
                    j = int(np.argmax(ious[d]))
                    if ious[d, j] >= self.iou_thr and not matched[j]:
                        matched[j] = True
                        tp[d] = 1.0
                scores_all.append(scores)
                tp_all.append(tp)
            if n_gt == 0:
                continue
            recalls, precisions = _precision_recall(scores_all, tp_all, n_gt)
            aps.append(_average_precision(recalls, precisions, self.mode))
        return float(np.mean(aps)) if aps else 0.0


@METRICS.register_class(name="CocoEvalMAP")
class CocoEvalMAP(MMDetectionMAP):
    """COCO-style mAP: AP over IoU 0.5:0.95:0.05 with 101-point
    interpolation, and the per-size variants; ``displayed_metrics`` selects
    the keys returned."""

    _AREAS = {"small": (0, 32 ** 2), "medium": (32 ** 2, 96 ** 2),
              "large": (96 ** 2, float("inf")), "all": (0, float("inf"))}

    def __init__(self, displayed_metrics=("map",), compute_on_step=False, num_classes=None,
                 **params):
        super().__init__(num_classes=num_classes)
        self.displayed_metrics = list(displayed_metrics)

    def _map_at(self, images, iou_thr, area_rng):
        lo, hi = area_rng
        aps = []
        all_labels = set()
        for _, _, _, _, gl in images:
            all_labels.update(gl.tolist())
        for cls in sorted(all_labels):
            scores_all, tp_all = [], []
            n_gt = 0
            for pb, ps, pl, gb, gl in images:
                gts = gb[gl == cls]
                g_area = np.clip(gts[:, 2] - gts[:, 0], 0, None) * \
                    np.clip(gts[:, 3] - gts[:, 1], 0, None)
                # out-of-area GT are ignored, not removed (pycocotools)
                gt_ignore = ~((g_area >= lo) & (g_area < hi))
                n_gt += int((~gt_ignore).sum())
                p_mask = pl == cls
                boxes, scores = pb[p_mask], ps[p_mask]
                b_area = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * \
                    np.clip(boxes[:, 3] - boxes[:, 1], 0, None)
                det_outside = ~((b_area >= lo) & (b_area < hi))
                s_kept, tp = _match_image(boxes, scores, gts, iou_thr, gt_ignore, det_outside)
                scores_all.append(s_kept)
                tp_all.append(tp)
            if n_gt == 0:
                continue
            recalls, precisions = _precision_recall(scores_all, tp_all, n_gt)
            mpre = precisions.copy()  # COCO 101-point interpolation
            for i in range(len(mpre) - 2, -1, -1):
                mpre[i] = max(mpre[i], mpre[i + 1])
            idxs = np.searchsorted(recalls, np.linspace(0, 1, 101), side="left")
            aps.append(float(np.mean([mpre[i] if i < len(mpre) else 0.0 for i in idxs])))
        return float(np.mean(aps)) if aps else 0.0

    def compute(self, state):
        images = self._images(state)
        if not images:
            return {m: 0.0 for m in self.displayed_metrics}
        iou_thrs = np.arange(0.5, 1.0, 0.05)
        out = {}
        for key in self.displayed_metrics:
            if key == "map":
                vals = [self._map_at(images, t, self._AREAS["all"]) for t in iou_thrs]
            elif key == "map_50":
                vals = [self._map_at(images, 0.5, self._AREAS["all"])]
            elif key == "map_75":
                vals = [self._map_at(images, 0.75, self._AREAS["all"])]
            elif key.startswith("map_"):
                area = self._AREAS.get(key.split("_", 1)[1], self._AREAS["all"])
                vals = [self._map_at(images, t, area) for t in iou_thrs]
            else:
                vals = [0.0]
            out[key] = float(np.mean(vals))
        return out


# the name reference recipes give the vendored torchmetrics-0.6 class
# (torchok/metrics/__init__.py:87)
METRICS.register_class(CocoEvalMAP, name="MeanAveragePrecision")
