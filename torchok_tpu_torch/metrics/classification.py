"""Classification metrics (port of the Accuracy, F1Score and confusion-matrix
part of ``torchok_tpu.metrics.classification``).

Functional equivalents of the torchmetrics classes the reference re-registers
(reference: torchok/metrics/__init__.py:47-64), with matching ``task=``
binary/multiclass/multilabel signatures and wrapper-default averaging. The
state is a per-class stat-score table [tp, fp, tn, fn] or a C x C confusion
matrix of counts, kept on the device and read back once per ``compute``.

A multiclass prediction with one more dim than its target carries its
classes at dim 1: ``(N, C)`` logits for ``(N,)`` labels, ``(N, C, H, W)``
for ``(N, H, W)`` pixel labels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from torchok_tpu_torch.constructor import METRICS
from torchok_tpu_torch.metrics.base import Metric


def _binarize_preds(preds: torch.Tensor, target: torch.Tensor, task: str, threshold: float,
                    num_classes: Optional[int]) -> torch.Tensor:
    """Convert raw predictions (logits/probs/labels) to hard labels."""
    if task == "multiclass":
        if preds.ndim == target.ndim + 1:
            if (preds.shape[0], *preds.shape[2:]) != tuple(target.shape) or \
                    (num_classes is not None and preds.shape[1] != num_classes):
                raise ValueError(
                    f"multiclass predictions {tuple(preds.shape)} take their {num_classes} "
                    f"classes at dim 1 (N, C, d1, ...), which does not fit the target "
                    f"{tuple(target.shape)}")
            return torch.argmax(preds, dim=1)
        return preds.long()
    # binary / multilabel: floats are scores, ints are labels
    if preds.is_floating_point():
        is_prob = torch.all((preds >= 0) & (preds <= 1))
        probs = torch.where(is_prob, preds, torch.sigmoid(preds))
        return (probs > threshold).long()
    return preds.long()


class StatScoresMetric(Metric):
    """Shared machinery: accumulates per-class [tp, fp, tn, fn]."""

    default_average = "micro"

    def __init__(self, task: str = "multiclass", num_classes: Optional[int] = None,
                 num_labels: Optional[int] = None, threshold: float = 0.5,
                 average: Optional[str] = None, ignore_index: Optional[int] = None,
                 top_k: int = 1, **params):
        super().__init__(**params)
        if top_k != 1:
            raise NotImplementedError("top_k > 1 is not ported yet")
        self.task = task
        self.num_classes = num_classes
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average if average is not None else self.default_average
        self.ignore_index = ignore_index

    @property
    def _n(self) -> int:
        if self.task == "multiclass":
            # num_classes omitted: a single micro bucket
            return self.num_classes if self.num_classes is not None else 1
        if self.task == "multilabel":
            return self.num_labels
        return 1

    def empty_state(self, device):
        return {"stats": torch.zeros((self._n, 4), dtype=torch.float32, device=device)}

    def update(self, state, preds: torch.Tensor, target: torch.Tensor, **_):
        n = self._n
        if self.task == "multiclass" and self.num_classes is None:
            hard = _binarize_preds(preds, target, self.task, self.threshold, None)
            correct = (hard.reshape(-1) == target.reshape(-1)).sum().float()
            total = torch.tensor(float(target.numel()), device=correct.device)
            delta = torch.stack([correct, total - correct,
                                 torch.zeros_like(correct), total - correct])[None]
            return {"stats": state["stats"] + delta}
        if self.task == "multiclass":
            hard = _binarize_preds(preds, target, self.task, self.threshold, n).reshape(-1)
            tgt = target.long().reshape(-1)
            if self.ignore_index is None:
                mask = torch.ones_like(tgt, dtype=torch.bool)
            else:
                mask = tgt != self.ignore_index
            p1 = F.one_hot(hard, n).float() * mask[:, None]
            t1 = F.one_hot(torch.where(mask, tgt, 0), n).float() * mask[:, None]
        else:
            hard = _binarize_preds(preds, target, self.task, self.threshold, n)
            hard = hard.reshape(-1, n if self.task == "multilabel" else 1)
            p1, t1 = hard.float(), target.reshape(hard.shape).float()
        tp = torch.sum(p1 * t1, dim=0)
        fp = torch.sum(p1 * (1 - t1), dim=0)
        fn = torch.sum((1 - p1) * t1, dim=0)
        tn = torch.sum((1 - p1) * (1 - t1), dim=0)
        return {"stats": state["stats"] + torch.stack([tp, fp, tn, fn], dim=1)}

    def _averaged(self, per_class: torch.Tensor, stats: torch.Tensor):
        if self.average in (None, "none"):
            return {str(i): float(v) for i, v in enumerate(per_class)}
        if self.average == "macro":
            return float(torch.mean(per_class))
        if self.average == "weighted":
            support = stats[:, 0] + stats[:, 3]  # tp + fn
            w = support / torch.clamp(torch.sum(support), min=1e-12)
            return float(torch.sum(per_class * w))
        raise ValueError(f"Unknown average {self.average!r}")

    def _score(self, tp, fp, tn, fn):
        raise NotImplementedError

    def compute(self, state):
        stats = state["stats"]
        if self.average == "micro":
            tp, fp, tn, fn = torch.sum(stats, dim=0)
            return float(self._score(tp, fp, tn, fn))
        per_class = self._score(stats[:, 0], stats[:, 1], stats[:, 2], stats[:, 3])
        return self._averaged(per_class, stats)


def _safe_div(a, b):
    return a / torch.clamp(b, min=1e-12)


@METRICS.register_class(name="Accuracy")
class Accuracy(StatScoresMetric):
    def _score(self, tp, fp, tn, fn):
        if self.task == "multiclass":
            # micro: fraction correct; per class: recall (torchmetrics macro acc)
            return _safe_div(tp, tp + fn)
        return _safe_div(tp + tn, tp + fp + tn + fn)


@METRICS.register_class(name="F1Score")
class F1Score(StatScoresMetric):
    def _score(self, tp, fp, tn, fn):
        return _safe_div(2 * tp, 2 * tp + fp + fn)


# The confusion metrics' arithmetic on the host in f32, operation by
# operation as the JAX package's (counts are exact integers in f32 up to
# 2**24): sums in index order, and a mean as that sum times 1/n, the order
# XLA's CPU reduction gives ``jnp.sum`` and ``jnp.mean`` of up to 16 values.


def _f32_sum(v: np.ndarray) -> np.float32:
    total = np.float32(0.0)
    for x in np.asarray(v, np.float32).reshape(-1):
        total = np.float32(total + x)
    return total


def _f32_mean(v: np.ndarray) -> np.float32:
    return np.float32(_f32_sum(v) * np.float32(1.0 / np.asarray(v).size))


def _f32_div(a, b) -> np.ndarray:
    return np.float32(a) / np.maximum(np.float32(b), np.float32(1e-12))


class ConfusionBased(Metric):
    """Metrics of the full C x C confusion matrix (rows: target, columns:
    prediction), accumulated as int64 counts on the device."""

    def __init__(self, task: str = "multiclass", num_classes: Optional[int] = None,
                 num_labels: Optional[int] = None, threshold: float = 0.5,
                 average: Optional[str] = None, ignore_index: Optional[int] = None,
                 **params):
        super().__init__(**params)
        self.task = task
        self.num_classes = num_classes if task == "multiclass" else (num_labels or 2)
        self.threshold = threshold
        self.average = average
        self.ignore_index = ignore_index

    @property
    def _n(self) -> int:
        return self.num_classes if self.task == "multiclass" else 2

    def empty_state(self, device):
        return {"cm": torch.zeros((self._n, self._n), dtype=torch.int64, device=device)}

    def update(self, state, preds: torch.Tensor, target: torch.Tensor, **_):
        n = self._n
        hard = _binarize_preds(preds, target, self.task, self.threshold,
                               self.num_classes).reshape(-1)
        tgt = target.reshape(-1).long()
        idx = tgt * n + hard
        if self.ignore_index is not None:
            # an ignored pixel goes to the bin past the matrix, which is dropped
            idx = torch.where(tgt != self.ignore_index, idx, n * n)
        cm = torch.bincount(idx, minlength=n * n + 1)[:n * n].reshape(n, n)
        return {"cm": state["cm"] + cm}

    @staticmethod
    def _matrix(state) -> np.ndarray:
        return state["cm"].cpu().numpy().astype(np.float32)


@METRICS.register_class(name="ConfusionMatrix")
class ConfusionMatrix(ConfusionBased):
    def compute(self, state):
        cm = self._matrix(state)
        return {f"{i}_{j}": float(cm[i, j]) for i in range(cm.shape[0])
                for j in range(cm.shape[1])}


@METRICS.register_class(name="CohenKappa")
class CohenKappa(ConfusionBased):
    def compute(self, state):
        cm = self._matrix(state)
        total = _f32_sum(cm)
        po = _f32_div(_f32_sum(np.diag(cm)), total)
        pe = _f32_div(_f32_sum(cm.sum(0) * cm.sum(1)), total * total)
        return float(_f32_div(po - pe, np.float32(1.0) - pe))


@METRICS.register_class(name="MatthewsCorrCoef")
class MatthewsCorrCoef(ConfusionBased):
    def compute(self, state):
        cm = self._matrix(state)
        t, p = cm.sum(1), cm.sum(0)
        c, s = _f32_sum(np.diag(cm)), _f32_sum(cm)
        num = c * s - _f32_sum(t * p)
        den = np.sqrt(np.maximum((s * s - _f32_sum(p * p)) * (s * s - _f32_sum(t * t)),
                                 np.float32(1e-12)))
        return float(np.float32(num / den))


@METRICS.register_class(name="JaccardIndex")
class JaccardIndex(ConfusionBased):
    """Intersection over union per class, macro-averaged by default over all
    ``num_classes``, an ignored class included (its IoU is 0), as the JAX
    package averages it (torchmetrics leaves that class out)."""

    def compute(self, state):
        cm = self._matrix(state)
        tp = np.diag(cm)
        union = cm.sum(0) + cm.sum(1) - tp
        iou = _f32_div(tp, union)
        avg = self.average or "macro"
        if avg == "micro":
            return float(_f32_div(_f32_sum(tp), _f32_sum(union)))
        if avg in ("none", None):
            return {str(i): float(v) for i, v in enumerate(iou)}
        return float(_f32_mean(iou))


@METRICS.register_class(name="Dice")
class Dice(ConfusionBased):
    def compute(self, state):
        cm = self._matrix(state)
        tp = np.diag(cm)
        denom = cm.sum(0) + cm.sum(1)
        avg = self.average or "micro"
        if avg == "micro":
            return float(_f32_div(2 * _f32_sum(tp), _f32_sum(denom)))
        return float(_f32_mean(_f32_div(2 * tp, denom)))
