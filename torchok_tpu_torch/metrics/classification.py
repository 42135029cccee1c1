"""Classification metrics on stat-score states (port of the Accuracy and
F1Score part of ``torchok_tpu.metrics.classification``).

Functional equivalents of the torchmetrics classes the reference re-registers
(reference: torchok/metrics/__init__.py:47-64), with matching ``task=``
binary/multiclass/multilabel signatures and wrapper-default averaging. The
state is a per-class stat-score table [tp, fp, tn, fn] kept on the device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from torchok_tpu_torch.constructor import METRICS
from torchok_tpu_torch.metrics.base import Metric


def _binarize_preds(preds: torch.Tensor, task: str, threshold: float,
                    num_classes: Optional[int]) -> torch.Tensor:
    """Convert raw predictions (logits/probs/labels) to hard labels."""
    if task == "multiclass":
        if preds.ndim >= 2 and preds.shape[-1] == num_classes:
            return torch.argmax(preds, dim=-1)
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
            hard = torch.argmax(preds, dim=-1) if preds.ndim >= 2 else preds
            correct = (hard.reshape(-1) == target.reshape(-1)).sum().float()
            total = torch.tensor(float(target.numel()), device=correct.device)
            delta = torch.stack([correct, total - correct,
                                 torch.zeros_like(correct), total - correct])[None]
            return {"stats": state["stats"] + delta}
        if self.task == "multiclass":
            hard = _binarize_preds(preds, self.task, self.threshold, n).reshape(-1)
            tgt = target.long().reshape(-1)
            if self.ignore_index is None:
                mask = torch.ones_like(tgt, dtype=torch.bool)
            else:
                mask = tgt != self.ignore_index
            p1 = F.one_hot(hard, n).float() * mask[:, None]
            t1 = F.one_hot(torch.where(mask, tgt, 0), n).float() * mask[:, None]
        else:
            hard = _binarize_preds(preds, self.task, self.threshold, n)
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
