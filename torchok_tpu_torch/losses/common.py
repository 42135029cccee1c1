"""Losses the reference re-registers from ``torch.nn`` (reference:
torchok/losses/__init__.py:13-34; port of ``torchok_tpu.losses.common``).

Only ``CrossEntropyLoss`` is ported so far. Its arithmetic is written out as
in ``torchok_tpu`` (f32 log-softmax, one-hot with smoothing, the class
weight of the target applied to the whole smoothed term), so both packages
give the same value for every option; the class dimension is dim 1 of a
``(N, C)`` input, the only layout ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from torchok_tpu_torch.constructor import LOSSES


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "none":
        return x
    raise ValueError(f"Unknown reduction {reduction!r}")


@LOSSES.register_class
class CrossEntropyLoss:
    """Softmax cross-entropy over ``(N, C)`` logits: integer class targets
    or class-probability targets, optional class weights, ignore_index,
    label smoothing."""

    def __init__(self, weight: Optional[Sequence[float]] = None,
                 ignore_index: int = -100, reduction: str = "mean",
                 label_smoothing: float = 0.0):
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.label_smoothing = label_smoothing

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if input.dim() != 2:
            raise NotImplementedError(
                f"CrossEntropyLoss takes (N, C) logits so far, got {tuple(input.shape)}")
        logits = input.float()
        num_classes = logits.shape[-1]
        logp = F.log_softmax(logits, dim=-1)
        if target.dim() == logits.dim():  # probability targets
            loss = -torch.sum(target.float() * logp, dim=-1)
            mask = torch.ones_like(loss, dtype=torch.bool)
        else:
            tgt = target.long()
            mask = tgt != self.ignore_index
            safe = torch.where(mask, tgt, torch.zeros_like(tgt))
            onehot = F.one_hot(safe, num_classes).float()
            if self.label_smoothing > 0.0:
                eps = self.label_smoothing
                onehot = onehot * (1.0 - eps) + eps / num_classes
            loss = -torch.sum(onehot * logp, dim=-1)
            if self.weight is not None:
                w = self.weight.to(logits.device)[safe]
                loss = loss * w
                if self.reduction == "mean":
                    denom = torch.sum(torch.where(mask, w, torch.zeros_like(w)))
                    return torch.sum(torch.where(mask, loss, torch.zeros_like(loss))) \
                        / torch.clamp(denom, min=1e-12)
        loss = torch.where(mask, loss, torch.zeros_like(loss))
        if self.reduction == "mean":
            return torch.sum(loss) / torch.clamp(torch.sum(mask), min=1)
        return _reduce(loss, self.reduction)
