"""Losses the reference re-registers from ``torch.nn`` (reference:
torchok/losses/__init__.py:13-34; port of ``torchok_tpu.losses.common``).

``CrossEntropyLoss``, ``TripletMarginLoss`` and
``TripletMarginWithDistanceLoss`` are ported so far. The cross-entropy's
arithmetic is written out as in ``torchok_tpu`` (f32 log-softmax, one-hot
with smoothing, the class weight of the target applied to the whole
smoothed term), so both packages
give the same value for every option. The class dimension is dim 1 of an
``(N, C)`` or ``(N, C, d1, ...)`` input, as in torch and TorchOk; the JAX
package takes the same logits channels-last.
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


def check_class_dim(name: str, input: torch.Tensor, target: torch.Tensor) -> None:
    """Raise unless ``target`` is class indices of ``input``'s shape less its
    class dim 1, or ``input``'s own shape (probabilities, one-hot or labels
    per channel)."""
    if input.dim() < 2:
        raise ValueError(f"{name}: input of shape {tuple(input.shape)} has no class dim 1")
    indices = (input.shape[0],) + tuple(input.shape[2:])
    if tuple(target.shape) not in (indices, tuple(input.shape)):
        raise ValueError(
            f"{name}: input {tuple(input.shape)} takes its classes at dim 1 (N, C, d1, ...), "
            f"so the target must be {indices} or {tuple(input.shape)}, got "
            f"{tuple(target.shape)}")


@LOSSES.register_class
class CrossEntropyLoss:
    """Softmax cross-entropy over ``(N, C)`` or ``(N, C, d1, ...)`` logits:
    integer class targets ``(N, d1, ...)`` or class-probability targets of
    the input's shape, optional class weights, ignore_index, label
    smoothing. ``reduction="none"`` gives ``(N, d1, ...)``."""

    def __init__(self, weight: Optional[Sequence[float]] = None,
                 ignore_index: int = -100, reduction: str = "mean",
                 label_smoothing: float = 0.0):
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.label_smoothing = label_smoothing

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        check_class_dim("CrossEntropyLoss", input, target)
        # the class dim last, as the JAX package takes the logits (a view:
        # the (N, C) path is unchanged)
        logits = input.float().movedim(1, -1)
        num_classes = logits.shape[-1]
        logp = F.log_softmax(logits, dim=-1)
        if target.dim() == logits.dim():  # probability targets
            loss = -torch.sum(target.float().movedim(1, -1) * logp, dim=-1)
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


def _pairwise_distance(a: torch.Tensor, b: torch.Tensor, p: float = 2.0,
                       eps: float = 1e-6) -> torch.Tensor:
    """``torchok_tpu``'s p-norm of ``|a - b| + eps`` over the last dim (torch's
    ``pairwise_distance`` adds eps before the absolute value)."""
    d = torch.abs(a - b) + eps
    return torch.sum(d ** p, dim=-1) ** (1.0 / p)


@LOSSES.register_class
class TripletMarginLoss:
    """``max(d(a, p) - d(a, n) + margin, 0)`` with the p-norm distance;
    ``swap`` takes the smaller of d(a, n) and d(p, n)."""

    def __init__(self, margin: float = 1.0, p: float = 2.0, eps: float = 1e-6,
                 swap: bool = False, reduction: str = "mean"):
        self.margin = margin
        self.p = p
        self.eps = eps
        self.swap = swap
        self.reduction = reduction

    def __call__(self, anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor) -> torch.Tensor:
        d_ap = _pairwise_distance(anchor, positive, self.p, self.eps)
        d_an = _pairwise_distance(anchor, negative, self.p, self.eps)
        if self.swap:
            d_an = torch.minimum(d_an, _pairwise_distance(positive, negative, self.p, self.eps))
        loss = torch.clamp(d_ap - d_an + self.margin, min=0.0)
        return _reduce(loss, self.reduction)


@LOSSES.register_class
class TripletMarginWithDistanceLoss:
    """``torch.nn.TripletMarginWithDistanceLoss`` with the distance named
    (``euclidean`` or ``cosine``), since a YAML file carries no callable."""

    def __init__(self, distance_function: str = "euclidean", margin: float = 1.0,
                 swap: bool = False, reduction: str = "mean"):
        self.distance_function = distance_function
        self.margin = margin
        self.swap = swap
        self.reduction = reduction

    def _dist(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.distance_function == "cosine":
            cos = torch.sum(a * b, -1) / (torch.linalg.vector_norm(a, dim=-1)
                                          * torch.linalg.vector_norm(b, dim=-1) + 1e-12)
            return 1.0 - cos
        return torch.linalg.vector_norm(a - b, dim=-1)

    def __call__(self, anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor) -> torch.Tensor:
        d_ap = self._dist(anchor, positive)
        d_an = self._dist(anchor, negative)
        if self.swap:
            d_an = torch.minimum(d_an, self._dist(positive, negative))
        loss = torch.clamp(d_ap - d_an + self.margin, min=0.0)
        return _reduce(loss, self.reduction)
