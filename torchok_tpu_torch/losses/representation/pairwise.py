"""General Pair Weighting losses over a relevance matrix (port of
``torchok_tpu.losses.representation.pairwise``; reference:
torchok/losses/representation/pairwise.py:9-136; GPW paper arXiv:1912.06798).
Distances take the JAX package's matmul form, ||a-b||^2 = ||a||^2 + ||b||^2
- 2 a.b, floored at 1e-12 under the root."""
from __future__ import annotations

from typing import Optional

import torch

from torchok_tpu_torch.constructor import LOSSES


def cdist_l2(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pairwise Euclidean distances of the rows of ``a`` and ``b`` in f32,
    as one matmul."""
    a = a.float()
    b = b.float()
    sq = (torch.sum(a * a, dim=1)[:, None] + torch.sum(b * b, dim=1)[None, :]
          - 2.0 * a @ b.T)
    return torch.sqrt(torch.clamp(sq, min=eps))


class BasePairwiseLoss:
    """Regularisation and reduction shared by pairwise losses."""

    def __init__(self, reg: Optional[str] = None, reduction: Optional[str] = "mean",
                 eps: float = 1e-3):
        self.reg = reg
        self.reduction = reduction
        self.eps = eps

    def regularize(self, L: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if self.reg is None:
            return L
        if self.reg == "L1":
            return L + self.eps * torch.sum(torch.abs(emb), dim=1)
        if self.reg == "L2":
            return L + self.eps * torch.linalg.vector_norm(emb, dim=1)
        raise ValueError(f"Unknown regularization type: {self.reg}")

    def apply_reduction(self, L: torch.Tensor) -> torch.Tensor:
        if self.reduction == "mean":
            return torch.mean(L)
        if self.reduction == "sum":
            return torch.sum(L)
        raise ValueError(f"Unknown reduction type: {self.reduction}")


class GeneralPairWeightingLoss(BasePairwiseLoss):
    def __init__(self, margin: float, reg: Optional[str] = None,
                 reduction: Optional[str] = "mean", eps: float = 1e-3):
        super().__init__(reg=reg, reduction=reduction, eps=eps)
        self.margin = margin

    def __call__(self, emb1: torch.Tensor, emb2: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
        L = self.calc_loss(emb1, emb2, R)
        L = self.regularize(L, emb1)
        return self.apply_reduction(L)

    def calc_loss(self, emb1: torch.Tensor, emb2: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@LOSSES.register_class
class ContrastiveLoss(GeneralPairWeightingLoss):
    """Per row: the squared distances of its relevant pairs plus the squared
    hinge ``max(margin - d, 0)`` of its others, summed."""

    def calc_loss(self, emb1: torch.Tensor, emb2: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
        S = cdist_l2(emb1, emb2)
        R = R.float()
        L = (1.0 - R) * torch.clamp(self.margin - S, min=0.0) ** 2 + R * S ** 2
        return torch.sum(L, dim=1)
