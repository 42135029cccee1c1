"""SimCLR v2 NT-Xent loss (port of
``torchok_tpu.losses.representation.unsupervised``; reference:
torchok/losses/representation/unsupervised.py:7-54; arXiv:2006.10029)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from torchok_tpu_torch.constructor import LOSSES


@LOSSES.register_class
class NT_XentLoss:
    """Softmax cross-entropy of each of the 2B views against its pair over
    the similarities to every other view (and to ``emb_m``, extra negatives,
    where given); a view's similarity to itself is set to -1e9."""

    def __init__(self, reduction: str = "mean", temperature: float = 1.0):
        self.reduction = reduction
        self.temperature = temperature

    def __call__(self, emb1: torch.Tensor, emb2: torch.Tensor,
                 emb_m: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch_size = emb1.shape[0]
        emb_left = torch.cat([emb1, emb2]).float()
        emb_right = emb_left if emb_m is None else torch.cat([emb1, emb2, emb_m]).float()
        sim = emb_left @ emb_right.T / self.temperature
        n2 = 2 * batch_size
        eye = torch.eye(n2, sim.shape[1], dtype=torch.bool, device=sim.device)
        sim = torch.where(eye, torch.full_like(sim, -1e9), sim)
        labels = torch.cat([torch.arange(batch_size, n2), torch.arange(batch_size)]).to(sim.device)
        logp = F.log_softmax(sim, dim=-1)
        loss = -torch.gather(logp, 1, labels[:, None])[:, 0]
        if self.reduction == "mean":
            return torch.mean(loss)
        if self.reduction == "sum":
            return torch.sum(loss)
        return loss
