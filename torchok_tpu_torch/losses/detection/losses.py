"""Detection losses (port of ``torchok_tpu.losses.detection.losses``;
reference: torchok/losses/detection/mmdet_losses.py, which re-registers every
mmdet ``*Loss`` as ``MM<Name>``).

Every loss takes an optional elementwise ``weight`` and an ``avg_factor``
(mmdet semantics: ``sum(loss * weight) / avg_factor``), so a detection head
can normalise by its positive count; a vector of avg factors reduces the
groups of a leading axis separately (DETR's decoder layers). Inputs are cast to f32, as in the JAX
package; each class is registered under the names of
``torchok_tpu/losses/detection/losses.py:505-532``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from torchok_tpu_torch.constructor import LOSSES
from torchok_tpu_torch.ops.boxes import giou


def _weighted_reduce(loss, weight, avg_factor, reduction="mean"):
    """``sum(loss * weight) / avg_factor`` (or the mean). An ``avg_factor`` of
    shape (G,) with ``loss`` of leading size G reduces each group alone and
    returns (G,): DETR's decoder layers in one call."""
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    if avg_factor is not None:
        avg_factor = torch.as_tensor(avg_factor)
        if avg_factor.ndim == 1:
            return torch.sum(loss.reshape(avg_factor.shape[0], -1), 1) / \
                torch.clamp_min(avg_factor, 1e-6)
        return torch.sum(loss) / torch.clamp_min(avg_factor, 1e-6)
    return torch.mean(loss)


def _one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot whose out-of-range labels (mmdet's background ``C``) are
    all zeros, as ``jax.nn.one_hot`` gives them."""
    classes = torch.arange(num_classes, device=target.device)
    return (target.long()[..., None] == classes).float()


def _bce(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits as the JAX package spells it."""
    return t * F.softplus(-x) + (1 - t) * F.softplus(x)


class _Loss:
    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def _out(self, loss, weight, avg_factor):
        return self.loss_weight * _weighted_reduce(loss, weight, avg_factor, self.reduction)


class FocalLoss(_Loss):
    """Sigmoid focal loss (RetinaNet/FCOS classification). pred: (N, C)
    logits; target: (N,) labels, ``C`` for background (mmdet)."""

    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0, alpha: float = 0.25,
                 reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.gamma = gamma
        self.alpha = alpha

    def __call__(self, pred, target, weight=None, avg_factor=None):
        logits = pred.float()
        t = _one_hot(target, logits.shape[-1])
        p = torch.sigmoid(logits)
        ce = _bce(logits, t)
        p_t = p * t + (1 - p) * (1 - t)
        alpha_t = self.alpha * t + (1 - self.alpha) * (1 - t)
        loss = torch.sum(alpha_t * (1 - p_t) ** self.gamma * ce, dim=-1)
        return self._out(loss, weight, avg_factor)


class GIoULoss(_Loss):
    def __init__(self, eps: float = 1e-6, reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.eps = eps

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = 1.0 - giou(pred.float(), target.float(), self.eps)
        return self._out(loss, weight, avg_factor)


def _areas(a, b):
    area_a = torch.clamp_min(a[..., 2] - a[..., 0], 0) * torch.clamp_min(a[..., 3] - a[..., 1], 0)
    area_b = torch.clamp_min(b[..., 2] - b[..., 0], 0) * torch.clamp_min(b[..., 3] - b[..., 1], 0)
    return area_a, area_b


def _iou_and_enclose(a, b, eps):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a, area_b = _areas(a, b)
    iou = inter / torch.clamp_min(area_a + area_b - inter, eps)
    e_wh = torch.clamp_min(torch.maximum(a[..., 2:], b[..., 2:])
                           - torch.minimum(a[..., :2], b[..., :2]), 0.0)
    return iou, e_wh


class IoULoss(_Loss):
    def __init__(self, eps: float = 1e-6, reduction: str = "mean", loss_weight: float = 1.0,
                 mode: str = "log"):
        super().__init__(reduction, loss_weight)
        self.eps = eps
        self.mode = mode

    def __call__(self, pred, target, weight=None, avg_factor=None):
        iou, _ = _iou_and_enclose(pred.float(), target.float(), self.eps)
        if self.mode == "log":
            loss = -torch.log(torch.clamp(iou, self.eps, 1.0))
        elif self.mode == "square":
            loss = 1.0 - iou ** 2
        else:
            loss = 1.0 - iou
        return self._out(loss, weight, avg_factor)


class CrossEntropySigmoidLoss(_Loss):
    """mmdet CrossEntropyLoss: BCE on logits with ``use_sigmoid`` (FCOS's
    centerness), else softmax cross-entropy over the last dim (DETR)."""

    def __init__(self, use_sigmoid: bool = True, reduction: str = "mean",
                 loss_weight: float = 1.0, class_weight: Optional[float] = None):
        super().__init__(reduction, loss_weight)
        self.use_sigmoid = use_sigmoid
        self.class_weight = class_weight  # scalar class weight (mmdet DETR cfg)

    def __call__(self, cls_score, label, weight=None, avg_factor=None):
        x = cls_score.float()
        if self.use_sigmoid:
            loss = _bce(x, label.float())
        else:
            loss = -torch.sum(_one_hot(label, x.shape[-1]) * F.log_softmax(x, -1), -1)
        return self._out(loss, weight, avg_factor)


class L1DetLoss(_Loss):
    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = torch.sum(torch.abs(pred.float() - target.float()), -1)
        return self._out(loss, weight, avg_factor)


def _boxes_cxcywh(b):
    cx = (b[..., 0] + b[..., 2]) * 0.5
    cy = (b[..., 1] + b[..., 3]) * 0.5
    w = torch.clamp_min(b[..., 2] - b[..., 0], 0.0)
    h = torch.clamp_min(b[..., 3] - b[..., 1], 0.0)
    return cx, cy, w, h


class DIoULoss(_Loss):
    """Distance-IoU: IoU penalised by the normalised centre distance."""

    def __init__(self, eps: float = 1e-6, reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.eps = eps

    def _terms(self, pred, target):
        a, b = pred.float(), target.float()
        iou, e_wh = _iou_and_enclose(a, b, self.eps)
        ca, cb = _boxes_cxcywh(a), _boxes_cxcywh(b)
        rho2 = (ca[0] - cb[0]) ** 2 + (ca[1] - cb[1]) ** 2
        c2 = e_wh[..., 0] ** 2 + e_wh[..., 1] ** 2 + self.eps
        return iou, rho2 / c2, ca, cb

    def __call__(self, pred, target, weight=None, avg_factor=None):
        iou, dist, _, _ = self._terms(pred, target)
        return self._out(1.0 - iou + dist, weight, avg_factor)


class CIoULoss(DIoULoss):
    """Complete-IoU: DIoU plus the aspect-ratio consistency term."""

    def __call__(self, pred, target, weight=None, avg_factor=None):
        iou, dist, (_, _, aw, ah), (_, _, bw, bh) = self._terms(pred, target)
        v = (4.0 / math.pi ** 2) * (
            torch.atan(bw / torch.clamp_min(bh, self.eps))
            - torch.atan(aw / torch.clamp_min(ah, self.eps))) ** 2
        alpha = (v / torch.clamp_min(1.0 - iou + v, self.eps)).detach()
        return self._out(1.0 - iou + dist + alpha * v, weight, avg_factor)


class BoundedIoULoss(_Loss):
    """mmdet BoundedIoULoss: smooth-L1 on per-coordinate IoU bounds."""

    def __init__(self, beta: float = 0.2, eps: float = 1e-3, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.beta = beta
        self.eps = eps

    def __call__(self, pred, target, weight=None, avg_factor=None):
        acx, acy, aw, ah = _boxes_cxcywh(pred.float())
        bcx, bcy, bw, bh = _boxes_cxcywh(target.float())
        dx, dy, eps = bcx - acx, bcy - acy, self.eps
        loss_dx = 1.0 - torch.clamp_min(
            (bw - 2 * torch.abs(dx)) / torch.clamp_min(bw + 2 * torch.abs(dx), eps), 0)
        loss_dy = 1.0 - torch.clamp_min(
            (bh - 2 * torch.abs(dy)) / torch.clamp_min(bh + 2 * torch.abs(dy), eps), 0)
        loss_dw = 1.0 - torch.minimum(bw / torch.clamp_min(aw, eps), aw / torch.clamp_min(bw, eps))
        loss_dh = 1.0 - torch.minimum(bh / torch.clamp_min(ah, eps), ah / torch.clamp_min(bh, eps))
        comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
        loss = torch.where(comb < self.beta, 0.5 * comb ** 2 / self.beta, comb - 0.5 * self.beta)
        return self._out(torch.sum(loss, dim=-1), weight, avg_factor)


class BalancedL1Loss(_Loss):
    """Libra R-CNN balanced L1."""

    def __init__(self, alpha: float = 0.5, gamma: float = 1.5, beta: float = 1.0,
                 reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.alpha, self.gamma, self.beta = alpha, gamma, beta

    def __call__(self, pred, target, weight=None, avg_factor=None):
        d = torch.abs(pred.float() - target.float())
        b = math.e ** (self.gamma / self.alpha) - 1
        small = (self.alpha / b) * (b * d + 1) * torch.log(b * d / self.beta + 1) - self.alpha * d
        large = self.gamma * d + self.gamma / b - self.alpha * self.beta
        loss = torch.sum(torch.where(d < self.beta, small, large), dim=-1)
        return self._out(loss, weight, avg_factor)


class SmoothL1DetLoss(_Loss):
    def __init__(self, beta: float = 1.0, reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.beta = beta

    def __call__(self, pred, target, weight=None, avg_factor=None):
        d = torch.abs(pred.float() - target.float())
        loss = torch.sum(torch.where(d < self.beta, 0.5 * d ** 2 / self.beta,
                                     d - 0.5 * self.beta), dim=-1)
        return self._out(loss, weight, avg_factor)


class MSEDetLoss(_Loss):
    def __call__(self, pred, target, weight=None, avg_factor=None):
        return self._out((pred.float() - target.float()) ** 2, weight, avg_factor)


class DistributionFocalLoss(_Loss):
    """GFL distribution focal loss: cross-entropy against the two integral
    neighbour bins of a continuous target. pred: (N, n_bins) logits;
    target: (N,) in [0, n_bins - 1]."""

    def __call__(self, pred, target, weight=None, avg_factor=None):
        t = target.float()
        left = torch.floor(t).long()
        right = torch.clamp_max(left + 1, pred.shape[-1] - 1)
        wl = right.float() - t
        wr = t - left.float()
        logp = F.log_softmax(pred.float(), dim=-1)
        loss = -(torch.gather(logp, -1, left[..., None])[..., 0] * wl
                 + torch.gather(logp, -1, right[..., None])[..., 0] * wr)
        return self._out(loss, weight, avg_factor)


class QualityFocalLoss(_Loss):
    """GFL quality focal loss: sigmoid focal weighting against a soft
    (N, C) IoU-quality score map."""

    def __init__(self, use_sigmoid: bool = True, beta: float = 2.0, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.beta = beta

    def __call__(self, pred, target, weight=None, avg_factor=None):
        x, t = pred.float(), target.float()
        loss = torch.sum(torch.abs(torch.sigmoid(x) - t) ** self.beta * _bce(x, t), dim=-1)
        return self._out(loss, weight, avg_factor)


class GaussianFocalLoss(_Loss):
    """CornerNet/CenterNet focal loss on gaussian heatmaps."""

    def __init__(self, alpha: float = 2.0, gamma: float = 4.0, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.alpha, self.gamma = alpha, gamma

    def __call__(self, pred, target, weight=None, avg_factor=None):
        p = torch.clamp(pred.float(), 1e-6, 1 - 1e-6)
        t = target.float()
        pos = (t == 1).float()
        neg_w = (1 - t) ** self.gamma
        loss = -(pos * (1 - p) ** self.alpha * torch.log(p)
                 + (1 - pos) * neg_w * p ** self.alpha * torch.log(1 - p))
        return self._out(loss, weight, avg_factor)


class VarifocalLoss(_Loss):
    """VarifocalNet loss: asymmetric focal BCE against IACS targets."""

    def __init__(self, use_sigmoid: bool = True, alpha: float = 0.75, gamma: float = 2.0,
                 iou_weighted: bool = True, reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.alpha, self.gamma, self.iou_weighted = alpha, gamma, iou_weighted

    def __call__(self, pred, target, weight=None, avg_factor=None):
        x, t = pred.float(), target.float()
        ce = _bce(x, t)
        pos = (t > 0).float()
        neg = self.alpha * torch.abs(torch.sigmoid(x) - t) ** self.gamma * (1 - pos)
        focal_w = (t * pos if self.iou_weighted else pos) + neg
        loss = torch.sum(focal_w * ce, dim=-1) if ce.ndim > 1 else focal_w * ce
        return self._out(loss, weight, avg_factor)


def _harmonizing_weights(g, weight, bins):
    """GHM's per-element weights from a per-batch gradient-density histogram
    (momentum 0): ``1 / density`` of each element's bin."""
    valid = torch.ones_like(g, dtype=torch.bool) if weight is None else \
        torch.broadcast_to(torch.as_tensor(weight, device=g.device), g.shape) > 0
    n_valid = torch.clamp_min(torch.sum(valid.float()), 1.0)
    edges = torch.linspace(0.0, 1.0 + 1e-6, bins + 1, device=g.device)
    idx = torch.clamp(torch.searchsorted(edges, g.contiguous(), right=True) - 1, 0, bins - 1)
    counts = torch.zeros(bins, device=g.device).index_add_(0, idx.reshape(-1),
                                                           valid.reshape(-1).float())
    density = counts[idx] * torch.count_nonzero(counts) / n_valid
    w = torch.where(valid, 1.0 / torch.clamp_min(density, 1e-6), torch.zeros_like(density))
    return w, n_valid


class GHMC(_Loss):
    """Gradient-harmonizing classification loss, its histogram computed per
    batch (the JAX package's momentum-0 semantics)."""

    def __init__(self, bins: int = 10, momentum: float = 0.0, use_sigmoid: bool = True,
                 reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.bins = bins

    def __call__(self, pred, target, weight=None, avg_factor=None):
        x, t = pred.float(), target.float()
        g = torch.abs(torch.sigmoid(x) - t).detach()
        w, n_valid = _harmonizing_weights(g, weight, self.bins)
        loss = _bce(x, t) * w
        if self.reduction == "mean":
            return self.loss_weight * torch.sum(loss) / n_valid
        return self._out(loss, None, avg_factor)


class GHMR(_Loss):
    """Gradient-harmonizing regression loss (authentic smooth-L1 ASL1 form)."""

    def __init__(self, mu: float = 0.02, bins: int = 10, momentum: float = 0.0,
                 reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.mu, self.bins = mu, bins

    def __call__(self, pred, target, weight=None, avg_factor=None):
        d = pred.float() - target.float()
        mu = self.mu
        loss = torch.sqrt(d ** 2 + mu ** 2) - mu
        g = torch.abs(d / torch.sqrt(d ** 2 + mu ** 2)).detach()
        w, n_valid = _harmonizing_weights(g, weight, self.bins)
        return self.loss_weight * torch.sum(loss * w) / n_valid


class KnowledgeDistillationKLDivLoss(_Loss):
    """KL divergence between temperature-softened student/teacher logits."""

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0, T: int = 10):
        super().__init__(reduction, loss_weight)
        self.T = T

    def __call__(self, pred, soft_label, weight=None, avg_factor=None):
        T = self.T
        logp = F.log_softmax(pred.float() / T, dim=-1)
        q = F.softmax(soft_label.float() / T, dim=-1)
        loss = torch.sum(q * (torch.log(torch.clamp_min(q, 1e-12)) - logp), dim=-1) * T * T
        return self._out(loss, weight, avg_factor)


class SeesawLoss(_Loss):
    """Seesaw loss with static class frequencies (``class_counts``); plain
    cross-entropy where they are absent."""

    def __init__(self, p: float = 0.8, q: float = 2.0, num_classes: int = 1203,
                 class_counts=None, eps: float = 1e-2, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.p, self.q, self.num_classes, self.eps = p, q, num_classes, eps
        self.counts = None if class_counts is None else \
            torch.as_tensor(class_counts, dtype=torch.float32)

    def __call__(self, pred, target, weight=None, avg_factor=None):
        x = pred.float()
        onehot = _one_hot(target, x.shape[-1])
        if self.counts is not None and self.p > 0:
            counts = torch.clamp_min(self.counts[:x.shape[-1]].to(x.device), 1.0)
            ratio = counts[None, :] / counts[:, None]  # N_j / N_i
            mitigation = torch.where(ratio < 1.0, ratio ** self.p, torch.ones_like(ratio))
            x = x + torch.log(torch.clamp_min(mitigation[target.long()], self.eps)) * (1 - onehot)
        if self.q > 0:
            sig = F.softmax(x.detach(), dim=-1)
            score = sig / torch.gather(sig, -1, target.long()[..., None])
            compensation = torch.where(score > 1.0, score ** self.q, torch.ones_like(score))
            x = x + torch.log(torch.clamp_min(compensation, self.eps)) * (1 - onehot)
        loss = -torch.sum(onehot * F.log_softmax(x, dim=-1), dim=-1)
        return self._out(loss, weight, avg_factor)


# the native and mmdet-parity names of torchok_tpu/losses/detection/losses.py:505-532
REGISTERED = {
    "FocalLoss": FocalLoss, "MMFocalLoss": FocalLoss,
    "GIoULoss": GIoULoss, "MMGIoULoss": GIoULoss,
    "IoULoss": IoULoss, "MMIoULoss": IoULoss,
    "DIoULoss": DIoULoss, "MMDIoULoss": DIoULoss,
    "CIoULoss": CIoULoss, "MMCIoULoss": CIoULoss,
    "BoundedIoULoss": BoundedIoULoss, "MMBoundedIoULoss": BoundedIoULoss,
    "BalancedL1Loss": BalancedL1Loss, "MMBalancedL1Loss": BalancedL1Loss,
    "MMSmoothL1Loss": SmoothL1DetLoss,
    "MMMSELoss": MSEDetLoss,
    "DistributionFocalLoss": DistributionFocalLoss,
    "MMDistributionFocalLoss": DistributionFocalLoss,
    "QualityFocalLoss": QualityFocalLoss, "MMQualityFocalLoss": QualityFocalLoss,
    "GaussianFocalLoss": GaussianFocalLoss, "MMGaussianFocalLoss": GaussianFocalLoss,
    "VarifocalLoss": VarifocalLoss, "MMVarifocalLoss": VarifocalLoss,
    "GHMC": GHMC, "MMGHMC": GHMC,
    "GHMR": GHMR, "MMGHMR": GHMR,
    "KnowledgeDistillationKLDivLoss": KnowledgeDistillationKLDivLoss,
    "MMKnowledgeDistillationKLDivLoss": KnowledgeDistillationKLDivLoss,
    "SeesawLoss": SeesawLoss, "MMSeesawLoss": SeesawLoss,
    "MMCrossEntropyLoss": CrossEntropySigmoidLoss,
    "MML1Loss": L1DetLoss,
}
for _name, _cls in REGISTERED.items():
    LOSSES.register_class(_cls, name=_name)
