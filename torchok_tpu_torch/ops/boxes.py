"""Box ops: IoU, GIoU, FCOS encode/decode and a static-shape greedy NMS
(port of ``torchok_tpu.ops.boxes``). Boxes are (x1, y1, x2, y2).

The JAX package leaves these to XLA (no Pallas kernel), so the port writes
them as plain PyTorch on the boxes' device. The NMS keeps the reference's
static-shape formulation: ``max_out`` greedy steps, each an argmax over the
candidates still alive and one row of IoUs, with suppressed and padded
entries at score 0. The port runs it batched over images (leading dims), so
one loop of ``max_out`` steps serves a whole batch and nothing in it reads a
value back to the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0) * \
        torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0)


def _iou(a: torch.Tensor, b: torch.Tensor, area_a: torch.Tensor, area_b: torch.Tensor,
         eps: float) -> torch.Tensor:
    """IoU of broadcast boxes ``a`` and ``b`` with their areas given, in the
    JAX package's order of operations."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return inter / torch.clamp_min(union, eps)


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4) x b (..., M, 4) -> (..., N, M)."""
    return _iou(a[..., :, None, :], b[..., None, :, :], box_area(a)[..., :, None],
                box_area(b)[..., None, :], eps)


def giou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise GIoU between aligned boxes a, b of shape (..., 4)."""
    area_a, area_b = box_area(a), box_area(b)
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    iou = inter / torch.clamp_min(union, eps)
    # smallest enclosing box
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    ewh = torch.clamp_min(erb - elt, 0)
    enclose = torch.clamp_min(ewh[..., 0] * ewh[..., 1], eps)
    return iou - (enclose - union) / enclose


def distance2bbox(points: torch.Tensor, distances: torch.Tensor,
                  max_shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """FCOS decode: points (..., 2) + (l, t, r, b) distances (..., 4) -> boxes."""
    x1 = points[..., 0] - distances[..., 0]
    y1 = points[..., 1] - distances[..., 1]
    x2 = points[..., 0] + distances[..., 2]
    y2 = points[..., 1] + distances[..., 3]
    if max_shape is not None:
        h, w = max_shape
        x1, x2 = x1.clamp(0, w), x2.clamp(0, w)
        y1, y2 = y1.clamp(0, h), y2.clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2distance(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(l, t, r, b) distances from points (..., 2) to boxes (..., 4)."""
    return torch.stack([points[..., 0] - boxes[..., 0], points[..., 1] - boxes[..., 1],
                        boxes[..., 2] - points[..., 0], boxes[..., 3] - points[..., 1]],
                       dim=-1)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_out: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape greedy NMS over boxes (..., N, 4) and scores (..., N),
    suppressed or padded entries at score <= 0. Returns keep indices
    (..., max_out) and their scores; empty slots hold index -1 and score 0.
    Each step takes the first maximum of the live scores (``jnp.argmax``'s
    rule) and zeroes it and every box above ``iou_threshold`` against it."""
    alive = scores.float()
    area = box_area(boxes)
    idxs, kept = [], []
    for _ in range(max_out):
        best = torch.argmax(alive, dim=-1, keepdim=True)
        best_score = torch.gather(alive, -1, best)
        valid = best_score > 0
        best_box = torch.gather(boxes, -2, best[..., None].expand(*best.shape, 4))
        iou = _iou(best_box, boxes, torch.gather(area, -1, best), area, 1e-7)
        new = torch.where(iou > iou_threshold, torch.zeros_like(alive), alive)
        new = new.scatter(-1, best, 0.0)
        alive = torch.where(valid, new, alive)
        idxs.append(torch.where(valid, best, torch.full_like(best, -1)))
        kept.append(torch.where(valid, best_score, torch.zeros_like(best_score)))
    return torch.cat(idxs, -1), torch.cat(kept, -1)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                iou_threshold: float = 0.5, max_out: int = 100
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS via the coordinate-offset trick (boxes of different
    classes never overlap); the offset spans each image's own boxes."""
    span = boxes.amax(dim=(-2, -1), keepdim=True) - boxes.amin(dim=(-2, -1), keepdim=True)
    offsets = labels.float()[..., None] * (span + 1.0)
    return nms(boxes + offsets, scores, iou_threshold, max_out)
