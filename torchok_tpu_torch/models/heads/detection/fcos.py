"""FCOS detection head (reference: torchok/models/heads/detection/fcos.py:20-221,
an mmdet FCOSHead subclass; port of ``torchok_tpu.models.heads.detection.fcos``;
FCOS: arXiv:1904.01355).

The head owns its target assignment and loss routing: ``loss`` hands the
task's JointLoss its flattened outputs under the keys the recipes map
(``flatten_cls_scores``, ``flatten_labels``, ``num_pos``,
``pos_decoded_bbox_preds``, ``pos_decoded_target_preds``,
``pos_centerness_targets``, ``centerness_denorm``, ``pos_centerness``).

As in the JAX package the positives are never gathered (a data-dependent
shape): every array keeps all points, and padding makes the other slots
contribute nothing: zero IoU-loss weights through ``pos_centerness_targets``,
decoded targets at a unit box where no box is assigned, centerness logits
pinned to -30. ``get_bboxes`` decodes with a per-level ``nms_pre`` top-k
(ties to the lower index, as ``jax.lax.top_k``), a score threshold and a
class-aware static-shape NMS, batched over the images, into padded
(B, max_per_img) outputs.

NCHW in and out: per level ``cls_score`` (B, C, H, W), ``bbox_pred``
(B, 4, H, W) and ``centerness`` (B, 1, H, W), as mmdet gives them; points
are flattened row-major over (H, W), as the JAX package's NHWC reshape
orders them. Module names are mmdet's (``cls_convs.{i}.conv``/``.gn``,
``reg_convs.{i}.*``, ``conv_cls``, ``conv_reg``, ``conv_centerness``,
``scales.{i}.scale``). GroupNorm takes Flax's epsilon 1e-6 (torch's is
1e-5, which shows at 2 channels a group).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.constructor import HEADS
from torchok_tpu_torch.models.base import BaseModel
from torchok_tpu_torch.models.necks.detection.fpn import lecun_init
from torchok_tpu_torch.ops.boxes import batched_nms, distance2bbox
from torchok_tpu_torch.ops.knn import topk_lower_index

INF = 1e8


class Scale(nn.Module):
    """A learned scalar factor (mmcv's ``Scale``)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


class _ConvGN(nn.Module):
    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, channels, 3, padding=1)
        self.gn = nn.GroupNorm(32, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(self.conv(x)))


def _flatten(levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, K, H, W) maps -> (B, sum H*W, K), points row-major."""
    return torch.cat([x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])
                      for x in levels], 1)


@HEADS.register_class
class FCOSHead(BaseModel):
    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges: Sequence[Tuple[float, float]] = (
                     (-1, 64), (64, 128), (128, 256), (256, 512), (512, INF)),
                 center_sampling: bool = False, center_sample_radius: float = 1.5,
                 norm_on_bbox: bool = False, centerness_on_reg: bool = False,
                 score_thr: float = 0.05, nms_iou_threshold: float = 0.6, nms_pre: int = 1000,
                 max_per_img: int = 100, train_cfg: Any = None, test_cfg: Any = None, **_):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.regress_ranges = tuple(tuple(r) for r in regress_ranges)
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.norm_on_bbox = norm_on_bbox
        self.centerness_on_reg = centerness_on_reg
        self.score_thr = score_thr
        self.nms_iou_threshold = nms_iou_threshold
        self.nms_pre = nms_pre
        self.max_per_img = max_per_img
        self.train_cfg = train_cfg  # accepted for the recipes: FCOS's assigner is implicit
        self.test_cfg = test_cfg  # overrides the flat test fields
        ins = [in_channels] + [feat_channels] * (stacked_convs - 1)
        self.cls_convs = nn.ModuleList(_ConvGN(c, feat_channels) for c in ins)
        self.reg_convs = nn.ModuleList(_ConvGN(c, feat_channels) for c in ins)
        self.conv_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.conv_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.conv_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList(Scale(1.0) for _ in self.strides)
        self._points: Dict[Any, Tuple[torch.Tensor, ...]] = {}

    @property
    def out_channels(self) -> int:
        return self.num_classes

    def _test_cfg(self, key: str, default):
        tc = self.test_cfg or {}
        if hasattr(tc, "to_dict"):
            tc = tc.to_dict()
        if key == "iou_threshold":
            return (tc.get("nms") or {}).get("iou_threshold", default)
        return tc.get(key, default)

    # ------------------------------------------------------------------
    def forward(self, feats: List[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
        """The towers and output convs are shared across levels; only the
        per-level Scale differs (the FCOS paper's design)."""
        cls_scores, bbox_preds, centernesses = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for cls_conv, reg_conv in zip(self.cls_convs, self.reg_convs):
                cls_feat = cls_conv(cls_feat)
                reg_feat = reg_conv(reg_feat)
            reg_out = self.scales[lvl](self.conv_reg(reg_feat))
            # stride-normalised distances (relu) in train and eval alike
            reg_out = F.relu(reg_out) if self.norm_on_bbox else torch.exp(reg_out)
            cls_scores.append(self.conv_cls(cls_feat))
            bbox_preds.append(reg_out)
            centernesses.append(self.conv_centerness(reg_feat if self.centerness_on_reg
                                                     else cls_feat))
        return cls_scores, bbox_preds, centernesses

    @staticmethod
    def format_dict(head_output) -> Dict[str, Any]:
        return dict(zip(["cls_scores", "bbox_preds", "centernesses"], head_output))

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX head's law: LeCun normal tower convs with zero biases,
        GroupNorms at one and zero, the three output convs N(0, 0.01) with the
        classifier's bias at the prior -log(99), scales at one."""
        lecun_init(self, generator)
        for m in self.modules():
            if isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for conv in (self.conv_cls, self.conv_reg, self.conv_centerness):
            nn.init.normal_(conv.weight, std=0.01, generator=generator)
        nn.init.constant_(self.conv_cls.bias, -math.log((1 - 0.01) / 0.01))
        for s in self.scales:
            nn.init.ones_(s.scale)

    # ------------------------------------------------------------------
    def _level_points(self, featmap_sizes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Point grid over all levels: (P, 2) centres, (P,) strides, (P, 2)
        regress ranges."""
        if len(featmap_sizes) != len(self.strides):
            raise ValueError(f"FCOSHead got {len(featmap_sizes)} feature levels but "
                             f"{len(self.strides)} strides")
        if len(self.regress_ranges) < len(self.strides):
            raise ValueError(f"regress_ranges ({len(self.regress_ranges)}) must cover every "
                             f"stride ({len(self.strides)}); override both together")
        pts, strides, ranges = [], [], []
        for (h, w), s, rr in zip(featmap_sizes, self.strides, self.regress_ranges):
            ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            pts.append(np.stack([(xs.reshape(-1) + 0.5) * s, (ys.reshape(-1) + 0.5) * s], -1))
            strides.append(np.full((h * w,), s, np.float32))
            ranges.append(np.tile(np.array(rr, np.float32)[None], (h * w, 1)))
        return (np.concatenate(pts).astype(np.float32), np.concatenate(strides),
                np.concatenate(ranges))

    def _device_points(self, levels: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """``_level_points`` on the levels' device, copied there once per
        feature-map geometry."""
        sizes = tuple(tuple(x.shape[2:]) for x in levels)
        key = (sizes, levels[0].device)
        if key not in self._points:
            self._points[key] = tuple(torch.from_numpy(a).to(levels[0].device)
                                      for a in self._level_points(sizes))
        return self._points[key]

    def _assign_targets(self, points, strides, ranges, gt_bboxes, gt_labels):
        """FCOS assignment of a batch. points (P, 2); gt_bboxes (B, M, 4) and
        gt_labels (B, M) with label -1 padding. Returns labels (B, P), the
        background as ``num_classes``, and bbox_targets (B, P, 4): each point
        takes the smallest box that holds it within its level's range."""
        p = points[None, :, None, :]  # (1, P, 1, 2)
        gt = gt_bboxes[:, None].float()  # (B, 1, M, 4)
        dists = torch.stack([p[..., 0] - gt[..., 0], p[..., 1] - gt[..., 1],
                             gt[..., 2] - p[..., 0], gt[..., 3] - p[..., 1]], -1)  # (B, P, M, 4)
        inside = torch.amin(dists, -1) > 0
        if self.center_sampling:
            cx = (gt[..., 0] + gt[..., 2]) / 2
            cy = (gt[..., 1] + gt[..., 3]) / 2
            radius = strides[None, :, None] * self.center_sample_radius
            inside = inside & (torch.abs(p[..., 0] - cx) < radius) & \
                (torch.abs(p[..., 1] - cy) < radius)
        max_dist = torch.amax(dists, -1)
        in_range = (max_dist >= ranges[None, :, None, 0]) & (max_dist <= ranges[None, :, None, 1])
        valid_gt = (gt_labels >= 0)[:, None, :]
        area = torch.clamp_min(gt[..., 2] - gt[..., 0], 0) * \
            torch.clamp_min(gt[..., 3] - gt[..., 1], 0)
        masked_area = torch.where(inside & in_range & valid_gt, area,
                                  torch.full_like(area, INF))
        min_area, gt_idx = torch.min(masked_area, -1)  # the first minimum, as jnp.argmin
        labels = torch.where(min_area < INF, torch.gather(gt_labels, 1, gt_idx),
                             torch.full_like(gt_idx, self.num_classes))
        bbox_targets = torch.gather(dists, 2, gt_idx[..., None, None].expand(
            *gt_idx.shape, 1, 4))[:, :, 0]
        return labels, bbox_targets

    @staticmethod
    def centerness_target(bbox_targets: torch.Tensor) -> torch.Tensor:
        lr = bbox_targets[..., [0, 2]]
        tb = bbox_targets[..., [1, 3]]
        c = (torch.amin(lr, -1) / torch.clamp_min(torch.amax(lr, -1), 1e-12)) * \
            (torch.amin(tb, -1) / torch.clamp_min(torch.amax(tb, -1), 1e-12))
        return torch.sqrt(torch.clamp_min(c, 0))

    def loss(self, joint_loss, cls_scores, bbox_preds, centernesses, gt_bboxes, gt_labels,
             **kwargs):
        """The joint loss of a batch: gt_bboxes (B, M, 4), gt_labels (B, M)
        with -1 padding."""
        points, strides, ranges = self._device_points(cls_scores)
        labels, bbox_targets = self._assign_targets(points, strides, ranges, gt_bboxes,
                                                    gt_labels)
        if self.norm_on_bbox:
            bbox_targets = bbox_targets / strides[None, :, None]
        num_imgs = cls_scores[0].shape[0]
        flat_cls = _flatten(cls_scores).reshape(-1, self.num_classes).float()
        flat_reg = _flatten(bbox_preds).reshape(-1, 4).float()
        flat_ctr = _flatten(centernesses).reshape(-1).float()
        flat_labels = labels.reshape(-1)
        flat_targets = bbox_targets.reshape(-1, 4)
        flat_points = points.repeat(num_imgs, 1)

        pos_mask = (flat_labels >= 0) & (flat_labels < self.num_classes)
        posf = pos_mask.float()
        num_pos = torch.clamp_min(torch.sum(posf), 1.0)
        pos_ctr_targets = self.centerness_target(flat_targets) * posf  # zero off the positives
        centerness_denorm = torch.clamp_min(torch.sum(pos_ctr_targets), 1e-6)
        decoded_preds = distance2bbox(flat_points, flat_reg)
        safe_targets = torch.where(pos_mask[:, None], flat_targets,
                                   torch.ones_like(flat_targets))
        decoded_targets = distance2bbox(flat_points, safe_targets)
        # centerness BCE: logits off the positives pinned to -30 (no
        # gradient, loss ~1e-13)
        pos_ctr_logits = torch.where(pos_mask, flat_ctr, torch.full_like(flat_ctr, -30.0))
        return joint_loss(
            flatten_cls_scores=flat_cls,
            flatten_labels=flat_labels,
            num_pos=num_pos,
            pos_decoded_bbox_preds=decoded_preds,
            pos_decoded_target_preds=decoded_targets,
            pos_centerness_targets=pos_ctr_targets,
            centerness_denorm=centerness_denorm,
            pos_centerness=pos_ctr_logits,
        )

    # ------------------------------------------------------------------
    def get_bboxes(self, cls_scores, bbox_preds, centernesses,
                   img_shape: Optional[Tuple[int, int]] = None,
                   **kwargs) -> Dict[str, torch.Tensor]:
        """Decode + class-aware NMS of a batch: ``bboxes`` (B, max_per_img,
        4), ``scores`` (B, max_per_img) and ``labels`` (B, max_per_img), empty
        slots at 0, 0 and -1."""
        points, strides, _ = self._device_points(cls_scores)
        flat_cls = _flatten(cls_scores)
        flat_reg = _flatten(bbox_preds)
        flat_ctr = _flatten(centernesses)[..., 0]
        if self.norm_on_bbox:
            flat_reg = flat_reg * strides[None, :, None]
        scores = torch.sigmoid(flat_cls.float()) * torch.sigmoid(flat_ctr.float())[..., None]

        nms_pre = self._test_cfg("nms_pre", self.nms_pre)
        score_thr = self._test_cfg("score_thr", self.score_thr)
        iou_thr = self._test_cfg("iou_threshold", self.nms_iou_threshold)
        max_per_img = self._test_cfg("max_per_img", self.max_per_img)
        # nms_pre per level (as mmdet), so dense shallow levels cannot crowd
        # the deep ones out
        c = self.num_classes
        b = scores.shape[0]
        cand_scores, cand_pts, cand_cls = [], [], []
        start = 0
        for x in cls_scores:
            n = x.shape[2] * x.shape[3]
            level = scores[:, start:start + n].reshape(b, -1)
            top_scores, top_idx = topk_lower_index(level, min(nms_pre, level.shape[1]))
            cand_scores.append(top_scores)
            cand_pts.append(start + top_idx // c)
            cand_cls.append(top_idx % c)
            start += n
        top_scores = torch.cat(cand_scores, 1)
        pt_idx = torch.cat(cand_pts, 1)
        cls_idx = torch.cat(cand_cls, 1)
        reg = torch.gather(flat_reg, 1, pt_idx[..., None].expand(*pt_idx.shape, 4))
        boxes = distance2bbox(points[pt_idx], reg, max_shape=img_shape)
        top_scores = torch.where(top_scores > score_thr, top_scores, torch.zeros_like(top_scores))
        keep_idx, keep_scores = batched_nms(boxes, top_scores, cls_idx, iou_threshold=iou_thr,
                                            max_out=max_per_img)
        valid = keep_idx >= 0
        safe = torch.clamp_min(keep_idx, 0)
        out_boxes = torch.gather(boxes, 1, safe[..., None].expand(*safe.shape, 4))
        out_boxes = torch.where(valid[..., None], out_boxes, torch.zeros_like(out_boxes))
        out_labels = torch.where(valid, torch.gather(cls_idx, 1, safe),
                                 torch.full_like(safe, -1))
        return {"bboxes": out_boxes, "scores": keep_scores, "labels": out_labels}
