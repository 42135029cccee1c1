"""SingleStageDetectionTask (reference: torchok/tasks/detection.py:13-173; port
of ``torchok_tpu.tasks.detection``).

backbone ``forward_features[-num_scales:]`` -> detection neck -> bbox head.
The head owns the loss (``bbox_head.loss(joint_loss, **outputs)``) and the
box decoding (``get_bboxes``). Predictions are decoded in eval only, into the padded
``prediction`` and ``target`` dicts the mAP metrics' ``preds``/``target``
mapping reads.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES, DETECTION_NECKS, HEADS, TASKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.ops.common import trunc_normal_init
from torchok_tpu_torch.tasks.base import BaseTask, size_to_inputs


class DetectionModel(nn.Module):
    def __init__(self, backbone: nn.Module, neck: Optional[nn.Module], bbox_head: nn.Module,
                 num_scales: int = 4):
        super().__init__()
        if getattr(neck, "requires_image", False):
            raise NotImplementedError(
                f"{type(neck).__name__} re-runs the backbone on the image (the detection RFP "
                "feedback), which is not ported yet")
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.num_scales = num_scales

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        x = batch["image"]
        features = self.backbone.forward_features(x)[-self.num_scales:]
        if self.neck is not None:
            features = self.neck(features)
        head_output = self.bbox_head.format_dict(self.bbox_head(features))
        # the input's (H, W) as host integers: the heads' losses scale boxes by it
        output = {**head_output, "img_shape": tuple(x.shape[2:])}
        if "bboxes" in batch:
            output["gt_bboxes"] = batch["bboxes"]
            output["gt_labels"] = batch["label"]
        if not self.training:
            preds = self.bbox_head.get_bboxes(**head_output, img_shape=tuple(x.shape[2:]))
            output["prediction_bboxes"] = preds["bboxes"]
            output["prediction_scores"] = preds["scores"]
            output["prediction_labels"] = preds["labels"]
            output["prediction"] = preds
            if "bboxes" in batch:
                output["target"] = {"bboxes": batch["bboxes"], "labels": batch["label"]}
        return output


@TASKS.register_class
class SingleStageDetectionTask(BaseTask):
    def __init__(self, hparams: ConfigNode, backbone_name: str, head_name: str,
                 neck_name: Optional[str] = None, num_scales: int = 4,
                 backbone_params: Optional[dict] = None, neck_params: Optional[dict] = None,
                 head_params: Optional[dict] = None, inputs: Optional[list] = None, **kwargs):
        # `inputs` (example input specs): the port's modules need no example
        # batch to initialise, but a backbone may size its tables by it
        super().__init__(hparams, **kwargs)
        backbone = BACKBONES.get(backbone_name)(**dict(backbone_params or {}))
        size_to_inputs(backbone, inputs)
        enc = tuple(backbone.out_encoder_channels)[-num_scales:]
        neck = None
        head_in = enc[-1]
        if neck_name:
            params = {k: v for k, v in dict(neck_params or {}).items() if k != "in_channels"}
            neck = DETECTION_NECKS.get(neck_name)(in_channels=enc, **params)
            head_in = neck.out_channels
        hp = dict(head_params or {})
        hp.setdefault("in_channels", head_in)
        self.model = DetectionModel(backbone, neck, HEADS.get(head_name)(**hp), num_scales)

    def compute_loss(self, outputs: Dict[str, Any]):
        """The head routes its outputs into the joint loss (reference
        detection.py:133)."""
        return self.model.bbox_head.loss(self.losses, **outputs)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial law part by part: the backbone's own
        (timm's truncated normal where it has none, as the classification
        task draws it), the neck's convs LeCun normal, the head's
        (``FCOSHead.init_weights``, ``DETRHead.init_weights``)."""
        for part in (self.model.backbone, self.model.neck, self.model.bbox_head):
            if part is None:
                continue
            if hasattr(part, "init_weights"):
                part.init_weights(generator)
            else:
                trunc_normal_init(part, generator)
