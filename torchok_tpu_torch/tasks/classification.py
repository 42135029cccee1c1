"""ClassificationTask (reference: torchok/tasks/classification.py:12-123;
port of ``torchok_tpu.tasks.classification``).

Assembles backbone -> pooling(opt) -> head(opt), wiring ``in_channels`` from
the previous stage's ``out_channels``. The forward-with-gt outputs mirror the
reference: ``embeddings``, ``prediction`` (when a head exists) and ``target``
passthrough.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES, HEADS, POOLINGS, TASKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.ops.common import trunc_normal_init
from torchok_tpu_torch.tasks.base import BaseTask


class ClassificationModel(nn.Module):
    def __init__(self, backbone: nn.Module, pooling: Optional[nn.Module] = None,
                 head: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.pooling = pooling
        self.head = head

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        target = batch.get("target")
        x = self.backbone(batch["image"])
        if self.pooling is not None:
            x = self.pooling(x)
        output = {"embeddings": x}
        if self.head is not None:
            output["prediction"] = self.head(x, target=target)
        if target is not None:
            output["target"] = target
        return output


@TASKS.register_class
class ClassificationTask(BaseTask):
    def __init__(self, hparams: ConfigNode,
                 backbone_name: str,
                 pooling_name: Optional[str] = None,
                 neck_name: Optional[str] = None,
                 head_name: Optional[str] = None,
                 backbone_params: Optional[dict] = None,
                 neck_params: Optional[dict] = None,
                 pooling_params: Optional[dict] = None,
                 head_params: Optional[dict] = None,
                 inputs: Optional[list] = None,
                 **kwargs):
        # `inputs` (example input specs) is accepted for recipe compatibility:
        # the port's modules need no example batch to initialise
        super().__init__(hparams, **kwargs)
        if neck_name:
            raise NotImplementedError("classification necks are not ported yet")
        backbone = BACKBONES.get(backbone_name)(**dict(backbone_params or {}))

        in_channels = backbone.out_channels
        pooling = None
        if pooling_name:
            pooling = POOLINGS.get(pooling_name)(in_channels=in_channels,
                                                 **dict(pooling_params or {}))
            in_channels = pooling.out_channels
        head = None
        if head_name:
            head = HEADS.get(head_name)(in_channels=in_channels, **dict(head_params or {}))
        self.model = ClassificationModel(backbone, pooling, head)

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_init(self.model, generator)
        # a backbone with an initial law of its own (ResNet: fan_out convs,
        # zero-initialised last norms) draws it after the shared one
        if hasattr(self.model.backbone, "init_weights"):
            self.model.backbone.init_weights(generator)
