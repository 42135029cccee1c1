"""ClassificationTask (reference: torchok/tasks/classification.py:12-123;
port of ``torchok_tpu.tasks.classification``).

Assembles backbone -> neck(opt) -> pooling(opt) -> head(opt), wiring
``in_channels`` from the previous stage's ``out_channels``. The
forward-with-gt outputs mirror the reference: ``embeddings``, ``prediction``
(when a head exists) and ``target`` passthrough, and the retrieval datasets'
``scores``, ``query_idxs`` and ``group_labels`` for the index-based meters'
representation mode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES, HEADS, NECKS, POOLINGS, TASKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.ops.common import trunc_normal_init
from torchok_tpu_torch.tasks.base import BaseTask, size_to_inputs


def forward_aux_keys(batch: Dict[str, Any], output: Dict[str, Any]) -> Dict[str, Any]:
    """Retrieval-dataset auxiliaries flow through to the index-based meters
    (representation mode)."""
    for key in ("scores", "query_idxs", "group_labels"):
        if batch.get(key) is not None:
            output[key] = batch[key]
    return output


class ClassificationModel(nn.Module):
    def __init__(self, backbone: nn.Module, neck: Optional[nn.Module] = None,
                 pooling: Optional[nn.Module] = None, head: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.pooling = pooling
        self.head = head

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        target = batch.get("target")
        x = self.backbone(batch["image"])
        if self.neck is not None:
            x = self.neck(x)
        if self.pooling is not None:
            x = self.pooling(x)
        output = {"embeddings": x}
        if self.head is not None:
            output["prediction"] = self.head(x, target=target)
        if target is not None:
            output["target"] = target
        return forward_aux_keys(batch, output)


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
        # `inputs` (example input specs): the port's modules need no example
        # batch to initialise, but a backbone may size its tables by it
        super().__init__(hparams, **kwargs)
        backbone = BACKBONES.get(backbone_name)(**dict(backbone_params or {}))
        size_to_inputs(backbone, inputs)

        in_channels = backbone.out_channels
        neck = None
        if neck_name:
            neck = NECKS.get(neck_name)(in_channels=in_channels, **dict(neck_params or {}))
            in_channels = neck.out_channels
        pooling = None
        if pooling_name:
            pooling = POOLINGS.get(pooling_name)(in_channels=in_channels,
                                                 **dict(pooling_params or {}))
            in_channels = pooling.out_channels
        head = None
        if head_name:
            head = HEADS.get(head_name)(in_channels=in_channels, **dict(head_params or {}))
        self.model = ClassificationModel(backbone, neck, pooling, head)

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_init(self.model, generator)
        # a part with an initial law of its own (ResNet, HRNet and its necks:
        # fan_out convs, zero-initialised last norms; PoolingLinear: nn.Dense's;
        # ArcFaceHead: Xavier) draws it after the shared one
        for part in (self.model.backbone, self.model.neck, self.model.pooling, self.model.head):
            if hasattr(part, "init_weights"):
                part.init_weights(generator)
