"""SegmentationTask (reference: torchok/tasks/segmentation.py:12-98; port of
``torchok_tpu.tasks.segmentation``).

backbone.forward_features -> neck -> head; outputs ``{prediction, target}``
with NCHW logits. When a head returns ``(out, aux)`` the aux logits are
exposed as ``aux_prediction``, so a loss mapping can address them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES, HEADS, NECKS, TASKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.tasks.base import BaseTask, size_to_inputs


class SegmentationModel(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        target = batch.get("target")
        prediction = self.head(self.neck(self.backbone.forward_features(batch["image"])))
        output = {}
        if isinstance(prediction, tuple):
            output["prediction"], output["aux_prediction"] = prediction
        else:
            output["prediction"] = prediction
        if target is not None:
            output["target"] = target
        return output


@TASKS.register_class
class SegmentationTask(BaseTask):
    def __init__(self, hparams: ConfigNode,
                 backbone_name: str,
                 head_name: str,
                 neck_name: str,
                 backbone_params: Optional[dict] = None,
                 neck_params: Optional[dict] = None,
                 head_params: Optional[dict] = None,
                 inputs: Optional[list] = None,
                 **kwargs):
        # `inputs` (example input specs): the port's modules need no example
        # batch to initialise, but a backbone may size its tables by it
        super().__init__(hparams, **kwargs)
        backbone = BACKBONES.get(backbone_name)(**dict(backbone_params or {}))
        size_to_inputs(backbone, inputs)
        neck = NECKS.get(neck_name)(in_channels=tuple(backbone.out_encoder_channels),
                                    **dict(neck_params or {}))
        head = HEADS.get(head_name)(in_channels=neck.out_channels, **dict(head_params or {}))
        self.model = SegmentationModel(backbone, neck, head)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial law part by part: the backbone's and
        the neck's convs variance scaling over fan_out with their norms at
        one (each residual block's last at zero), the head's conv LeCun
        normal with a zero bias."""
        for part in (self.model.backbone, self.model.neck, self.model.head):
            part.init_weights(generator)
