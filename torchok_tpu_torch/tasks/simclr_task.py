"""SimCLRTask (port of ``torchok_tpu.tasks.simclr_task``; reference:
torchok/tasks/simclr_task.py:9-82): the two augmented views ``image_0`` and
``image_1`` give ``emb1`` and ``emb2`` for NT-Xent."""
from __future__ import annotations

from typing import Any, Dict, Optional

from torch import nn

from torchok_tpu_torch.constructor import TASKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.tasks.classification import (ClassificationModel, ClassificationTask,
                                                    forward_aux_keys, inference_forward)


class SimCLRModel(nn.Module):
    def __init__(self, inner: ClassificationModel):
        super().__init__()
        self.inner = inner

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        with inference_forward(self.inner):
            output = {"emb1": self.inner.forward_image(batch["image_0"]),
                      "emb2": self.inner.forward_image(batch["image_1"])}
        return forward_aux_keys(batch, output)


@TASKS.register_class
class SimCLRTask(ClassificationTask):
    def __init__(self, hparams: ConfigNode, backbone_name: str,
                 pooling_name: Optional[str] = None, head_name: Optional[str] = None,
                 neck_name: Optional[str] = None, backbone_params: Optional[dict] = None,
                 neck_params: Optional[dict] = None, pooling_params: Optional[dict] = None,
                 head_params: Optional[dict] = None, inputs: Optional[list] = None,
                 **kwargs):
        super().__init__(hparams, backbone_name, pooling_name, neck_name, head_name,
                         backbone_params, neck_params, pooling_params, head_params,
                         inputs, **kwargs)
        self.model = SimCLRModel(self.model)

    def as_module(self) -> ClassificationModel:
        return self.model.inner
