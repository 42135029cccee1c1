"""PairwiseLearnTask (port of ``torchok_tpu.tasks.pairwise_task``; reference:
torchok/tasks/pairwise_task.py:11-107).

Metric learning with pairwise losses: one forward gives ``emb1 == emb2``
and the binary relevance matrix ``R`` of the batch's (multi)labels, one
one-hot product."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor import TASKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.tasks.classification import (ClassificationModel, ClassificationTask,
                                                    forward_aux_keys, inference_forward)


def calc_relevance_matrix(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, B) f32 relevance of a label vector (one-hot over ``num_classes``;
    a label outside it is relevant to nothing, as ``jax.nn.one_hot`` gives
    it a zero row) or of a multihot matrix: 1 where two rows share a class."""
    if y.dim() == 1:
        y = y[:, None] == torch.arange(num_classes, device=y.device)
    y = y.float()
    return ((y @ y.T) > 0).float()


class PairwiseModel(nn.Module):
    def __init__(self, inner: ClassificationModel, num_classes: int = 0):
        super().__init__()
        self.inner = inner
        self.num_classes = num_classes

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        target = batch.get("target")
        with inference_forward(self.inner):
            embedding = self.inner.forward_image(batch["image"])
        output = {"emb1": embedding, "emb2": embedding}
        if target is not None:
            output["R"] = calc_relevance_matrix(target, self.num_classes)
            output["target"] = target
        # the retrieval meters take plain embeddings too
        output["embeddings"] = embedding
        return forward_aux_keys(batch, output)


@TASKS.register_class
class PairwiseLearnTask(ClassificationTask):
    def __init__(self, hparams: ConfigNode, num_classes: int, backbone_name: str,
                 pooling_name: Optional[str] = None, head_name: Optional[str] = None,
                 neck_name: Optional[str] = None, backbone_params: Optional[dict] = None,
                 neck_params: Optional[dict] = None, pooling_params: Optional[dict] = None,
                 head_params: Optional[dict] = None, inputs: Optional[list] = None,
                 **kwargs):
        super().__init__(hparams, backbone_name, pooling_name, neck_name, head_name,
                         backbone_params, neck_params, pooling_params, head_params,
                         inputs, **kwargs)
        self.num_classes = num_classes
        self.model = PairwiseModel(self.model, num_classes)

    def as_module(self) -> ClassificationModel:
        return self.model.inner
