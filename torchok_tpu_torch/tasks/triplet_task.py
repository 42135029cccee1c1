"""TripletLearnTask (port of ``torchok_tpu.tasks.triplet_task``; reference:
torchok/tasks/triplet_task.py:11-50): the anchor, positive and negative
embeddings of a triplet batch in training; the classification forward on a
batch with ``image`` (validation)."""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from torchok_tpu_torch.constructor import TASKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.tasks.classification import (ClassificationModel, ClassificationTask,
                                                    inference_forward)

TRIPLET_KEYS = ("anchor", "positive", "negative")


class TripletModel(nn.Module):
    def __init__(self, inner: ClassificationModel):
        super().__init__()
        self.inner = inner

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        if "anchor" not in batch:
            return self.inner(batch)
        # the three images in one inference forward: no op of it mixes
        # images (BatchNorm on its running statistics)
        images = torch.cat([batch[k] for k in TRIPLET_KEYS])
        with inference_forward(self.inner):
            embeddings = self.inner.forward_image(images)
        return dict(zip(TRIPLET_KEYS, embeddings.split(batch["anchor"].shape[0])))


@TASKS.register_class
class TripletLearnTask(ClassificationTask):
    def __init__(self, hparams: ConfigNode, **kwargs):
        super().__init__(hparams, **kwargs)
        self.model = TripletModel(self.model)

    def as_module(self) -> ClassificationModel:
        return self.model.inner
