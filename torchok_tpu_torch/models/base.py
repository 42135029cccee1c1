"""Base model contracts (reference: torchok/models/base.py:8-63,
torchok/models/backbones/base_backbone.py:11-64).

Models are ``nn.Module``s over NCHW image tensors, the reference TorchOk
layout. A backbone's ``forward_features`` returns the ``[input] +
per-stage`` feature pyramid, as in ``torchok_tpu``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn


class BaseModel(nn.Module):
    """Contract: every model declares its output channel arity
    (``out_channels``) so the task can wire stage boundaries (backbone ->
    neck -> pooling -> head) from the config alone."""


class BaseBackbone(BaseModel):
    """Backbone contract: staged feature extractor.

    ``forward(x)``            -> final (deepest) feature map, NCHW.
    ``forward_features(x)``   -> ``[input, stage1, ...]`` list, NCHW.
    ``out_encoder_channels``  -> channels of each pyramid entry after the
                                 input (shallow -> deep).
    """

    @property
    def out_encoder_channels(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        raise NotImplementedError
