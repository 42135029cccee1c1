"""ArcFace additive-angular-margin head (port of
``torchok_tpu.models.heads.classification.arcface_head``; reference:
torchok/models/heads/classification/arcface_head.py:13-135).

Eval mode gives the plain logits ``x @ weight.T``. Train mode gives the
margin logits in f32, cast to x's dtype. The dynamic-margin warm-up counter
``step`` is a persistent int32 buffer (``torchok_tpu``'s ``buffers``
collection): each training forward advances it by one, eval forwards leave
it alone, and the ``state_dict`` (so every checkpoint) carries it.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from torchok_tpu_torch.constructor import HEADS
from torchok_tpu_torch.models.base import BaseModel


@HEADS.register_class
class ArcFaceHead(BaseModel):
    def __init__(self, in_channels: int = 0, num_classes: int = 0,
                 scale: Optional[float] = None, margin: Optional[float] = None,
                 easy_margin: bool = False, dynamic_margin: bool = False,
                 num_warmup_steps: Optional[int] = None,
                 min_margin: Optional[float] = None):
        super().__init__()
        if dynamic_margin:
            if not isinstance(num_warmup_steps, int) or num_warmup_steps <= 0:
                raise ValueError("`num_warmup_steps` must be positive int when "
                                 "`dynamic_margin` is True")
            if min_margin is None:
                raise ValueError("`min_margin` must be float when `dynamic_margin` is True")
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.scale = scale
        self.margin = margin
        self.easy_margin = easy_margin
        self.dynamic_margin = dynamic_margin
        self.num_warmup_steps = num_warmup_steps
        self.min_margin = min_margin
        self.weight = nn.Parameter(torch.empty(num_classes, in_channels))
        nn.init.xavier_uniform_(self.weight)
        self.register_buffer("step", torch.zeros((), dtype=torch.int32))

    @property
    def out_channels(self) -> int:
        return self.num_classes

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.weight, generator=generator)

    def _default_scale(self) -> float:
        p = 0.999
        c1 = self.num_classes - 1
        return c1 / self.num_classes * math.log(c1 * p / (1 - p)) + 1

    def _default_margin(self) -> float:
        if self.in_channels == 2:
            return 0.9 - math.cos(2 * math.pi / self.num_classes)
        return 0.5 * self.num_classes / (self.num_classes - 1)

    def _margin_terms(self):
        """This forward's cos(m), sin(m), cos(pi - m) and sin(pi - m) m in f32
        and, with the dynamic margin, one more step on the counter. A static
        margin's terms are f32 numbers worked out on the host, so a forward
        copies nothing to the card and waits for nothing."""
        max_margin = self.margin if self.margin is not None else self._default_margin()
        if not self.dynamic_margin:
            m = np.float32(max_margin)
            rest = np.float32(np.pi) - m
            return (float(np.cos(m)), float(np.sin(m)), float(np.cos(rest)),
                    float(np.sin(rest) * m))
        frac = torch.clamp(self.step.float() / self.num_warmup_steps, 0.0, 1.0)
        margin = self.min_margin + frac * (max_margin - self.min_margin)
        self.step += 1
        rest = math.pi - margin
        return torch.cos(margin), torch.sin(margin), torch.cos(rest), torch.sin(rest) * margin

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            # eval mode = plain linear logits (reference arcface_head.py:120-121)
            return x @ self.weight.T
        if target is None:
            raise ValueError("Target is None in training mode.")
        scale = self.scale if self.scale is not None else self._default_scale()
        cos_m, sin_m, th, mm = self._margin_terms()

        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        wn = self.weight / (torch.linalg.vector_norm(self.weight, dim=-1, keepdim=True) + 1e-12)
        cosine = (xn @ wn.T).float()
        sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, 0.0, 1.0))
        phi = cosine * cos_m - sine * sin_m
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            phi = torch.where(cosine > th, phi, cosine - mm)
        one_hot = torch.arange(self.num_classes, device=x.device)[None, :] == target.reshape(-1, 1)
        output = torch.where(one_hot, phi, cosine) * scale
        return output.to(x.dtype)
