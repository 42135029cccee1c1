"""Soft Dice loss for binary, multiclass and multilabel segmentation
(reference: torchok/losses/segmentation/dice.py:86-188; port of
``torchok_tpu.losses.segmentation.dice``).

NCHW as in torch and TorchOk: multiclass and multilabel logits are
``(N, C, H, W)``, binary ones ``(N, H, W)``; a multiclass target is the
``(N, H, W)`` class map, a binary or multilabel one has the input's shape.
Probabilities are taken in f32 (``exp`` of the log-softmax or log-sigmoid,
as the JAX package takes them); channels with no true pixel are zeroed, and
``classes`` picks the channels averaged.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from torchok_tpu_torch.constructor import LOSSES
from torchok_tpu_torch.losses.common import check_class_dim

BINARY_MODE = "binary"
MULTICLASS_MODE = "multiclass"
MULTILABEL_MODE = "multilabel"


def soft_dice_score(pred: torch.Tensor, target: torch.Tensor, smooth: float, eps: float,
                    dims: Tuple[int, ...]) -> torch.Tensor:
    intersection = torch.sum(pred * target, dim=dims)
    cardinality = torch.sum(pred + target, dim=dims)
    return (2.0 * intersection + smooth) / torch.clamp(cardinality + smooth, min=eps)


@LOSSES.register_class
class DiceLoss:
    def __init__(self, mode: str, classes: Optional[List[int]] = None,
                 log_loss: bool = False, from_logits: bool = True,
                 smooth: float = 0.0, eps: float = 1e-7):
        if mode not in {BINARY_MODE, MULTICLASS_MODE, MULTILABEL_MODE}:
            raise ValueError(f"DiceLoss mode {mode!r} not supported")
        if classes is not None and mode == BINARY_MODE:
            raise ValueError("Masking classes is not supported with mode=binary")
        self.mode = mode
        self.classes = None if classes is None else torch.as_tensor(classes, dtype=torch.long)
        self.log_loss = log_loss
        self.from_logits = from_logits
        self.smooth = smooth
        self.eps = eps

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        x = input.float()
        bs = x.shape[0]
        if self.mode == MULTICLASS_MODE:
            check_class_dim("DiceLoss(multiclass)", x, target)
            if target.shape == x.shape:
                raise ValueError(f"DiceLoss(multiclass): the target must be the class map "
                                 f"{(bs,) + tuple(x.shape[2:])}, got {tuple(target.shape)}")
            num_classes = x.shape[1]
            if self.from_logits:
                x = torch.exp(F.log_softmax(x, dim=1))
            x = x.reshape(bs, num_classes, -1)
            # one-hot with no column for a label outside [0, C), as jax.nn.one_hot
            classes = torch.arange(num_classes, device=target.device)
            t = (target.reshape(bs, 1, -1) == classes[:, None]).to(x.dtype)
        elif self.mode == MULTILABEL_MODE:
            if target.shape != x.shape:
                raise ValueError(f"DiceLoss(multilabel): the target must have the input's "
                                 f"shape {tuple(x.shape)}, got {tuple(target.shape)}")
            num_classes = x.shape[1]
            if self.from_logits:
                x = torch.exp(F.logsigmoid(x))
            x = x.reshape(bs, num_classes, -1)
            t = target.reshape(bs, num_classes, -1).to(x.dtype)
        else:
            if target.shape != x.shape:
                raise ValueError(f"DiceLoss(binary): the target must have the input's "
                                 f"shape {tuple(x.shape)}, got {tuple(target.shape)}")
            if self.from_logits:
                x = torch.exp(F.logsigmoid(x))
            x = x.reshape(bs, 1, -1)
            t = target.reshape(bs, 1, -1).to(x.dtype)

        dims = (0, 2)
        scores = soft_dice_score(x, t, self.smooth, self.eps, dims)
        if self.log_loss:
            loss = -torch.log(torch.clamp(scores, min=self.eps))
        else:
            loss = 1.0 - scores
        # zero out channels with no true pixels (dice undefined there)
        loss = loss * (torch.sum(t, dim=dims) > 0).to(loss.dtype)
        if self.classes is not None:
            loss = loss[self.classes.to(loss.device)]
        return torch.mean(loss)
