"""Trainer state."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, Iterable, List, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    """What the engine carries between steps: the model on the trainer's
    device (f32 parameters), and for training the optimizers with their
    state, the count of train steps taken (``step``, one per batch), the
    generator that every dropout and drop-path draw comes from and the one
    the train set's random device transforms draw from."""
    model: nn.Module
    optimizers: List[torch.optim.Optimizer] = field(default_factory=list)
    step: int = 0
    dropout_generator: Optional[torch.Generator] = None
    transform_generator: Optional[torch.Generator] = None
    # the JAX package's grad_mask and bn_mask, as the names they zero: the
    # parameters whose gradient the train step replaces by zeros (the
    # optimizer still steps them) and the BatchNorm modules whose running
    # statistics stay as they are in training forwards
    frozen_params: FrozenSet[str] = frozenset()
    frozen_stats: FrozenSet[str] = frozenset()

    def set_masks(self, params: Iterable[str], stats: Iterable[str]) -> None:
        """Freeze these parameters (``requires_grad`` off: autograd skips
        them and the step hands the optimizer zeros) and these BatchNorms'
        running statistics; everything else trains."""
        self.frozen_params, self.frozen_stats = frozenset(params), frozenset(stats)
        for name, p in self.model.named_parameters():
            p.requires_grad_(name not in self.frozen_params)
        for name, m in self.model.named_modules():
            if hasattr(m, "update_running_stats"):
                m.update_running_stats = name not in self.frozen_stats
