"""Trainer state."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

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
