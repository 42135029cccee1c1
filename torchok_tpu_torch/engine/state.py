"""Trainer state."""
from __future__ import annotations

from dataclasses import dataclass

from torch import nn


@dataclass
class TrainState:
    """What the engine carries between steps. For evaluation that is the
    model on the trainer's device; optimizer state joins with training."""
    model: nn.Module
