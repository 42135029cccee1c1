"""BaseTask (reference: torchok/tasks/base.py:17-204; port of the part of
``torchok_tpu.tasks.base`` that evaluation needs).

A task owns an ``nn.Module`` (``self.model``) whose ``forward(batch)`` is the
reference's ``forward_with_gt``: it consumes the batch dict and returns the
outputs dict that the MetricsManager mappings refer to. The trainer moves
the model to its device and runs it; the task builds the dataloaders and the
metrics manager through the Constructor.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.constructor.config_structure import Phase
from torchok_tpu_torch.constructor.constructor import Constructor
from torchok_tpu_torch.data.loader import DataLoader

# precision -> autocast dtype (None: run in float32)
_PRECISION_TO_DTYPE = {
    "32": None, 32: None,
    "16": torch.bfloat16, 16: torch.bfloat16,
    "bf16": torch.bfloat16, "16-mixed": torch.bfloat16, "bf16-mixed": torch.bfloat16,
}


class BaseTask:
    def __init__(self, hparams: ConfigNode, **_):
        self._hparams = hparams
        self._constructor = Constructor(hparams)
        self.losses = self._constructor.configure_losses()
        self.metrics_manager = self._constructor.configure_metrics_manager()

        precision = (hparams.get("trainer") or {}).get("precision", 32)
        if precision not in _PRECISION_TO_DTYPE:
            raise ValueError(f"trainer.precision={precision!r} is not supported "
                             f"(one of {sorted(map(str, _PRECISION_TO_DTYPE))})")
        self.compute_dtype: Optional[torch.dtype] = _PRECISION_TO_DTYPE[precision]
        self.model: Optional[nn.Module] = None  # set by subclass

    @property
    def hparams(self) -> ConfigNode:
        return self._hparams

    @property
    def constructor(self) -> Constructor:
        return self._constructor

    def dataloaders(self, phase: Phase) -> List[DataLoader]:
        return self._constructor.create_dataloaders(phase)

    def test_dataloader(self) -> List[DataLoader]:
        return self.dataloaders(Phase.TEST)

    def predict_dataloader(self) -> List[DataLoader]:
        return self.dataloaders(Phase.PREDICT)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init of every parameter from an explicit generator."""
        raise NotImplementedError
