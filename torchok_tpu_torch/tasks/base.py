"""BaseTask (reference: torchok/tasks/base.py:17-204; port of the part of
``torchok_tpu.tasks.base`` that classification training and evaluation need).

A task owns an ``nn.Module`` (``self.model``) whose ``forward(batch)`` is the
reference's ``forward_with_gt``: it consumes the batch dict and returns the
outputs dict that the JointLoss and MetricsManager mappings refer to. The
trainer moves the model to its device and runs it; the task builds the
dataloaders, the joint loss and the metrics manager through the Constructor.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

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


def input_shapes(inputs: Optional[list]) -> List[Tuple[int, ...]]:
    """The CHW shape of each ``inputs`` spec of a task's config."""
    return [tuple(int(d) for d in spec["shape"]) for spec in inputs or []]


def size_to_inputs(backbone: nn.Module, inputs: Optional[list]) -> None:
    """A backbone whose parameter shapes follow its input (BEiT's position
    tables: ``set_input_size``) takes the (H, W) of the first ``inputs``
    spec (CHW), the example input the JAX package initialises with."""
    if inputs and hasattr(backbone, "set_input_size"):
        backbone.set_input_size(tuple(inputs[0]["shape"])[-2:])


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
        # CHW of each ``inputs`` spec: the example input export traces with
        self.input_shapes: List[Tuple[int, ...]] = []

    @property
    def hparams(self) -> ConfigNode:
        return self._hparams

    @property
    def constructor(self) -> Constructor:
        return self._constructor

    def dataloaders(self, phase: Phase) -> List[DataLoader]:
        return self._constructor.create_dataloaders(phase)

    def train_dataloader(self) -> List[DataLoader]:
        return self.dataloaders(Phase.TRAIN)

    def val_dataloader(self) -> List[DataLoader]:
        return self.dataloaders(Phase.VALID)

    def test_dataloader(self) -> List[DataLoader]:
        return self.dataloaders(Phase.TEST)

    def predict_dataloader(self) -> List[DataLoader]:
        return self.dataloaders(Phase.PREDICT)

    def no_weight_decay(self) -> List[str]:
        """Parameter-path fragments the backbone keeps out of weight decay."""
        backbone = getattr(self.as_module(), "backbone", None)
        return list(getattr(backbone, "no_weight_decay", lambda: [])())

    def as_module(self) -> nn.Module:
        """The model whose ``forward_image`` export traces (``torchok_tpu``'s
        ``as_module``); a wrapper task (pairwise, triplet, SimCLR) gives the
        classification model it wraps."""
        return self.model

    def compute_loss(self, outputs: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Map step outputs to the joint loss: (f32 total, tagged values)."""
        if self.losses is None:
            device = next(self.model.parameters()).device
            return torch.zeros((), device=device), {}
        return self.losses(**outputs)

    @property
    def compute_loss_on_valid(self) -> bool:
        return bool(self._hparams.task.get("compute_loss_on_valid", True))

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init of every parameter from an explicit generator."""
        raise NotImplementedError
