"""JointLoss: weighted multi-loss with output->input mapping
(reference: torchok/losses/base.py:7-113; port of ``torchok_tpu.losses.base``).

Losses are plain callables over tensors (no parameters); JointLoss maps the
task's outputs dict onto each loss's arguments, and returns the weighted
total with the individually tagged values.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


class JointLoss:
    def __init__(self, losses: List[Callable], mappings: List[Dict[str, str]],
                 tags: List[Optional[str]], weights: List[Optional[float]],
                 normalize_weights: bool = True):
        self.losses = losses
        self.tag2loss = {tag: loss for tag, loss in zip(tags, losses) if tag is not None}
        self.tags = tags
        self.mappings = mappings

        num_specified = sum(w is not None for w in weights)
        if num_specified > 0 and num_specified != len(losses):
            raise ValueError(
                "Loss weights must be either specified for each loss function "
                "or not specified for any loss function"
            )
        ws = [1.0] * len(losses) if num_specified == 0 else list(weights)
        if normalize_weights:
            total = sum(ws)
            if total == 0:
                raise ValueError(
                    "JointLoss weights sum to 0; set normalize_weights: false "
                    "to use zero/negative weights verbatim")
            ws = [w / total for w in ws]
        self.weights = ws

    def __call__(self, **kwargs) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        total_loss = 0.0
        tagged: Dict[str, torch.Tensor] = {}
        for loss_fn, mapping, tag, weight in zip(self.losses, self.mappings, self.tags, self.weights):
            targeted = self._map_outputs(mapping, **kwargs)
            value = loss_fn(**targeted)
            total_loss = total_loss + value * weight
            if tag is not None:
                tagged[tag] = value
        return torch.as_tensor(total_loss), tagged

    def __getitem__(self, tag: str) -> Callable:
        if tag in self.tag2loss:
            return self.tag2loss[tag]
        raise KeyError(
            f"Cannot access loss {tag}. You should tag your losses for direct access with a tag key"
        )

    @staticmethod
    def _map_outputs(mapping: Dict[str, str], **model_outputs) -> Dict[str, Any]:
        targeted = {}
        for target_arg, source_arg in mapping.items():
            if source_arg not in model_outputs:
                raise ValueError(
                    f"Cannot find {source_arg} for your mapping {target_arg} : {source_arg}. "
                    f"You should either add {source_arg} output to your model or remove the "
                    f"mapping from configuration"
                )
            targeted[target_arg] = model_outputs[source_arg]
        return targeted
