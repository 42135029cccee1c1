"""Metric base: explicit accumulator states (reference:
torchok/metrics/metrics_manager.py:11-76, the torchmetrics contract).

A metric owns no tensors; its state is a dict of tensors on the trainer's
device, updated by ``update`` without leaving the device and read out on the
host by ``compute``.
"""
from __future__ import annotations

from typing import Any, Dict, Union


class Metric:
    """Base metric. Subclasses define ``empty_state``, ``update``, ``compute``."""

    def __init__(self, **params):
        self.params = params

    def empty_state(self, device) -> Dict[str, Any]:
        raise NotImplementedError

    def update(self, state: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def compute(self, state: Dict[str, Any]) -> Union[float, Dict[str, float]]:
        raise NotImplementedError
