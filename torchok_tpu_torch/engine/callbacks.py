"""Callback protocol for the engine (Lightning-callback equivalent surface,
reference: torchok/callbacks/__init__.py:11-23). Only the hooks the
evaluation loop calls exist so far."""
from __future__ import annotations

from typing import Dict


class Callback:
    def on_test_end(self, trainer, task, logs: Dict[str, float]) -> None: ...
