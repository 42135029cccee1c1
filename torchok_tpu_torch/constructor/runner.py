"""create_trainer (reference: torchok/constructor/runner.py:7-19)."""
from __future__ import annotations

from typing import List, Optional

from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.engine.trainer import Trainer


def create_trainer(train_config: ConfigNode,
                   callbacks: Optional[List[Callback]] = None) -> Trainer:
    """Build the trainer of a config. ``callbacks`` are instances the caller
    hands over (the CLI's epoch printer); the config's own ``logger:`` and
    ``callbacks:`` sections wait for their modules to be ported."""
    if train_config.get("logger"):
        raise NotImplementedError("logger: loggers are not ported yet")
    if train_config.get("callbacks"):
        names = [cb.name for cb in train_config.get("callbacks")]
        raise NotImplementedError(f"callbacks: {names} are not ported yet")

    seed = 0
    seed_params = train_config.get("seed_params")
    if seed_params and seed_params.get("seed") is not None:
        seed = int(seed_params.seed)
    return Trainer(train_config.trainer, callbacks=list(callbacks or []), seed=seed)
