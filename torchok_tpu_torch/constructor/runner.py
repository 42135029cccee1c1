"""create_trainer (reference: torchok/constructor/runner.py:7-19)."""
from __future__ import annotations

from torchok_tpu_torch.constructor import CALLBACKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.engine.trainer import Trainer


def create_trainer(train_config: ConfigNode) -> Trainer:
    if train_config.get("logger"):
        raise NotImplementedError("logger: loggers are not ported yet")
    callbacks = []
    for cb_cfg in train_config.get("callbacks") or []:
        params = cb_cfg.get("params") or {}
        if hasattr(params, "to_dict"):
            params = params.to_dict()
        callbacks.append(CALLBACKS.get(cb_cfg.name)(**params))

    seed = 0
    seed_params = train_config.get("seed_params")
    if seed_params and seed_params.get("seed") is not None:
        seed = int(seed_params.seed)
    return Trainer(train_config.trainer, callbacks=callbacks, seed=seed)
