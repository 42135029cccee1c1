"""create_trainer (port of ``torchok_tpu.constructor.runner``; reference:
torchok/constructor/runner.py:7-19)."""
from __future__ import annotations

import logging
from typing import List, Optional

from torchok_tpu_torch.constructor import CALLBACKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.constructor.logger import create_logger
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.engine.trainer import Trainer

logger = logging.getLogger(__name__)


def create_trainer(train_config: ConfigNode,
                   callbacks: Optional[List[Callback]] = None) -> Trainer:
    """Build the trainer of a config: its logger, the callbacks of its
    ``callbacks:`` section and then ``callbacks``, instances the caller hands
    over (the CLI's epoch printer)."""
    from torchok_tpu_torch.callbacks.common import ModelSummary, TQDMProgressBar
    from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint

    tp = train_config.get("trainer") or {}
    barebones = bool(tp.get("barebones"))
    # barebones (Lightning's): no logger, no checkpointing, no progress bar
    # and no summary, for raw-throughput runs
    log_backend = None if barebones else create_logger(train_config.get("logger"))

    built = []
    for cb_cfg in train_config.get("callbacks") or []:
        params = cb_cfg.get("params") or {}
        if hasattr(params, "to_dict"):
            params = params.to_dict()
        built.append(CALLBACKS.get(cb_cfg.name)(**params))
    built.extend(callbacks or [])

    if barebones:
        stripped = [cb for cb in built
                    if isinstance(cb, (ModelCheckpoint, ModelSummary, TQDMProgressBar))]
        if stripped:
            logger.warning("trainer.barebones=true: dropping %s",
                           [type(cb).__name__ for cb in stripped])
            built = [cb for cb in built if cb not in stripped]
    else:
        has_ckpt = any(isinstance(cb, ModelCheckpoint) for cb in built)
        enable_ckpt = tp.get("enable_checkpointing")
        if enable_ckpt and not has_ckpt:
            # Lightning: enable_checkpointing=true with no ModelCheckpoint
            # installs the default one (the last epoch, under the logger dir)
            built.append(ModelCheckpoint())
        elif enable_ckpt is False and has_ckpt:
            raise ValueError(
                "trainer.enable_checkpointing=false but a ModelCheckpoint callback is "
                "configured: remove one of the two (Lightning raises the same)")
        if tp.get("enable_model_summary") and \
                not any(isinstance(cb, ModelSummary) for cb in built):
            built.append(ModelSummary())

    seed = 0
    seed_params = train_config.get("seed_params")
    if seed_params and seed_params.get("seed") is not None:
        seed = int(seed_params.seed)
    return Trainer(train_config.trainer, logger_backend=log_backend, callbacks=built,
                   seed=seed)
