"""Checkpoint + export callbacks (port of
``torchok_tpu.callbacks.checkpoint_stablehlo``; reference:
torchok/callbacks/checkpoint_onnx.py:15-83): a ModelCheckpoint that also
exports each checkpoint it writes as an inference artifact beside it
(``<checkpoint>.stablehlo``, :mod:`torchok_tpu_torch.export.stablehlo`);
a second checkpoint of the same step gets a copy of the first's.
Registered under the reference's names too, so its recipes run."""
from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import Tuple

from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint
from torchok_tpu_torch.constructor import CALLBACKS

logger = logging.getLogger(__name__)


@CALLBACKS.register_class
class CheckpointStableHLO(ModelCheckpoint):
    """``onnx_params`` is dropped and ``remove_head`` passed on, as the JAX
    package does. An export that fails is logged as a warning and the fit
    goes on, as there."""

    def __init__(self, *args, remove_head: bool = False, **kwargs):
        kwargs.pop("onnx_params", None)  # the reference's surface
        super().__init__(*args, **kwargs)
        self.remove_head = remove_head
        self._exported: Tuple[int, str] = (-1, "")  # (global step, artifact) of the last export

    def on_checkpoint_saved(self, trainer, task, path: str) -> None:
        from torchok_tpu_torch.export.stablehlo import export_task_model
        export_path = str(Path(path).with_suffix(".stablehlo"))
        step, previous = self._exported
        try:
            if step == trainer.global_step and Path(previous).is_dir():
                # a second checkpoint of the same step (last.ckpt beside the
                # epoch's) holds the same weights: its artifact is a copy
                shutil.rmtree(export_path, ignore_errors=True)
                shutil.copytree(previous, export_path)
            else:
                export_task_model(task, export_path, remove_head=self.remove_head)
            self._exported = (trainer.global_step, export_path)
            logger.info("Exported an inference artifact to %s", export_path)
        except Exception as e:  # noqa: BLE001 — an export failure must not end the fit
            logger.warning("Export failed for %s: %s", path, e)


@CALLBACKS.register_class(name="CheckpointONNX")
class CheckpointONNX(CheckpointStableHLO):
    """The reference's name: the port exports ``torch.export`` programs, not ONNX."""


@CALLBACKS.register_class(name="ModelCheckpointWithOnnx")
class ModelCheckpointWithOnnx(CheckpointStableHLO):
    """The name the reference's SOP and sweet-pepper recipes use."""
