"""Replay of an exported model through the standard engine (port of
``torchok_tpu.tasks.stablehlo_task``; reference: torchok/tasks/onnx.py:16-131,
the ONNXTask that runs an exported model over the same datasets and
metrics).

``StableHLOTask`` loads an artifact of :mod:`torchok_tpu_torch.export.
stablehlo` and runs test and predict on it; ``ONNXTask`` takes the
reference's surface for the same (``path_to_onnx``, ``providers``,
``keys_mapping_onnx2dataset``). The step's outputs are ``prediction`` and
``embeddings`` (both the program's output) and ``target``."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor import TASKS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.export.stablehlo import StableHLOModel
from torchok_tpu_torch.tasks.base import BaseTask


class _ExportedModule(nn.Module):
    """The artifact behind the task-model interface. It holds no parameters
    of its own: the program keeps its weights, on the device it was
    exported from."""

    def __init__(self, runner: StableHLOModel, image_key: str = "image"):
        super().__init__()
        self.runner = runner
        self.image_key = image_key

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        prediction = self.runner(batch[self.image_key])
        output = {"prediction": prediction, "embeddings": prediction}
        if batch.get("target") is not None:
            output["target"] = batch["target"]
        return output


@TASKS.register_class
class StableHLOTask(BaseTask):
    def __init__(self, hparams: ConfigNode, model_path: str,
                 inputs: Optional[list] = None, image_key: str = "image", **kwargs):
        super().__init__(hparams, **kwargs)
        self.runner = StableHLOModel(model_path)
        self.model = _ExportedModule(self.runner, image_key)

    def init_weights(self, generator: torch.Generator) -> None:
        """Nothing to draw: the artifact holds its weights."""


@TASKS.register_class(name="ONNXTask")
class ONNXTask(StableHLOTask):
    """The reference ONNXTask's surface over the port's artifacts:
    ``path_to_onnx`` (or ``model_path``) names the artifact directory,
    ``providers`` is ignored (the program runs where it was exported),
    and the dataset-side name of ``keys_mapping_onnx2dataset`` is the input's
    key in the batch."""

    def __init__(self, hparams: ConfigNode, path_to_onnx: Optional[str] = None,
                 model_path: Optional[str] = None, providers=None,
                 keys_mapping_onnx2dataset: Optional[Dict[str, str]] = None, **kwargs):
        path = model_path or path_to_onnx
        if path is None:
            raise ValueError("ONNXTask requires path_to_onnx (or model_path)")
        mapping = keys_mapping_onnx2dataset
        if hasattr(mapping, "to_dict"):
            mapping = mapping.to_dict()
        self.keys_mapping = dict(mapping or {})
        # the dataset-side name of the (single) model input, reference onnx.py:52
        image_key = next(iter(self.keys_mapping.values()), "image")
        super().__init__(hparams, model_path=path, image_key=image_key, **kwargs)
