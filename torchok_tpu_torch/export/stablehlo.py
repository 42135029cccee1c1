"""Export of a task's inference forward, and its replay (port of
``torchok_tpu.export.stablehlo``; reference: torchok/callbacks/
checkpoint_onnx.py, torchok/tasks/onnx.py).

The JAX package serialises its jitted inference function with
``jax.export``; the port traces the model's ``forward_image`` with
``torch.export`` and saves the program with its weights. The artifact keeps
the JAX package's directory name and ``meta.json``:

  ``<checkpoint>.stablehlo/``
    ``model.pt2``  -- ``torch.export.save`` of the program, its parameters
                      and BatchNorm statistics inside (ArcFace's step
                      counter, the JAX package's ``buffers`` collection, is
                      left out: inference never reads it)
    ``meta.json``  -- ``input_shape`` (CHW), ``input_dtype``,
                      ``batch_polymorphic``

The batch dimension is dynamic, over the range ``torch.export`` infers from
2 up: it specialises sizes 0 and 1 (a traced batch is guarded to 2 or
more), and a CUDA op may bound it above (PyTorch 2.11 bounds HRNet's at
65535), so :class:`StableHLOModel` runs a single image as a batch of two
copies and keeps the first output; the eval forward treats each image on
its own. Export raises where the trace specialised the batch to a size.
``.pt2`` and the JAX package's ``.shlo``
artifacts are not interchangeable. A model whose eval forward launches a
hand-written kernel (they are bound through ``ctypes``, which
``torch.export`` cannot trace) raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import torch
from torch import nn

from torchok_tpu_torch.ops.common import refusing_kernels

# torch.export specialises sizes 0 and 1: the example batch has 2 images,
# and so has the smallest batch the program takes
EXAMPLE_BATCH = 2


class _ImageForward(nn.Module):
    """The module export traces: the task model's ``forward_image`` under
    the task's autocast dtype (none in f32)."""

    def __init__(self, model: nn.Module, dtype: Optional[torch.dtype]):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, image: torch.Tensor) -> Any:
        with torch.autocast(image.device.type, dtype=self.dtype, enabled=self.dtype is not None):
            return self.model.forward_image(image)


def _arcface_heads(model: nn.Module):
    """The ArcFace heads of ``model``: their ``step`` counter is the JAX
    package's ``buffers`` collection, which export leaves out."""
    from torchok_tpu_torch.models.heads.classification.arcface_head import ArcFaceHead
    return [m for m in model.modules() if isinstance(m, ArcFaceHead)]


def export_task_model(task, path: str, batch_size: Optional[int] = None,
                      remove_head: bool = False) -> str:
    """Export ``task``'s inference forward to the directory ``path``.

    ``batch_size`` sets the example batch (at least 2; the artifact takes
    any batch size). ``remove_head`` is accepted as the JAX package accepts
    it, and changes nothing there either: the head stays in the program."""
    del remove_head
    module = task.as_module()
    if not hasattr(module, "forward_image"):
        raise NotImplementedError(f"{type(task).__name__} has no image forward to export")
    if not task.input_shapes:
        raise ValueError("Task config has no `inputs` spec; cannot export")
    shape = tuple(task.input_shapes[0])
    device = next(module.parameters()).device
    example = torch.zeros((max(batch_size or EXAMPLE_BATCH, EXAMPLE_BATCH), *shape),
                          dtype=torch.float32, device=device)
    modes = [(m, m.training) for m in module.modules()]
    heads = _arcface_heads(module)
    steps = [head._buffers.pop("step") for head in heads]  # inference never reads them
    module.eval()
    try:
        with refusing_kernels():
            program = torch.export.export(_ImageForward(module, task.compute_dtype), (example,),
                                          dynamic_shapes=({0: torch.export.Dim.AUTO},),
                                          strict=False)
    finally:
        for head, step in zip(heads, steps):
            head._buffers["step"] = step
        for m, training in modes:
            m.training = training
    name = program.graph_signature.user_inputs[0]
    traced = next(n for n in program.graph.nodes if n.name == name).meta["val"]
    if isinstance(traced.shape[0], int):
        raise RuntimeError(f"torch.export specialised the batch dimension to {traced.shape[0]}")
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out / "model.pt2"))
    meta = {"input_shape": list(shape), "input_dtype": "float32", "batch_polymorphic": True}
    (out / "meta.json").write_text(json.dumps(meta))
    return str(out)


class StableHLOModel:
    """A loaded artifact: call it on an image batch on the device it was
    exported from (its weights are there)."""

    def __init__(self, path: str):
        p = Path(path)
        if p.is_file():
            if p.suffix.lower() == ".onnx":
                raise ValueError(
                    f"{path} is a real ONNX file. This framework's ONNXTask replays the "
                    "artifacts it exports itself (onnxruntime is not part of the runtime). "
                    "Re-export the trained task with CheckpointStableHLO (callbacks) or "
                    "torchok_tpu_torch.export.stablehlo.export_task_model, then pass that "
                    "artifact directory as path_to_onnx.")
            raise ValueError(
                f"{path} is a file; expected an artifact directory containing model.pt2 + "
                "meta.json (written by CheckpointStableHLO/export_task_model).")
        if not (p / "model.pt2").exists():
            raise ValueError(
                f"{path} is not an artifact directory (model.pt2 missing). Export one with "
                "CheckpointStableHLO or export.stablehlo.export_task_model.")
        self.program = torch.export.load(str(p / "model.pt2"))
        self.meta = json.loads((p / "meta.json").read_text())
        self._module = self.program.module()

    def __call__(self, image: torch.Tensor) -> Any:
        with torch.no_grad():
            if image.shape[0] >= EXAMPLE_BATCH:
                return self._module(image)
            out = self._module(torch.cat([image] * EXAMPLE_BATCH))
            return torch.utils._pytree.tree_map(lambda t: t[:1], out)
