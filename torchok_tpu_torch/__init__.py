"""torchok_tpu_torch — the PyTorch/CUDA port of ``torchok_tpu``.

Same YAML surface and registry names as ``torchok_tpu``, written in PyTorch
for an NVIDIA Hopper card, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels (``csrc/``). Importing the package needs torch and
numpy only: no JAX, and no pyyaml, OpenCV or Pillow.
"""
__version__ = "0.1.0"

# Importing submodules populates the registries.
from torchok_tpu_torch import constructor  # noqa: F401
from torchok_tpu_torch import losses  # noqa: F401
from torchok_tpu_torch import metrics  # noqa: F401
from torchok_tpu_torch import optim  # noqa: F401
from torchok_tpu_torch import models  # noqa: F401
from torchok_tpu_torch import data  # noqa: F401
from torchok_tpu_torch import tasks  # noqa: F401
from torchok_tpu_torch import callbacks  # noqa: F401
from torchok_tpu_torch.constructor import (  # noqa: F401
    BACKBONES, DATASETS, HEADS, LOSSES, METRICS, OPTIMIZERS, POOLINGS, SCHEDULERS, TASKS,
    TRANSFORMS,
)
