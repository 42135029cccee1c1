"""Transform registry + device pipeline assembly."""
from typing import Dict, List, Optional

import torch

from torchok_tpu_torch.data.transforms.base import (  # noqa: F401
    BaseTransform, Compose, NoOp, Sequential,
)
import torchok_tpu_torch.data.transforms.pixelwise  # noqa: F401
import torchok_tpu_torch.data.transforms.spatial  # noqa: F401


class DeviceTransformPipeline:
    """Batched application of the device-capable transform suffix."""

    def __init__(self, transforms: List[BaseTransform]):
        self.transforms = list(transforms)

    def __bool__(self) -> bool:
        return bool(self.transforms)

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        for t in self.transforms:
            batch = t.apply_batch(batch, generator)
        return batch
