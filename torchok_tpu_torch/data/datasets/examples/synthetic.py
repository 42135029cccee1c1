"""Synthetic classification dataset for benchmarks and offline smoke runs
(port of ``torchok_tpu.data.datasets.examples.synthetic``). The images come
from ``numpy.random.default_rng(seed)`` exactly as in ``torchok_tpu``, so both
packages see the same pixels and labels for the same seed."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.base import ImageDataset


@DATASETS.register_class
class SyntheticClassificationDataset(ImageDataset):
    uniform_image_size = True  # fixed-size in-memory arrays: vectorized batch fetch

    def __init__(self, transform, augment=None, num_samples: int = 10000,
                 image_size: Tuple[int, int] = (32, 32), channels: int = 3,
                 num_classes: int = 10, input_dtype: str = "float32",
                 test_mode: bool = False, seed: int = 0, **kwargs):
        super().__init__(transform=transform, augment=augment,
                         input_dtype=input_dtype, test_mode=test_mode)
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, size=(num_samples, *image_size, channels),
                                   dtype=np.uint8)
        self.targets = rng.integers(0, num_classes, size=(num_samples,)).astype(np.int64)

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, idxs: np.ndarray) -> dict:
        """Vectorized batch fetch (numpy fancy-index, no per-sample Python).
        Used by the loader when the host transform prefix is empty."""
        out = {"image": self.images[idxs], "index": idxs.astype("int64")}
        if not self.test_mode:
            out["target"] = self.targets[idxs]
        return out

    def __getitem__(self, idx: int) -> dict:
        sample = self.apply_host_pipeline({"image": self.images[idx]})
        out = {"image": sample["image"], "index": idx}
        if not self.test_mode:
            out["target"] = self.targets[idx]
        return out
