"""ImageDataset ABC (reference: torchok/data/datasets/base.py:16-170; port of
``torchok_tpu.data.datasets.base``).

The combined augment+transform chain is cut at the maximal device-capable
suffix: the host prefix (decode, geometry) runs per sample in loader
threads, the suffix (Normalize, ToTensorV2, ...) runs batched on the
trainer's device after collation. ``__getitem__`` therefore returns
host-stage numpy samples.

``seed`` (the loader calls it each epoch, ``torchok_tpu/data/datasets/
base.py:89``) seeds the host prefix: each sample's pass draws from one
generator made from ``SeedSequence([seed, index])``, so a sample's draws
depend on the loader's seed, the epoch and its index, and not on which
loader thread runs it or when. ``torchok_tpu`` mixes the thread id into
its per-thread streams instead, which no two runs share.

Decoding image files (and with it OpenCV and Pillow, which the port will
import only inside the decoding functions) comes with the file-backed
datasets; the in-memory datasets here need neither.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Union

import numpy as np

from torchok_tpu_torch.data.transforms import Compose, DeviceTransformPipeline
from torchok_tpu_torch.data.transforms.base import BaseTransform, sample_generator

_DTYPES = {
    "float32": np.float32,
    "float16": np.float16,
    "bfloat16": np.float32,  # collated on host as f32; autocast runs bf16
    "float64": np.float64,
    "uint8": np.uint8,
    "long": np.int64,
    "int64": np.int64,
    "int32": np.int32,
}


def resolve_np_dtype(name: str) -> np.dtype:
    return np.dtype(_DTYPES.get(name, name))


class ImageDataset(ABC):
    # fixed-size in-memory images: shape-bound device ops may run batched
    uniform_image_size = False

    def __init__(
            self,
            transform: Optional[Union[BaseTransform, Compose, list]],
            augment: Optional[Union[BaseTransform, Compose, list]] = None,
            input_dtype: str = "float32",
            test_mode: bool = False,
    ):
        self.test_mode = test_mode
        self.input_dtype = input_dtype
        self._host_seed: Optional[int] = None  # None: unseeded until seed()
        self.transform = self._ensure_compose(transform)
        self.augment = self._ensure_compose(augment)

        combined = []
        for part in (self.augment, self.transform):
            if part is not None:
                combined.extend(part.transforms)
        self._host_pipeline, device_suffix = Compose(combined, p=1.0).split_device_suffix(
            uniform_shapes=self.uniform_image_size)
        self.device_pipeline = DeviceTransformPipeline(device_suffix)

    @property
    def host_pipeline_empty(self) -> bool:
        return not self._host_pipeline.transforms

    @staticmethod
    def _ensure_compose(t) -> Optional[Compose]:
        if t is None or isinstance(t, Compose):
            return t
        if isinstance(t, (list, tuple)):
            return Compose(list(t), p=1.0)
        return Compose([t], p=1.0)

    def seed(self, seed: int) -> None:
        """Seed the host transforms' draws from now on (per epoch)."""
        self._host_seed = int(seed) & 0x7FFFFFFFFFFFFFFF

    def apply_host_pipeline(self, sample: dict, index: int) -> dict:
        """Run the host prefix on one sample; ``index`` (the sample's index
        in the dataset) picks its generator once the dataset is seeded."""
        if self._host_seed is None:
            sample = self._host_pipeline(**sample)
        else:
            rng = np.random.default_rng(np.random.SeedSequence([self._host_seed, int(index)]))
            with sample_generator(rng):
                sample = self._host_pipeline(**sample)
        # with a device suffix the image stays uint8 on the host (4x cheaper
        # host->device copy) and the device pipeline makes it float; when the
        # whole pipeline ran here, cast like the reference ImageDataset does
        if not self.device_pipeline and sample.get("image") is not None:
            sample["image"] = np.asarray(sample["image"]).astype(
                resolve_np_dtype(self.input_dtype))
        return sample

    # ------------------------------ contract -------------------------------
    @abstractmethod
    def __len__(self) -> int:
        ...

    @abstractmethod
    def __getitem__(self, idx: int) -> dict:
        ...
