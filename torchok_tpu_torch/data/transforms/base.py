"""Transform engine (reference: torchok/constructor/constructor.py:325-358,
torchok/data/transforms/__init__.py:24-116; port of
``torchok_tpu.data.transforms.base``).

* every transform keeps the Albumentations calling convention
  ``t(image=..., mask=...) -> dict`` for the host path (numpy, HWC);
* device-capable transforms also implement ``apply_batch`` over a batch of
  torch tensors on the trainer's device, with randomness from a
  ``torch.Generator``;
* ``Compose.split_device_suffix`` peels the maximal suffix of device-capable
  ops, which the engine then runs batched on the device after collation;
* host randomness comes from the generator that :func:`sample_generator`
  sets for one sample's pass through the host pipeline (the dataset makes it
  from its seed and the sample's index), so what a sample draws does not
  depend on which loader thread runs it. Outside such a pass each thread
  draws from an unseeded generator of its own.
"""
from __future__ import annotations

import contextlib
import threading as _threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchok_tpu_torch.constructor import TRANSFORMS

# the generator of the sample the current thread is transforming, if any
_SAMPLE = _threading.local()


@contextlib.contextmanager
def sample_generator(rng: np.random.Generator) -> Iterator[None]:
    """Every host transform that runs in this thread inside the block draws
    from ``rng``: one generator for one sample's whole host pipeline."""
    _SAMPLE.rng = rng
    try:
        yield
    finally:
        _SAMPLE.rng = None


class BaseTransform:
    """Albumentations-compatible single transform."""

    # True when apply_batch (torch, batched, on the device) is implemented
    device_capable: bool = False
    # True for device ops that require all samples to share the input shape
    device_needs_uniform: bool = False
    # True when the op is deterministic (p is ignored / always applied)
    always_apply: bool = False

    def __init__(self, always_apply: bool = False, p: float = 0.5):
        self.p = 1.0 if (always_apply or self.always_apply) else float(p)
        self._local = _threading.local()

    @property
    def rng(self) -> np.random.Generator:
        """The current sample's generator (:func:`sample_generator`), else a
        per-thread unseeded one: loader threads run transforms concurrently
        and a numpy Generator is not thread-safe."""
        r = getattr(_SAMPLE, "rng", None)
        if r is not None:
            return r
        r = getattr(self._local, "rng", None)
        if r is None:
            r = self._local.rng = np.random.default_rng()
        return r

    # ------------------------------ host path ------------------------------
    def __call__(self, force_apply: bool = False, **sample) -> Dict[str, Any]:
        if force_apply or self.p >= 1.0 or self.rng.random() < self.p:
            params = self.get_params(sample)
            out = dict(sample)
            if "image" in sample:
                out["image"] = self.apply(sample["image"], **params)
            if sample.get("mask") is not None:
                out["mask"] = self.apply_to_mask(sample["mask"], **params)
            return out
        return dict(sample)

    def get_params(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        return {}

    def apply(self, image: np.ndarray, **params) -> np.ndarray:
        raise NotImplementedError

    def apply_to_mask(self, mask: np.ndarray, **params) -> np.ndarray:
        return mask

    # ----------------------------- device path -----------------------------
    def apply_batch(self, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Batched application on the device; only for device_capable
        transforms. ``batch['image']`` is NHWC until ToTensorV2 makes it
        NCHW."""
        raise NotImplementedError


@TRANSFORMS.register_class
class Compose(BaseTransform):
    always_apply = True

    def __init__(self, transforms: Sequence[BaseTransform], p: float = 1.0, **_ignored):
        super().__init__(p=p)
        self.transforms = list(transforms)

    @property
    def device_capable(self):
        return bool(self.transforms) and all(t.device_capable for t in self.transforms)

    @property
    def device_needs_uniform(self):
        return any(t.device_needs_uniform for t in self.transforms)

    def apply_batch(self, batch, generator):
        for t in self.transforms:
            batch = t.apply_batch(batch, generator)
        return batch

    def __call__(self, force_apply: bool = False, **sample) -> Dict[str, Any]:
        for t in self.transforms:
            sample = t(**sample)
        return sample

    def split_device_suffix(self, uniform_shapes: bool = False
                            ) -> Tuple["Compose", List[BaseTransform]]:
        """Split into (host prefix, device-capable suffix); ops that need
        uniform shapes move to the device only for uniform-size datasets."""
        def ok(t):
            return t.device_capable and (uniform_shapes or not t.device_needs_uniform)
        split = len(self.transforms)
        while split > 0 and ok(self.transforms[split - 1]):
            split -= 1
        return Compose(self.transforms[:split], p=1.0), self.transforms[split:]


@TRANSFORMS.register_class
class Sequential(Compose):
    pass


@TRANSFORMS.register_class
class NoOp(BaseTransform):
    always_apply = True
    device_capable = True

    def apply(self, image, **params):
        return image

    def apply_batch(self, batch, generator):
        return batch
