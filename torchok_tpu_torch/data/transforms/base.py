"""Transform engine (reference: torchok/constructor/constructor.py:325-358,
torchok/data/transforms/__init__.py:24-116; port of
``torchok_tpu.data.transforms.base``).

* every transform keeps the Albumentations calling convention
  ``t(image=..., mask=...) -> dict`` for the host path (numpy, HWC);
* device-capable transforms also implement ``apply_batch`` over a batch of
  torch tensors on the trainer's device, with randomness from a
  ``torch.Generator``;
* ``Compose.split_device_suffix`` peels the maximal suffix of device-capable
  ops, which the engine then runs batched on the device after collation; in
  ``bbox_mode`` (detection) an op that moves pixels (``device_bbox_safe``
  False, or geometric with no box handler) stays on the host, where
  ``apply_to_bboxes`` moves the sample's pixel xyxy ``bboxes`` with it;
* a geometric op without ``apply_to_bboxes`` raises on a sample that
  carries boxes: passing them through unchanged would misalign them;
* host randomness comes from the generator that :func:`sample_generator`
  sets for one sample's pass through the host pipeline (the dataset makes it
  from its seed and the sample's index), so what a sample draws does not
  depend on which loader thread runs it. Outside such a pass each thread
  draws from a generator of its own, made from the transform's ``seed``
  when it has one;
* ``OneOf`` picks one child per sample (by the children's ``p``) and forces
  it; ``SomeOf`` applies ``n`` children, each with its own ``p``. On the
  device every child runs on the whole batch and each sample keeps its
  pick, so a selecting container moves to the device only when every child
  keeps the batch's shape and dtype.
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
    # False for device ops that move pixels (flips, crops, resizes): their
    # apply_batch does not move boxes, so they stay on the host for datasets
    # with bboxes
    device_bbox_safe: bool = True
    # False for device ops that change the image dtype (Normalize, ToTensorV2):
    # OneOf/SomeOf select per sample between their children's outputs, so
    # such a container stays on the host
    device_preserves_dtype: bool = True
    # True when the op is deterministic (p is ignored / always applied)
    always_apply: bool = False
    # True for ops that change the image geometry: they must override
    # apply_to_bboxes to take a sample that carries boxes
    geometric: bool = False

    def __init__(self, always_apply: bool = False, p: float = 0.5):
        self.p = 1.0 if (always_apply or self.always_apply) else p
        self._seed: Optional[int] = None
        self._local = _threading.local()

    @property
    def p(self) -> float:
        """The probability to apply; 1 while a selecting container forces
        this transform in the current thread (:func:`forced_batch`)."""
        if getattr(self._local, "forced", 0):
            return 1.0
        return self.p_base

    @p.setter
    def p(self, value: float) -> None:
        self.p_base = float(value)

    def seed(self, seed: int) -> None:
        """Seed the generator this transform draws from outside a sample's
        pass (each thread's from ``seed``)."""
        self._seed = int(seed)
        self._local = _threading.local()

    def __getstate__(self) -> Dict[str, Any]:
        # a worker process gets its own per-thread generators
        return {k: v for k, v in self.__dict__.items() if k != "_local"}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._local = _threading.local()

    @property
    def rng(self) -> np.random.Generator:
        """The current sample's generator (:func:`sample_generator`), else a
        per-thread one (from :meth:`seed`, if given): loader threads run
        transforms concurrently and a numpy Generator is not thread-safe."""
        r = getattr(_SAMPLE, "rng", None)
        if r is not None:
            return r
        r = getattr(self._local, "rng", None)
        if r is None:
            r = self._local.rng = np.random.default_rng(self._seed)
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
            if sample.get("bboxes") is not None:
                if self.geometric and not self.handles_bboxes:
                    raise NotImplementedError(
                        f"{type(self).__name__} changes image geometry but has no bbox "
                        "handler; it cannot be used in a pipeline that carries bboxes "
                        "(detection datasets)")
                out["bboxes"] = self.apply_to_bboxes(sample["bboxes"], sample["image"].shape,
                                                     **params)
            return out
        return dict(sample)

    @property
    def handles_bboxes(self) -> bool:
        return type(self).apply_to_bboxes is not BaseTransform.apply_to_bboxes

    def get_params(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        return {}

    def apply(self, image: np.ndarray, **params) -> np.ndarray:
        raise NotImplementedError

    def apply_to_mask(self, mask: np.ndarray, **params) -> np.ndarray:
        return mask

    def apply_to_bboxes(self, bboxes: np.ndarray, image_shape, **params) -> np.ndarray:
        """Pixel xyxy boxes (N, 4) of an image of ``image_shape`` (HWC) as
        they lie after the op; a non-geometric op leaves them."""
        return bboxes

    # ----------------------------- device path -----------------------------
    def apply_batch(self, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Batched application on the device; only for device_capable
        transforms. ``batch['image']`` is NHWC until ToTensorV2 makes it
        NCHW."""
        raise NotImplementedError


def _children_device_capable(transforms, allow_needs_uniform: bool,
                             require_dtype_preserving: bool = False) -> bool:
    return bool(transforms) and all(
        t.device_capable and (allow_needs_uniform or not t.device_needs_uniform)
        and (t.device_preserves_dtype or not require_dtype_preserving) for t in transforms)


def _children_device_bbox_safe(transforms) -> bool:
    return all(t.device_bbox_safe and not (t.geometric and not t.handles_bboxes)
               for t in transforms)


def forced_batch(t: BaseTransform, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """``t.apply_batch`` with its ``p`` read as 1 in this thread: the device
    form of the host's ``force_apply=True`` on a ``OneOf``'s pick, without
    changing ``t.p`` for other threads."""
    local = t._local
    local.forced = getattr(local, "forced", 0) + 1
    try:
        return t.apply_batch(batch, generator)
    finally:
        local.forced -= 1


def select_batch(base: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor],
                 keep: torch.Tensor, keys=("image", "mask")) -> Dict[str, torch.Tensor]:
    """``out`` where ``keep`` (N,) is true, ``base`` elsewhere, per sample;
    a child of a selecting container must keep shape and dtype."""
    merged = dict(base)
    for k in keys:
        if base.get(k) is None:
            continue
        a, b = base[k], out[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise TypeError(f"device OneOf/SomeOf children must keep the batch's shape and "
                            f"dtype; {k!r} changed {tuple(a.shape)}/{a.dtype} -> "
                            f"{tuple(b.shape)}/{b.dtype}: keep this composition on the host")
        merged[k] = torch.where(keep.to(a.device).view((-1,) + (1,) * (a.ndim - 1)), b, a)
    return merged


def draw_device(generator: Optional[torch.Generator], fallback: torch.device) -> torch.device:
    """Where a device transform draws: on its generator's device, else on
    the batch's."""
    return generator.device if generator is not None else fallback


@TRANSFORMS.register_class
class Compose(BaseTransform):
    always_apply = True

    def __init__(self, transforms: Sequence[BaseTransform], p: float = 1.0, **_ignored):
        super().__init__(p=p)
        self.transforms = list(transforms)

    @property
    def device_capable(self):
        return _children_device_capable(self.transforms, allow_needs_uniform=True)

    @property
    def device_needs_uniform(self):
        return any(t.device_needs_uniform for t in self.transforms)

    @property
    def device_bbox_safe(self):
        return _children_device_bbox_safe(self.transforms)

    @property
    def device_preserves_dtype(self):
        return all(t.device_preserves_dtype for t in self.transforms)

    def seed(self, seed: int) -> None:
        super().seed(seed)
        for i, t in enumerate(self.transforms):
            t.seed(seed * 1_000_003 + i)

    def apply_batch(self, batch, generator):
        for t in self.transforms:
            batch = t.apply_batch(batch, generator)
        return batch

    def __call__(self, force_apply: bool = False, **sample) -> Dict[str, Any]:
        for t in self.transforms:
            sample = t(**sample)
        return sample

    def split_device_suffix(self, bbox_mode: bool = False, uniform_shapes: bool = False
                            ) -> Tuple["Compose", List[BaseTransform]]:
        """Split into (host prefix, device-capable suffix); ops that need
        uniform shapes move to the device only for uniform-size datasets,
        and in ``bbox_mode`` only ops that leave the geometry alone move."""
        def ok(t):
            # a geometric op with no box handler stays on the host whatever
            # its flag: there it raises, on the device it would warp pixels
            # under boxes left where they were
            return (t.device_capable and (not bbox_mode or _children_device_bbox_safe([t]))
                    and (uniform_shapes or not t.device_needs_uniform))
        split = len(self.transforms)
        while split > 0 and ok(self.transforms[split - 1]):
            split -= 1
        return Compose(self.transforms[:split], p=1.0), self.transforms[split:]


@TRANSFORMS.register_class
class OneOf(BaseTransform):
    """One child per sample, picked by the children's ``p`` (normalised) and
    forced, with probability ``p``."""

    def __init__(self, transforms: Sequence[BaseTransform], p: float = 0.5, **_ignored):
        super().__init__(p=p)
        self.transforms = list(transforms)
        probs = np.array([t.p for t in self.transforms], dtype=np.float64)
        self.probs = probs / probs.sum() if probs.sum() > 0 else None

    def seed(self, seed: int) -> None:
        super().seed(seed)
        for i, t in enumerate(self.transforms):
            t.seed(seed * 999_983 + i)

    def __call__(self, force_apply: bool = False, **sample) -> Dict[str, Any]:
        if self.transforms and (force_apply or self.rng.random() < self.p):
            idx = self.rng.choice(len(self.transforms), p=self.probs)
            return self.transforms[idx](force_apply=True, **sample)
        return dict(sample)

    # on the device every child runs forced on the whole batch and each
    # sample keeps its pick's output: children that need one input shape or
    # change the dtype keep the container on the host
    @property
    def device_capable(self):
        return _children_device_capable(self.transforms, allow_needs_uniform=False,
                                        require_dtype_preserving=True)

    @property
    def device_bbox_safe(self):
        return _children_device_bbox_safe(self.transforms)

    @property
    def device_preserves_dtype(self):
        return all(t.device_preserves_dtype for t in self.transforms)

    def draw_batch(self, n: int, generator: Optional[torch.Generator], device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-sample gate and pick: a uniform against ``p``, and a uniform
        through the children's cumulative ``probs`` (numpy's ``choice``)."""
        device = draw_device(generator, device)
        gate = torch.rand((n,), generator=generator, device=device) < self.p
        u = torch.rand((n,), generator=generator, device=device)
        k = len(self.transforms)
        cdf = torch.arange(1, k + 1, dtype=torch.float64, device=device) / k \
            if self.probs is None else torch.as_tensor(np.cumsum(self.probs), device=device)
        choice = torch.searchsorted(cdf / cdf[-1], u.double(), right=True).clamp_max(k - 1)
        return gate, choice

    def apply_batch(self, batch, generator):
        gate, choice = self.draw_batch(batch["image"].shape[0], generator,
                                       batch["image"].device)
        out = dict(batch)
        for i, t in enumerate(self.transforms):
            out = select_batch(out, forced_batch(t, dict(batch), generator),
                               gate & (choice == i))
        return out


@TRANSFORMS.register_class
class SomeOf(BaseTransform):
    """``n`` children drawn per sample (with ``replace``), each applied with
    its own ``p``, with probability ``p``. On the device only ``n`` 1: one
    child a sample, picked uniformly."""

    def __init__(self, transforms: Sequence[BaseTransform], n: int = 1, replace: bool = True,
                 p: float = 1.0, **_ignored):
        super().__init__(p=p)
        self.transforms = list(transforms)
        self.n = n
        self.replace = replace

    def seed(self, seed: int) -> None:
        super().seed(seed)
        for i, t in enumerate(self.transforms):
            t.seed(seed * 999_979 + i)

    def __call__(self, force_apply: bool = False, **sample) -> Dict[str, Any]:
        if self.rng.random() < self.p:
            idxs = self.rng.choice(len(self.transforms), size=self.n, replace=self.replace)
            for i in idxs:
                sample = self.transforms[int(i)](**sample)
        return dict(sample)

    @property
    def device_capable(self):
        return self.n == 1 and _children_device_capable(
            self.transforms, allow_needs_uniform=False, require_dtype_preserving=True)

    @property
    def device_bbox_safe(self):
        return _children_device_bbox_safe(self.transforms)

    @property
    def device_preserves_dtype(self):
        return all(t.device_preserves_dtype for t in self.transforms)

    def draw_batch(self, n: int, generator: Optional[torch.Generator], device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        device = draw_device(generator, device)
        gate = torch.rand((n,), generator=generator, device=device) < self.p
        choice = torch.randint(0, len(self.transforms), (n,), generator=generator,
                               device=device)
        return gate, choice

    def apply_batch(self, batch, generator):
        gate, choice = self.draw_batch(batch["image"].shape[0], generator,
                                       batch["image"].device)
        out = dict(batch)
        for i, t in enumerate(self.transforms):
            out = select_batch(out, t.apply_batch(dict(batch), generator),
                               gate & (choice == i))
        return out


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
