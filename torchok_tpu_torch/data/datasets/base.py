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
its per-thread streams instead, which no two runs share. A sample that runs
the prefix more than once (the views of a contrastive pair, the three
images of a triplet) gives view ``v`` the stream ``SeedSequence([seed,
index, v])``, so its views draw apart; a one-view sample keeps ``[seed,
index]``.

File-backed datasets read images through :meth:`ImageDataset._read_image`:
PNG and JPEG by :mod:`torchok_tpu_torch.native` (no OpenCV or Pillow), then
``_convert_image_format`` to the recipe's ``image_format`` with cv2's
colour conversions written out in numpy.

A dataset with ``has_bboxes`` (detection) keeps geometric transforms on the
host, where they move the boxes with the image: only ops that leave the
geometry alone join the device suffix.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Tuple, Union

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


def gray_from_rgb(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(RGB2GRAY) of a uint8 image: the BT.601 weights in 15-bit
    fixed point, rounded (equal to cv2 on all 2^24 colours)."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)


def _with_alpha(rgb: np.ndarray) -> np.ndarray:
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, rgb.dtype)], axis=-1)


class ImageDataset(ABC):
    # fixed-size in-memory images: shape-bound device ops may run batched
    uniform_image_size = False
    # samples carry boxes: geometric ops stay on the host (see the module doc)
    has_bboxes = False

    def __init__(
            self,
            transform: Optional[Union[BaseTransform, Compose, list]],
            augment: Optional[Union[BaseTransform, Compose, list]] = None,
            input_dtype: str = "float32",
            reader_library: str = "opencv",
            image_format: str = "rgb",
            rgba_layout_color: Union[int, Tuple[int, int, int]] = 0,
            test_mode: bool = False,
    ):
        self.test_mode = test_mode
        self.input_dtype = input_dtype
        self.reader_library = reader_library
        self.image_format = image_format
        self.rgba_layout_color = rgba_layout_color
        self._host_seed: Optional[int] = None  # None: unseeded until seed()
        self.transform = self._ensure_compose(transform)
        self.augment = self._ensure_compose(augment)

        combined = []
        for part in (self.augment, self.transform):
            if part is not None:
                combined.extend(part.transforms)
        self._host_pipeline, device_suffix = Compose(combined, p=1.0).split_device_suffix(
            bbox_mode=self.has_bboxes, uniform_shapes=self.uniform_image_size)
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

    def apply_host_pipeline(self, sample: dict, index: int, view: Optional[int] = None) -> dict:
        """Run the host prefix on one sample; ``index`` (the sample's index
        in the dataset) and, for one of several views of it, ``view`` pick
        its generator once the dataset is seeded."""
        if self._host_seed is None:
            sample = self._host_pipeline(**sample)
        else:
            entropy = [self._host_seed, int(index)] + ([] if view is None else [int(view)])
            rng = np.random.default_rng(np.random.SeedSequence(entropy))
            with sample_generator(rng):
                sample = self._host_pipeline(**sample)
        # with a device suffix the image stays uint8 on the host (4x cheaper
        # host->device copy) and the device pipeline makes it float; when the
        # whole pipeline ran here, cast like the reference ImageDataset does
        if not self.device_pipeline and sample.get("image") is not None:
            sample["image"] = np.asarray(sample["image"]).astype(
                resolve_np_dtype(self.input_dtype))
        return sample

    # ------------------------------ reading --------------------------------
    def _read_image(self, image_path: str) -> np.ndarray:
        """Decode one file (PNG -> RGBA, JPEG -> RGB) and convert it to the
        dataset's ``image_format``."""
        if self.reader_library == "pillow":
            raise NotImplementedError("reader_library 'pillow' is not ported: the port reads "
                                      "PNG and JPEG itself ('opencv', the default)")
        if self.reader_library not in ("opencv", "native"):
            raise ValueError(f"Unsupported reader library format `{self.reader_library}`")
        from torchok_tpu_torch import native
        return self._convert_image_format(native.decode_file(str(image_path)))

    def _composite_over(self, rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
        if (alpha == 255).all():  # opaque: the blend below gives rgb exactly
            return np.ascontiguousarray(rgb, dtype=np.uint8)
        alpha = alpha / 255.0
        out = np.clip(rgb * alpha + self.rgba_layout_color * (1 - alpha), 0, 255)
        return out.astype("uint8")

    def _convert_image_format(self, image: np.ndarray) -> np.ndarray:
        """``torchok_tpu``'s conversion to ``image_format`` (rgb, rgba, bgr,
        gray) from gray (HW), gray + alpha, RGB or RGBA: alpha composited
        over ``rgba_layout_color`` where the format has none."""
        fmt = self.image_format
        gray = image if image.ndim == 2 else None
        if image.ndim == 3 and image.shape[2] == 2:
            gray = image[..., 0]
        if fmt == "rgb":
            if image.ndim == 2:
                image = np.repeat(image[..., None], 3, axis=-1)
            elif image.shape[2] == 4:
                image = self._composite_over(image[..., :3], image[..., 3:4])
            elif image.shape[2] == 2:
                image = self._composite_over(np.repeat(gray[..., None], 3, -1), image[..., 1:2])
        elif fmt == "rgba":
            if image.ndim == 2:
                image = _with_alpha(np.repeat(image[..., None], 3, axis=-1))
            elif image.shape[2] == 3:
                image = _with_alpha(image)
            elif image.shape[2] == 2:
                image = np.concatenate([np.repeat(gray[..., None], 3, -1), image[..., 1:2]], -1)
        elif fmt == "bgr":
            if image.ndim == 2:
                image = np.repeat(image[..., None], 3, axis=-1)
            elif image.shape[2] == 4:
                image = self._composite_over(image[..., :3], image[..., 3:4])[..., ::-1]
            elif image.shape[2] == 3:
                image = image[..., ::-1]
            elif image.shape[2] == 2:
                image = self._composite_over(np.repeat(gray[..., None], 3, -1), image[..., 1:2])
            image = np.ascontiguousarray(image)
        elif fmt == "gray":
            if image.ndim == 3 and image.shape[2] == 4:
                image = self._composite_over(image[..., :3], image[..., 3:4])
            if image.ndim == 3 and image.shape[2] == 3:
                image = gray_from_rgb(image)
            if image.ndim == 3 and image.shape[2] == 2:
                image = image[..., 0]
            if image.ndim == 2:
                image = image[..., None]
        else:
            raise ValueError(f"Unsupported image format `{self.image_format}`")
        return image

    # ------------------------------ contract -------------------------------
    @abstractmethod
    def __len__(self) -> int:
        ...

    @abstractmethod
    def __getitem__(self, idx: int) -> dict:
        ...
