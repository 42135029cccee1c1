"""Image + mask segmentation dataset (port of ``torchok_tpu.data.datasets.
segmentation.image_segmentation``; reference: torchok/data/datasets/
segmentation/image_segmentation.py): image and mask through the host
transforms together, the mask as ``target``.

The JAX package reads a mask with ``cv2.imread(path, IMREAD_GRAYSCALE)``.
The port decodes the PNG itself (:mod:`torchok_tpu_torch.native`) and
gives what that call gives: a gray file's values, and for a colour file
(RGB, RGBA, palette) the gray that OpenCV asks libpng for, ``(9797 R +
19234 G + 3737 B) >> 15`` truncated, alpha ignored (equal to OpenCV 5.0's
on every colour tried)."""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.annotations import read_table
from torchok_tpu_torch.data.datasets.base import ImageDataset


def read_gray_png(path: str) -> np.ndarray:
    """(H, W) uint8 of a PNG file, as ``cv2.IMREAD_GRAYSCALE`` reads it."""
    from torchok_tpu_torch import native
    with open(path, "rb") as f:
        data = f.read()
    if native.probe(data) != 2:
        raise NotImplementedError(f"{path}: masks are read from PNG files only")
    rgb = native.decode_png(data)[..., :3].astype(np.int32)
    gray = (rgb[..., 0] * 9797 + rgb[..., 1] * 19234 + rgb[..., 2] * 3737) >> 15
    # a gray pixel stays as it is (9797 + 19234 + 3737 = 2^15)
    return gray.astype(np.uint8)


@DATASETS.register_class
class ImageSegmentationDataset(ImageDataset):
    def __init__(self, data_folder: str, annotation_path: str, transform,
                 augment=None, input_column: str = "image_path",
                 target_column: str = "mask_path", input_dtype: str = "float32",
                 target_dtype: str = "int64", reader_library: str = "opencv",
                 image_format: str = "rgb",
                 rgba_layout_color: Union[int, Tuple[int, int, int]] = 0,
                 test_mode: bool = False):
        super().__init__(transform=transform, augment=augment, input_dtype=input_dtype,
                         reader_library=reader_library, image_format=image_format,
                         rgba_layout_color=rgba_layout_color, test_mode=test_mode)
        self.data_folder = Path(data_folder)
        self.input_column = input_column
        self.target_column = target_column
        self.target_dtype = np.dtype(target_dtype)
        self.table = read_table(self.data_folder / annotation_path)

    def __len__(self) -> int:
        return len(self.table[self.input_column])

    def _read_mask(self, idx: int) -> np.ndarray:
        path = self.data_folder / self.table[self.target_column][idx]
        if not path.is_file():
            raise ValueError(f"{self.table[self.target_column][idx]} mask does not exist")
        return read_gray_png(str(path))

    def _image(self, idx: int) -> np.ndarray:
        return self._read_image(str(self.data_folder / self.table[self.input_column][idx]))

    def __getitem__(self, idx: int) -> dict:
        sample = {"image": self._image(idx)}
        if not self.test_mode:
            sample["mask"] = self._read_mask(idx)
        sample = self.apply_host_pipeline(sample, idx)
        out = {"image": sample["image"], "index": idx}
        if not self.test_mode:
            # with a device suffix the labels ride it as 'mask' (its geometric
            # ops move them with the image); the trainer renames them 'target'
            key = "mask" if self.device_pipeline else "target"
            out[key] = np.asarray(sample["mask"]).astype(self.target_dtype)
        return out
