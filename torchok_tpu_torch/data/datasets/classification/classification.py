"""Multiclass or multilabel image classification from files (reference:
torchok/data/datasets/classification/classification.py:43-209; port of
``torchok_tpu.data.datasets.classification.classification``).

The annotation file (``.csv``, or ``.pkl`` through pandas) lists image paths
under ``input_column`` and labels under ``target_column``; a multilabel
target is a string of class indices, turned into a multihot vector.
"""
from __future__ import annotations

import re
import warnings
from pathlib import Path
from typing import Any, Optional, Tuple, Union

import numpy as np

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.annotations import read_table
from torchok_tpu_torch.data.datasets.base import ImageDataset, resolve_np_dtype


def process_multilabel(labels: Union[str, int], num_classes: int) -> np.ndarray:
    """A separated class-index string as a multihot vector."""
    labels = list(map(int, re.findall(r"\d+", str(labels))))
    max_label = max(labels)
    if max_label >= num_classes:
        raise ValueError(f"Target column contains label: {max_label}, it's more than "
                         f"num_classes = {num_classes}")
    multihot = np.zeros((num_classes,), dtype=bool)
    multihot[labels] = True
    return multihot


def process_multiclass(label: Any, num_classes: Optional[int]) -> int:
    label = int(label)
    if num_classes is not None and label >= num_classes:
        raise ValueError(
            f"Target column contains label: {label}, it's more than num_classes = {num_classes}")
    return label


@DATASETS.register_class
class ImageClassificationDataset(ImageDataset):
    def __init__(self, data_folder: str, transform, augment=None,
                 annotation_path: Optional[str] = None, num_classes: Optional[int] = None,
                 input_column: str = "image_path", input_dtype: str = "float32",
                 target_column: str = "label", target_dtype: str = "long",
                 reader_library: str = "opencv", image_format: str = "rgb",
                 rgba_layout_color: Union[int, Tuple[int, int, int]] = 0,
                 test_mode: bool = False, multilabel: bool = False, lazy_init: bool = False,
                 csv_path: Optional[str] = None):
        if annotation_path is None:
            if csv_path is None:
                raise ValueError("`annotation_path` must be specified.")
            warnings.warn("`csv_path` is deprecated; use annotation_path instead.")
            annotation_path = csv_path
        super().__init__(transform=transform, augment=augment, input_dtype=input_dtype,
                         reader_library=reader_library, image_format=image_format,
                         rgba_layout_color=rgba_layout_color, test_mode=test_mode)
        self.data_folder = Path(data_folder)
        self.annotation_path = annotation_path
        self.num_classes = num_classes
        self.input_column = input_column
        self.target_column = target_column
        self.target_dtype = target_dtype
        self.multilabel = multilabel
        self.table = read_table(self.data_folder / annotation_path)
        self._targets = None
        if not test_mode and not lazy_init:
            if multilabel and num_classes is None:
                raise ValueError("num_classes is required for multilabel targets")
            values = self.table[target_column]
            self._targets = np.stack([self._process(v) for v in values]) if multilabel else \
                np.array([self._process(v) for v in values], dtype=np.int64)

    def _process(self, value):
        if self.multilabel:
            return process_multilabel(value, self.num_classes)
        return process_multiclass(value, self.num_classes)

    def __len__(self) -> int:
        return len(self.table[self.input_column])

    def _target(self, idx: int):
        if self._targets is not None:
            return self._targets[idx]
        return self._process(self.table[self.target_column][idx])

    def _image(self, idx: int) -> np.ndarray:
        return self._read_image(str(self.data_folder / self.table[self.input_column][idx]))

    def __getitem__(self, idx: int) -> dict:
        sample = self.apply_host_pipeline({"image": self._image(idx)}, idx)
        out = {"image": sample["image"], "index": idx}
        if not self.test_mode:
            out["target"] = np.asarray(self._target(idx),
                                       dtype=resolve_np_dtype(self.target_dtype))
        return out
