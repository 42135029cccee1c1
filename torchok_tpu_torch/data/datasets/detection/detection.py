"""Detection dataset (reference: torchok/data/datasets/detection/detection.py:20-218;
port of ``torchok_tpu.data.datasets.detection.detection``).

The annotation file (``.csv`` with JSON lists, or ``.pkl``) holds per image
its path, its boxes and their labels. Boxes become pixel pascal_voc
``(x1, y1, x2, y2)`` on load, go through the host transforms with the image
(the dataset has ``has_bboxes``, so every geometric op stays on the host),
lose the rows a transform clipped to nothing, and are padded to a fixed
``max_boxes`` with label -1, so every batch has one shape.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.annotations import read_table
from torchok_tpu_torch.data.datasets.base import ImageDataset


def _to_pascal_voc(bboxes, fmt: str) -> np.ndarray:
    b = np.asarray(bboxes, np.float32).reshape(-1, 4)
    if fmt == "coco":  # x, y, w, h
        out = b.copy()
        out[:, 2] = b[:, 0] + b[:, 2]
        out[:, 3] = b[:, 1] + b[:, 3]
        return out
    if fmt == "pascal_voc":
        return b
    raise ValueError(f"Unsupported bbox_format {fmt!r} (coco|pascal_voc)")


def _as_list(value):
    return json.loads(value) if isinstance(value, str) else value


@DATASETS.register_class
class DetectionDataset(ImageDataset):
    has_bboxes = True

    def __init__(self, data_folder: str, annotation_path: str, transform, augment=None,
                 input_column: str = "image_path", bbox_column: str = "bbox",
                 bbox_dtype: str = "float32", target_column: str = "label",
                 target_dtype: str = "int64", input_dtype: str = "float32",
                 reader_library: str = "opencv", image_format: str = "rgb",
                 rgba_layout_color: Union[int, Tuple[int, int, int]] = 0,
                 test_mode: bool = False, bbox_format: str = "coco", min_area: float = 0.0,
                 min_visibility: float = 0.0, max_boxes: int = 100,
                 filter_bboxes_on_start: bool = False):
        super().__init__(transform=transform, augment=augment, input_dtype=input_dtype,
                         reader_library=reader_library, image_format=image_format,
                         rgba_layout_color=rgba_layout_color, test_mode=test_mode)
        self.data_folder = Path(data_folder)
        self.input_column = input_column
        self.bbox_format = bbox_format
        self.min_area = min_area
        self.max_boxes = max_boxes
        table = self._read_annotations(self.data_folder / annotation_path)
        self.paths = table[input_column]
        self.boxes = [_as_list(v) for v in table[bbox_column]]
        self.labels = [_as_list(v) for v in table[target_column]] \
            if target_column in table else None

    def _read_annotations(self, path: Path) -> Dict[str, List]:
        """Column name -> values of the annotation file at ``path``."""
        return read_table(path)

    def __len__(self) -> int:
        return len(self.paths)

    def _load(self, idx: int):
        image = self._read_image(str(self.data_folder / self.paths[idx]))
        raw = self.boxes[idx]
        boxes = _to_pascal_voc(raw, self.bbox_format) if len(raw) \
            else np.zeros((0, 4), np.float32)
        labels = np.asarray(self.labels[idx] if self.labels is not None else [0] * len(boxes),
                            np.int64).reshape(-1)
        if self.min_area > 0 and len(boxes):
            areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            keep = areas >= self.min_area
            boxes, labels = boxes[keep], labels[keep]
        return image, boxes, labels

    def _pad(self, boxes: np.ndarray, labels: np.ndarray):
        n = min(len(boxes), self.max_boxes)
        out_boxes = np.zeros((self.max_boxes, 4), np.float32)
        out_labels = np.full((self.max_boxes,), -1, np.int64)
        out_boxes[:n] = boxes[:n]
        out_labels[:n] = labels[:n]
        return out_boxes, out_labels

    @staticmethod
    def _drop_degenerate(boxes: np.ndarray, labels: np.ndarray):
        """Transforms clip boxes to the frame but never drop rows (so labels
        stay aligned); boxes clipped to zero extent are removed here."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        keep = (boxes[:, 2] - boxes[:, 0] > 1e-3) & (boxes[:, 3] - boxes[:, 1] > 1e-3)
        return boxes[keep], labels[keep]

    def __getitem__(self, idx: int) -> dict:
        image, boxes, labels = self._load(idx)
        orig_shape = np.asarray(image.shape[:2], np.int64)
        sample = self.apply_host_pipeline({"image": image, "bboxes": boxes}, idx)
        boxes, labels = self._pad(*self._drop_degenerate(sample["bboxes"], labels))
        out = {"image": sample["image"], "index": idx, "orig_img_shape": orig_shape}
        if not self.test_mode:
            out["bboxes"] = boxes
            out["label"] = labels
        return out
