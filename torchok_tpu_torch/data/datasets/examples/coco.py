"""COCO 2017 detection and segmentation example datasets (reference:
torchok/data/datasets/examples/coco_detection.py, coco_segmentation.py; port
of ``torchok_tpu.data.datasets.examples.coco``).

The annotation JSON becomes one record per image with the ``json`` module:
category ids in sorted order give the contiguous labels, ``iscrowd``
annotations are skipped, and an image without annotations keeps empty lists.
Where pandas is installed the records are cached in (and read back from) the
JAX package's ``.pkl`` files; without it the JSON is parsed on every start
and nothing is written. ``download`` fetches the three archives unless
``annotations/`` is already there.
"""
from __future__ import annotations

import json
import urllib.request
import zipfile
from pathlib import Path
from typing import Dict, List

import numpy as np

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.annotations import read_table
from torchok_tpu_torch.data.datasets.detection.detection import DetectionDataset

_URLS = {
    "train2017.zip": "http://images.cocodataset.org/zips/train2017.zip",
    "val2017.zip": "http://images.cocodataset.org/zips/val2017.zip",
    "annotations_trainval2017.zip":
        "http://images.cocodataset.org/annotations/annotations_trainval2017.zip",
}


def coco_records(annotation_path: Path, image_folder: Path) -> Dict[str, List]:
    """``image_path``, ``bbox`` (COCO xywh lists) and ``label`` columns, one
    row per image in the JSON's image order."""
    with open(annotation_path) as f:
        coco = json.load(f)
    cat2label = {cid: i for i, cid in enumerate(sorted(c["id"] for c in coco["categories"]))}
    per_image: Dict[int, Dict[str, list]] = {}
    for ann in coco["annotations"]:
        if ann.get("iscrowd"):
            continue
        entry = per_image.setdefault(ann["image_id"], {"bbox": [], "label": []})
        entry["bbox"].append([float(v) for v in ann["bbox"]])
        entry["label"].append(cat2label[ann["category_id"]])
    table: Dict[str, List] = {"image_path": [], "bbox": [], "label": []}
    for im in coco["images"]:
        entry = per_image.get(im["id"], {"bbox": [], "label": []})
        table["image_path"].append(str(image_folder / im["file_name"]))
        table["bbox"].append(entry["bbox"])
        table["label"].append(entry["label"])
    return table


def _cached_records(root: Path, pkl: str, split: str) -> Dict[str, List]:
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and (root / pkl).exists():
        return read_table(root / pkl)
    table = coco_records(root / f"annotations/instances_{split}.json", Path(split))
    if pd is not None:
        pd.DataFrame(table).to_pickle(root / pkl)
    return table


@DATASETS.register_class
class COCODetection(DetectionDataset):
    base_folder = "COCO"
    train_pkl = "train_detection.pkl"
    valid_pkl = "valid_detection.pkl"

    def __init__(self, train: bool, download: bool, data_folder: str, transform,
                 augment=None, input_dtype: str = "float32", test_mode: bool = False,
                 max_boxes: int = 100, **kwargs):
        root = Path(data_folder) / self.base_folder
        if download:
            self._download(root)
        if not root.is_dir():
            raise RuntimeError("Dataset not found or corrupted. You can use download=True to "
                               "download it")
        pkl = self.train_pkl if train else self.valid_pkl
        self._records = _cached_records(root, pkl, "train2017" if train else "val2017")
        super().__init__(data_folder=str(root), annotation_path=pkl, transform=transform,
                         augment=augment, input_dtype=input_dtype, bbox_format="coco",
                         test_mode=test_mode, max_boxes=max_boxes, **kwargs)

    def _read_annotations(self, path: Path) -> Dict[str, List]:
        return self._records

    @staticmethod
    def _download(root: Path) -> None:
        if root.is_dir() and (root / "annotations").is_dir():
            return
        root.mkdir(parents=True, exist_ok=True)
        for name, url in _URLS.items():
            archive = root / name
            if not archive.exists():
                urllib.request.urlretrieve(url, archive)  # noqa: S310
            with zipfile.ZipFile(archive) as z:
                z.extractall(root)


def fill_rectangle(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int, value: int) -> None:
    """``cv2.rectangle(mask, (x0, y0), (x1, y1), value, -1)``: the corners'
    box filled inclusively, clipped to the array."""
    h, w = mask.shape[:2]
    xa, xb = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
    ya, yb = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
    if xa <= xb and ya <= yb:
        mask[ya:yb + 1, xa:xb + 1] = value


@DATASETS.register_class
class COCOSegmentation(COCODetection):
    """COCO with a per-pixel mask of label + 1 painted from each box
    (filled rectangles in annotation order; background 0)."""

    train_pkl = "train_segmentation.pkl"
    valid_pkl = "valid_segmentation.pkl"

    def __getitem__(self, idx: int) -> dict:
        image = self._read_image(str(self.data_folder / self.paths[idx]))
        mask = np.zeros(image.shape[:2], np.int64)
        boxes = np.asarray(self.boxes[idx], np.float32).reshape(-1, 4)
        labels = np.asarray(self.labels[idx], np.int64).reshape(-1)
        for (x, y, w, h), lab in zip(boxes, labels):
            fill_rectangle(mask, int(x), int(y), int(x + w), int(y + h), int(lab) + 1)
        sample = self.apply_host_pipeline({"image": image, "mask": mask}, idx)
        out = {"image": sample["image"], "index": idx}
        if not self.test_mode:
            out["target"] = np.asarray(sample["mask"], np.int64)
        return out
