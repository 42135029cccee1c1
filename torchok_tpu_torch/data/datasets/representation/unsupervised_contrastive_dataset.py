"""Unsupervised contrastive dataset (port of ``torchok_tpu.data.datasets.
representation.unsupervised_contrastive_dataset``; reference:
torchok/data/datasets/representation/unsupervised_contrastive_dataset.py):
one image through the host transforms twice, as views 0 and 1 with streams
of their own, gives ``image_0`` and ``image_1``; the engine's device suffix
then draws for each view apart."""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Optional, Tuple, Union

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.annotations import read_table
from torchok_tpu_torch.data.datasets.base import ImageDataset


@DATASETS.register_class
class UnsupervisedContrastiveDataset(ImageDataset):
    def __init__(self, data_folder: str, transform, augment=None,
                 annotation_path: Optional[str] = None,
                 input_column: str = "image_path", input_dtype: str = "float32",
                 reader_library: str = "opencv", image_format: str = "rgb",
                 rgba_layout_color: Union[int, Tuple[int, int, int]] = 0,
                 csv_path: Optional[str] = None):
        if annotation_path is None:
            if csv_path is None:
                raise ValueError("`annotation_path` must be specified.")
            warnings.warn("`csv_path` is deprecated; use annotation_path instead.")
            annotation_path = csv_path
        super().__init__(transform=transform, augment=augment, input_dtype=input_dtype,
                         reader_library=reader_library, image_format=image_format,
                         rgba_layout_color=rgba_layout_color)
        self.data_folder = Path(data_folder)
        self.input_column = input_column
        self.paths = read_table(self.data_folder / annotation_path)[input_column]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        image = self._read_image(str(self.data_folder / self.paths[idx]))
        out = {f"image_{view}": self.apply_host_pipeline({"image": image}, idx, view=view)["image"]
               for view in (0, 1)}
        out["index"] = idx
        return out
