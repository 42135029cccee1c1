"""Sweet Pepper segmentation dataset (port of
``torchok_tpu.data.datasets.examples.sweet_pepper``; reference:
torchok/data/datasets/examples/sweet_pepper.py, the Kaggle sweet-pepper
set). The same archive and md5; ``download: true`` does nothing when the
folder is there, as in the JAX package."""
from __future__ import annotations

import tarfile
import urllib.request
from pathlib import Path
from typing import Tuple, Union

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.examples.cifar import check_integrity
from torchok_tpu_torch.data.datasets.segmentation.image_segmentation import (
    ImageSegmentationDataset,
)


@DATASETS.register_class
class SweetPepper(ImageSegmentationDataset):
    """``sweet_pepper/train.csv`` or ``valid.csv`` (columns ``image`` and
    ``mask``) under ``data_folder``."""

    base_folder = "sweet_pepper"
    filename = "sweet_pepper.tar.gz"
    url = "https://torchok-hub.s3.eu-west-1.amazonaws.com/sweet_pepper.tar.gz"
    tgz_md5 = "65021e5fad5fe286b3c2bac7753d6e9d"
    train_csv = "train.csv"
    valid_csv = "valid.csv"

    def __init__(self, train: bool, download: bool, data_folder: str, transform,
                 augment=None, input_dtype: str = "float32",
                 image_format: str = "rgb",
                 rgba_layout_color: Union[int, Tuple[int, int, int]] = 0,
                 test_mode: bool = False):
        self.data_folder_root = Path(data_folder)
        path = self.data_folder_root / self.base_folder
        if download:
            self._download(path)
        if not path.is_dir():
            raise RuntimeError("Dataset not found or corrupted. You can use download=True to "
                               "download it")
        super().__init__(data_folder=str(path),
                         annotation_path=self.train_csv if train else self.valid_csv,
                         transform=transform, augment=augment,
                         input_column="image", target_column="mask",
                         input_dtype=input_dtype, image_format=image_format,
                         rgba_layout_color=rgba_layout_color, test_mode=test_mode)

    def _download(self, path: Path) -> None:
        if path.is_dir():
            return
        self.data_folder_root.mkdir(parents=True, exist_ok=True)
        archive = self.data_folder_root / self.filename
        if not check_integrity(archive, self.tgz_md5):
            urllib.request.urlretrieve(self.url, archive)  # noqa: S310
        with tarfile.open(archive, "r:gz") as tar:
            tar.extractall(self.data_folder_root)
