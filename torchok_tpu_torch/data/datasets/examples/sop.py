"""Stanford Online Products (port of
``torchok_tpu.data.datasets.examples.sop``; reference:
torchok/data/datasets/examples/sop.py, triplet_sop.py). The same archive and
md5; ``download: true`` does nothing when the folder is there, as in the JAX
package. The annotation files (``Ebay_train.txt``, ``Ebay_test.txt``,
``Ebay_triplets.txt``: space-separated, with a header row) are read with
``annotations.read_table``."""
from __future__ import annotations

import tarfile
import urllib.request
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.annotations import read_table
from torchok_tpu_torch.data.datasets.base import ImageDataset
from torchok_tpu_torch.data.datasets.examples.cifar import check_integrity


class _SOPBase(ImageDataset):
    base_folder = "Stanford_Online_Products"
    url = "https://torchok-hub.s3.eu-west-1.amazonaws.com/Stanford_Online_Products.tar.gz"
    filename = "Stanford_Online_Products.tar.gz"
    tgz_md5 = "b96128cf2b75493708511ff5c400eefe"

    def _locate(self, data_folder: str, download: bool) -> None:
        self.data_folder = Path(data_folder)
        self.path = self.data_folder / self.base_folder
        if download:
            self._download()
        if not self.path.is_dir():
            raise RuntimeError("Dataset not found or corrupted. You can use download=True to "
                               "download it")

    def _download(self) -> None:
        if self.path.is_dir():
            return
        self.data_folder.mkdir(parents=True, exist_ok=True)
        archive = self.data_folder / self.filename
        if not check_integrity(archive, self.tgz_md5):
            urllib.request.urlretrieve(self.url, archive)  # noqa: S310
        with tarfile.open(archive, "r:gz") as tar:
            tar.extractall(self.data_folder)

    def _image(self, relative: str) -> np.ndarray:
        return self._read_image(str(self.path / relative))


@DATASETS.register_class
class SOP(_SOPBase):
    """120,053 images of 22,634 products; train 59,551 (labels from 1),
    test 60,502 (labels from 11319), both rebased to 0."""

    train_txt = "Ebay_train.txt"
    test_txt = "Ebay_test.txt"

    def __init__(self, train: bool, download: bool, data_folder: str, transform,
                 augment=None, input_dtype: str = "float32",
                 reader_library: str = "opencv", image_format: str = "rgb",
                 rgba_layout_color: Union[int, Tuple[int, int, int]] = 0,
                 test_mode: bool = False):
        super().__init__(transform=transform, augment=augment, input_dtype=input_dtype,
                         reader_library=reader_library, image_format=image_format,
                         rgba_layout_color=rgba_layout_color, test_mode=test_mode)
        self.train = train
        self._locate(data_folder, download)
        table = read_table(self.path / (self.train_txt if train else self.test_txt),
                           delimiter=" ")
        self.label_offset = 1 if train else 11319
        self.paths = table["path"]
        self.targets = np.array([int(v) for v in table["class_id"]],
                                dtype=np.int64) - self.label_offset

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        sample = self.apply_host_pipeline({"image": self._image(self.paths[idx])}, idx)
        out = {"image": sample["image"], "index": idx}
        if not self.test_mode:
            out["target"] = np.int64(self.targets[idx])
        return out


@DATASETS.register_class
class TRIPLET_SOP(_SOPBase):
    """11,319 (anchor, positive, negative) triplets over SOP; each image of
    a triplet draws its host transforms from a stream of its own (views 0,
    1, 2). ``train`` is accepted for the recipe's sake (``configs/
    triplet_sop.yaml`` sets it; the JAX class takes no such argument) and
    changes nothing: the triplets file is one split."""

    triplets_txt = "Ebay_triplets.txt"

    def __init__(self, download: bool, data_folder: str, transform, augment=None,
                 anchor_column: str = "anchor", positive_column: str = "positive",
                 negative_column: str = "negative", input_dtype: str = "float32",
                 reader_library: str = "opencv", image_format: str = "rgb",
                 rgba_layout_color: Union[int, Tuple[int, int, int]] = 0,
                 test_mode: bool = False, train: bool = True):
        super().__init__(transform=transform, augment=augment, input_dtype=input_dtype,
                         reader_library=reader_library, image_format=image_format,
                         rgba_layout_color=rgba_layout_color, test_mode=test_mode)
        self._locate(data_folder, download)
        table = read_table(self.path / self.triplets_txt, delimiter=" ")
        self.table = {"anchor": table[anchor_column], "positive": table[positive_column],
                      "negative": table[negative_column]}

    def __len__(self) -> int:
        return len(self.table["anchor"])

    def __getitem__(self, idx: int) -> dict:
        out = {}
        for view, key in enumerate(("anchor", "positive", "negative")):
            sample = self.apply_host_pipeline({"image": self._image(self.table[key][idx])}, idx,
                                              view=view)
            out[key] = sample["image"]
        out["index"] = idx
        return out
