"""CIFAR-10/100 datasets (port of ``torchok_tpu.data.datasets.examples.cifar``;
reference: torchok/data/datasets/examples/cifar.py:15-37).

They read the python-pickle batches under ``data_folder`` and check each
file's md5, as ``torchok_tpu`` does. ``download: true`` fetches and unpacks
the archive only when a batch is missing or corrupt; with the batches present
and intact nothing is fetched. The batches hold decoded arrays, so no image
library is needed: ``reader_library`` and ``image_format`` are accepted as
the reference accepts them and change nothing.
"""
from __future__ import annotations

import hashlib
import pickle
import tarfile
import urllib.request
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.base import ImageDataset


def _md5(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            h.update(data)
    return h.hexdigest()


def check_integrity(path: Path, md5: Optional[str]) -> bool:
    if not Path(path).is_file():
        return False
    return md5 is None or _md5(Path(path)) == md5


@DATASETS.register_class
class CIFAR10(ImageDataset):
    uniform_image_size = True  # fixed-size in-memory arrays: vectorized batch fetch

    base_folder = "cifar-10-batches-py"
    url = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
    filename = "cifar-10-python.tar.gz"
    tgz_md5 = "c58f30108f718f92721af3b95e74349a"
    train_list = [
        ["data_batch_1", "c99cafc152244af753f735de768cd75f"],
        ["data_batch_2", "d4bba439e000b95fd0a9bffe97cbabec"],
        ["data_batch_3", "54ebc095f3ab1f0389bbae665268c751"],
        ["data_batch_4", "634d18415352ddfa80567beed471001a"],
        ["data_batch_5", "482c414d41f54cd18b22e5b47cb7c3cb"],
    ]
    test_list = [["test_batch", "40351d587109b95175f43aff81a1287e"]]
    meta = {"filename": "batches.meta", "key": "label_names",
            "md5": "5ff9c542aee3614f3951f8cda6e48888"}

    def __init__(self, train: bool, download: bool, data_folder: str, transform,
                 augment=None, input_dtype: str = "float32",
                 reader_library: str = "opencv", image_format: str = "rgb",
                 rgba_layout_color: Union[int, Tuple[int, int, int]] = 0,
                 test_mode: bool = False):
        super().__init__(transform=transform, augment=augment, input_dtype=input_dtype,
                         test_mode=test_mode)
        self.reader_library = reader_library
        self.image_format = image_format
        self.rgba_layout_color = rgba_layout_color
        self.data_folder = Path(data_folder)
        self.train = train

        if download:
            self._download()
        if not self._check_integrity():
            raise RuntimeError("Dataset not found or corrupted. You can use download=True to download it")

        file_list = self.train_list if train else self.test_list
        images, targets = [], []
        for file_name, _ in file_list:
            with open(self.data_folder / self.base_folder / file_name, "rb") as f:
                entry = pickle.load(f, encoding="latin1")
                images.append(entry["data"])
                targets.extend(entry.get("labels", entry.get("fine_labels")))
        self.targets = np.array(targets, dtype=np.int64)
        self.images = np.vstack(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self._load_meta()

    def _load_meta(self) -> None:
        path = self.data_folder / self.base_folder / self.meta["filename"]
        if not check_integrity(path, self.meta["md5"]):
            raise RuntimeError("Dataset metadata file not found or corrupted. "
                               "You can use download=True to download it")
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        self.classes = data[self.meta["key"]]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

    def _check_integrity(self) -> bool:
        for file_name, md5 in self.train_list + self.test_list:
            if not check_integrity(self.data_folder / self.base_folder / file_name, md5):
                return False
        return True

    def _download(self) -> None:
        if self._check_integrity():
            return
        self.data_folder.mkdir(parents=True, exist_ok=True)
        archive = self.data_folder / self.filename
        if not check_integrity(archive, self.tgz_md5):
            urllib.request.urlretrieve(self.url, archive)  # noqa: S310
            if not check_integrity(archive, self.tgz_md5):
                raise RuntimeError(f"Downloaded archive {archive} failed md5 check")
        with tarfile.open(archive, "r:gz") as tar:
            tar.extractall(self.data_folder)

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, idxs: np.ndarray) -> dict:
        """Vectorized batch fetch (numpy fancy-index, no per-sample Python).
        Used by the loader when the host transform prefix is empty."""
        out = {"image": self.images[idxs], "index": idxs.astype("int64")}
        if not self.test_mode:
            out["target"] = self.targets[idxs]
        return out

    def __getitem__(self, idx: int) -> dict:
        sample = self.apply_host_pipeline({"image": self.images[idx]}, idx)
        out = {"image": sample["image"], "index": idx}
        if not self.test_mode:
            out["target"] = np.int64(self.targets[idx])
        return out


@DATASETS.register_class
class CIFAR100(CIFAR10):
    base_folder = "cifar-100-python"
    url = "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz"
    filename = "cifar-100-python.tar.gz"
    tgz_md5 = "eb9058c3a382ffc7106e4002c42a8d85"
    train_list = [["train", "16019d7e3df5f24257cddd939b257f8d"]]
    test_list = [["test", "f0ef6b0ae62326f3e7ffdfab6717acfc"]]
    meta = {"filename": "meta", "key": "fine_label_names",
            "md5": "7973b15100ade9c7d40fb424638fde48"}
