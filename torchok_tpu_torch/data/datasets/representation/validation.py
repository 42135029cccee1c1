"""Retrieval validation dataset (port of ``torchok_tpu.data.datasets.
representation.validation``; reference: torchok/data/datasets/
representation/validation.py:13-291).

Each sample carries its image, ``index``, ``query_idxs`` (its row among the
queries, or -1), ``scores`` (its relevance to each query) and
``group_labels``, which the index-based meters read. The tables are read
with ``annotations.read_table``: an empty ``relevant`` cell is a query
without relevant images (pandas reads it as NaN in the JAX package).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.annotations import read_table
from torchok_tpu_torch.data.datasets.base import ImageDataset


def _ids_to_paths(table, what: str) -> dict:
    ids = [int(v) for v in table["id"]]
    out = dict(zip(ids, table["image_path"]))
    if len(out) != len(ids):
        raise ValueError(f"{what} csv have the same id for different image paths.")
    return out


@DATASETS.register_class
class RetrievalDataset(ImageDataset):
    def __init__(self,
                 data_folder: str,
                 matches_csv_path: str,
                 img_list_csv_path: str,
                 transform,
                 augment=None,
                 gallery_folder: Optional[str] = "",
                 gallery_list_csv_path: Optional[str] = None,
                 use_query_without_relevants: bool = False,
                 input_dtype: str = "float32",
                 reader_library: str = "opencv",
                 image_format: str = "rgb",
                 rgba_layout_color: Union[int, Tuple[int, int, int]] = 0):
        super().__init__(transform=transform, augment=augment, input_dtype=input_dtype,
                         reader_library=reader_library, image_format=image_format,
                         rgba_layout_color=rgba_layout_color)
        self.data_folder = Path(data_folder)
        self.use_query_without_relevants = use_query_without_relevants

        self.matches = read_table(self.data_folder / matches_csv_path)
        self.img_paths = read_table(self.data_folder / img_list_csv_path)
        self.use_scores = "scores" in self.matches
        self.use_group_labels = "label" in self.img_paths

        (self.n_not_query, self.n_queries, self.index2imgid, self.imgid2index,
         self.index2label, self.relevant_arr, self.relevance_scores) = self._parse_match_csv()

        self.imgid2path = _ids_to_paths(self.img_paths, "Image")
        self.data_len = self.n_queries + self.n_not_query

        self.gallery_index2imgid = {}
        self.n_gallery = 0
        if gallery_list_csv_path is not None:
            self.gallery_folder = Path(gallery_folder)
            self.gallery_imgid2path = _ids_to_paths(
                read_table(self.gallery_folder / gallery_list_csv_path), "Gallery")
            for img_id in self.gallery_imgid2path:
                self.gallery_index2imgid[self.data_len + self.n_gallery] = img_id
                self.n_gallery += 1
            self.data_len += self.n_gallery

        self.scores, self.query_idxs, self.group_labels = self._get_targets()

    # ------------------------------------------------------------------
    def _parse_match_csv(self):
        query_arr = [int(v) for v in self.matches["query"]]
        index2imgid = dict(enumerate(query_arr))
        imgid2index = dict(zip(query_arr, range(len(query_arr))))
        n_queries = len(index2imgid)

        relevant_arr, relevance_scores = [], []
        n_not_query = 0
        for index in range(len(query_arr)):
            row_relevants, row_scores = [], []
            relevant = self.matches["relevant"][index]
            if relevant == "":
                if self.use_query_without_relevants:
                    relevant_arr.append([])
                    relevance_scores.append([])
                    continue
                raise ValueError(
                    "Match csv has query without relevant elements. Check your csv or "
                    "set parameter use_query_without_relevants=True to set relevants "
                    "as empty for these queries.")
            rel_img_idxs = list(map(int, relevant.split()))
            if self.use_scores:
                rel_img_scores = list(map(float, self.matches["scores"][index].split()))
            else:
                rel_img_scores = [1] * len(rel_img_idxs)
            if len(rel_img_idxs) != len(rel_img_scores):
                raise ValueError(
                    f"Relevant objects list must match relevance scores list in size. "
                    f"Got number of relevant object indices: {len(rel_img_idxs)}, "
                    f"number of relevance scores: {len(rel_img_scores)}")
            for img_id, img_score in zip(rel_img_idxs, rel_img_scores):
                if img_id not in imgid2index:
                    index2imgid[n_queries + n_not_query] = img_id
                    imgid2index[img_id] = n_queries + n_not_query
                    n_not_query += 1
                row_relevants.append(img_id)
                row_scores.append(img_score)
            relevant_arr.append(row_relevants)
            relevance_scores.append(row_scores)

        for img_id in (int(v) for v in self.img_paths["id"]):
            if img_id not in imgid2index:
                index2imgid[n_queries + n_not_query] = img_id
                imgid2index[img_id] = n_queries + n_not_query
                n_not_query += 1

        index2label = {}
        if self.use_group_labels:  # the first row of each id, as pandas' .loc gives it
            labels = {}
            for img_id, label in zip(self.img_paths["id"], self.img_paths["label"]):
                labels.setdefault(int(img_id), int(label))
        for index, img_id in index2imgid.items():
            index2label[index] = labels[img_id] if self.use_group_labels else 0
        return (n_not_query, n_queries, index2imgid, imgid2index, index2label,
                relevant_arr, relevance_scores)

    def _get_targets(self):
        scores = np.zeros((len(self), self.n_queries), dtype=np.float32)
        query_idxs = np.full((len(self),), -1, dtype=np.int32)
        group_labels = np.full((len(self),), -1, dtype=np.int64)
        for index in range(self.n_queries):
            relevant_indices = [self.imgid2index[i] for i in self.relevant_arr[index]]
            for rel_index, score in zip(relevant_indices, self.relevance_scores[index]):
                scores[rel_index][index] = score
            query_idxs[index] = index
        for index, label in self.index2label.items():
            group_labels[index] = label
        return scores, query_idxs, group_labels

    # ------------------------------------------------------------------
    def _image_path(self, idx: int) -> Path:
        if idx < self.n_queries + self.n_not_query:
            return self.data_folder / self.imgid2path[self.index2imgid[idx]]
        return self.gallery_folder / self.gallery_imgid2path[self.gallery_index2imgid[idx]]

    def __getitem__(self, idx: int) -> dict:
        image = self._read_image(str(self._image_path(idx)))
        sample = self.apply_host_pipeline({"image": image}, idx)
        return {"image": sample["image"], "index": idx,
                "query_idxs": self.query_idxs[idx],
                "scores": self.scores[idx],
                "group_labels": self.group_labels[idx]}

    def __len__(self) -> int:
        return self.data_len
