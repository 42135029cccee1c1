"""Index-based retrieval metrics (port of
``torchok_tpu.metrics.index_base_metric``; reference:
torchok/metrics/index_base_metric.py:32-545).

The retrieval-metric engine: accumulates embeddings (and labels, or
query_idxs and scores) across the eval epoch, builds a nearest-neighbour
index over the gallery and feeds the ranked lists to ranking functions.

The vectors stay on the device of the step outputs: ``update`` appends them
there, ``compute`` concatenates them and builds the index (``ops/knn.py``)
on that device, so the search runs where the state lives and never on a
host copy. Labels, query indexes and scores go to the host at ``compute``,
where the relevance bookkeeping runs in numpy. The exact index serves
``exact_index=True`` and galleries below ``ivf_threshold`` rows; larger
galleries of ``exact_index=False`` take the IVF index. The k+1 search with
the query's own row removed, the classification and representation data
preparation, group averaging and ``k_as_target_len`` follow the reference.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from torchok_tpu_torch.metrics.base import Metric
from torchok_tpu_torch.ops.knn import FlatIndex, IvfIndex

logger = logging.getLogger(__name__)

DATASET_TYPES = ("classification", "representation")
METRIC_DISTANCES = ("IP", "L2")


def _host(values: List[Any]) -> np.ndarray:
    """Concatenate per-batch labels (tensors or arrays) into one numpy array."""
    return np.concatenate([v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                           for v in values])


class IndexBasedMeter(Metric):
    def __init__(self, exact_index: bool, dataset_type: str, metric_distance: str,
                 metric_func: Callable, k_as_target_len: bool = False,
                 k: Optional[int] = None, use_batching_search: bool = True,
                 search_batch_size: Optional[int] = None,
                 normalize_vectors: bool = False, group_averaging: bool = False,
                 raise_empty_query: bool = True,
                 ivf_threshold: int = 200_000, ivf_nlist: Optional[int] = None,
                 ivf_nprobe: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        if dataset_type not in DATASET_TYPES:
            raise ValueError(f"dataset_type must be one of {DATASET_TYPES}")
        if metric_distance not in METRIC_DISTANCES:
            raise ValueError(f"metric_distance must be one of {METRIC_DISTANCES}")
        self.exact_index = exact_index
        self.ivf_threshold = ivf_threshold
        self.ivf_nlist = ivf_nlist
        self.ivf_nprobe = ivf_nprobe
        self.dataset_type = dataset_type
        self.metric_distance = metric_distance
        self.metric_func = metric_func
        self.normalize_vectors = normalize_vectors
        self.group_averaging = group_averaging
        self.k_as_target_len = k_as_target_len
        self.use_batching_search = use_batching_search
        self.raise_empty_query = raise_empty_query
        self.search_batch_size = search_batch_size or 512
        k = 1 if k is None else k
        self.search_k = k + 1  # query may sit in the gallery; drop self-match
        self.metric_compute_k = k

    # ------------------------------------------------------------------
    def empty_state(self, device) -> Dict[str, Any]:
        state: Dict[str, Any] = {"device": torch.device(device), "vectors": [],
                                 "group_labels": []}
        if self.dataset_type == "representation":
            state["query_idxs"] = []
            state["scores"] = []
        return state

    def update(self, state, vectors=None, group_labels=None, query_idxs=None,
               scores=None, **_):
        state["vectors"].append(torch.as_tensor(vectors, device=state["device"]).detach())
        if self.dataset_type == "classification":
            if group_labels is None:
                raise ValueError("In classification dataset group_labels must be not None.")
            state["group_labels"].append(group_labels)
        else:
            if query_idxs is None:
                raise ValueError("In representation dataset query_numbers must be not None.")
            if scores is None:
                raise ValueError("In representation dataset scores must be not None")
            state["query_idxs"].append(query_idxs)
            state["scores"].append(scores)
            state["group_labels"].append(
                group_labels if group_labels is not None
                else np.zeros(len(query_idxs), np.int64))
        return state

    # ------------------------------------------------------------------
    def prepare_representation_data(self, query_idxs, scores):
        is_query = query_idxs >= 0
        query_column_idxs = query_idxs[is_query]
        query_row_idxs = np.where(is_query)[0]
        query_as_relevant = np.any(scores[query_row_idxs, :] > 0, axis=-1)

        gallery_idxs = np.arange(len(scores))
        clear_query_idxs = query_row_idxs[~query_as_relevant]
        gallery_idxs = np.delete(gallery_idxs, clear_query_idxs)

        relevant_idxs = []
        for query_col_idx in query_column_idxs:
            curr = np.where(scores[:, query_col_idx] > 0.0)[0]
            if len(curr) == 0:
                if self.raise_empty_query:
                    raise ValueError(
                        "Retrieval metric: the dataset contains a query vector "
                        "with no relevant items; set raise_empty_query=False "
                        "to skip such queries.")
                relevant_idxs.append(np.empty((0,), np.int64))
            else:
                order = np.argsort(scores[curr, query_col_idx])[::-1]
                relevant_idxs.append(curr[order])
        relevant_idxs = np.array(relevant_idxs, dtype=object)
        return relevant_idxs, gallery_idxs, query_column_idxs, query_row_idxs, query_as_relevant

    def prepare_classification_data(self, targets):
        relevant_idxs, query_row_idxs = [], []
        order = {}
        for idx, t in enumerate(targets):
            order.setdefault(t, []).append(idx)
        for label, group in order.items():
            garr = np.array(group)
            for query_idx in group:
                relevant = garr[garr != query_idx]
                if len(relevant) == 0 and self.raise_empty_query:
                    raise ValueError(
                        f"Retrieval metric: class {label} has a single element, "
                        "so its query has no relevant items; set "
                        "raise_empty_query=False to skip such queries.")
                query_row_idxs.append(query_idx)
                relevant_idxs.append(relevant)
        relevant_idxs = np.array(relevant_idxs, dtype=object)
        query_row_idxs = np.array(query_row_idxs)
        gallery_idxs = np.arange(len(targets))
        query_as_relevant = np.full((len(query_row_idxs),), True, dtype=bool)
        return relevant_idxs, gallery_idxs, query_row_idxs, query_as_relevant

    @staticmethod
    def clear_search_output(output, query_as_relevant):
        """Drop the self-match column (first element when the query is in the
        gallery, last otherwise — k+1 were searched)."""
        out = np.zeros((output.shape[0], output.shape[1] - 1), output.dtype)
        out[query_as_relevant] = output[query_as_relevant, 1:]
        out[~query_as_relevant] = output[~query_as_relevant, :-1]
        return out

    def process_data_for_metric_func(self, closest_scores, closest_idxs,
                                     relevants_idxs, query_col_idxs, scores, k):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def compute(self, state) -> float:
        vectors = torch.cat(state["vectors"]).float()
        group_labels = _host(state["group_labels"]) if state["group_labels"] else None
        if self.normalize_vectors:
            # per-row L2 normalization (cosine similarity under IP): the
            # reference's code divides by per-column norms
            # (index_base_metric.py:193, axis=0), but its committed answer
            # tables are cosine rankings, which only rows reproduce
            norms = torch.linalg.vector_norm(vectors, dim=1, keepdim=True)
            vectors = vectors / torch.clamp_min(norms, 1e-12)

        if self.dataset_type == "classification":
            relevant_idxs, gallery_idxs, query_row_idxs, query_as_relevant = \
                self.prepare_classification_data(group_labels)
            scores = None
            query_column_idxs = None
        else:
            scores = _host(state["scores"])
            query_idxs = _host(state["query_idxs"])
            (relevant_idxs, gallery_idxs, query_column_idxs, query_row_idxs,
             query_as_relevant) = self.prepare_representation_data(query_idxs, scores)

        device = vectors.device
        gallery_vectors = vectors[torch.as_tensor(gallery_idxs, device=device)]
        if not self.exact_index and len(gallery_vectors) >= self.ivf_threshold:
            # the IVF only where the dense product dominates; below the
            # threshold "approximate" configs get exact results (a valid
            # superset of IVF's recall)
            index = IvfIndex(gallery_vectors, metric=self.metric_distance,
                             nlist=self.ivf_nlist, nprobe=self.ivf_nprobe)
        else:
            index = FlatIndex(gallery_vectors, metric=self.metric_distance)

        if self.group_averaging:
            uniq = np.unique(group_labels)
            group_split = [np.where(group_labels == label)[0] for label in uniq]
        else:
            group_split = [np.arange(len(group_labels))]

        metric_values = []
        for group_indexes in group_split:
            curr_metric = 0.0
            sel = np.isin(query_row_idxs, group_indexes)
            curr_query_col_idxs = None if query_column_idxs is None else query_column_idxs[sel]
            curr_relevant_idxs = relevant_idxs[sel]
            curr_query_row_idxs = query_row_idxs[sel]
            curr_query_as_relevant = query_as_relevant[sel]

            if self.k_as_target_len:
                k = len(group_indexes) + 1 - int(np.sum(~curr_query_as_relevant))
            else:
                k = self.search_k

            bs = self.search_batch_size if self.use_batching_search else len(curr_query_row_idxs)
            for i in range(0, len(curr_query_row_idxs), bs):
                batch = np.arange(i, min(i + bs, len(curr_query_row_idxs)))
                b_as_rel = curr_query_as_relevant[batch]
                b_rows = curr_query_row_idxs[batch]
                b_rels = curr_relevant_idxs[batch]
                b_cols = None if curr_query_col_idxs is None else curr_query_col_idxs[batch]

                closest_scores, local_idxs = index.search(
                    vectors[torch.as_tensor(b_rows, device=device)], k=k)
                # map local gallery positions to global storage indexes,
                # keeping faiss's -1 padding for k > gallery size
                closest_idxs = np.where(local_idxs >= 0,
                                        gallery_idxs[np.maximum(local_idxs, 0)], -1)
                closest_scores = self.clear_search_output(closest_scores, b_as_rel)
                closest_idxs = self.clear_search_output(closest_idxs, b_as_rel)

                args = self.process_data_for_metric_func(
                    closest_scores=closest_scores, closest_idxs=closest_idxs,
                    relevants_idxs=b_rels, query_col_idxs=b_cols,
                    scores=scores, k=k)
                if min(np.shape(args[0])[0] if hasattr(args[0], "shape") else len(args[0]), 1) == 0:
                    continue
                curr_metric += len(batch) * float(np.mean(self.metric_func(*args)))
            curr_metric /= max(len(curr_query_row_idxs), 1)
            metric_values.append(curr_metric)
        return float(np.mean(metric_values))
