"""Retrieval meters (port of ``torchok_tpu.metrics.representation``;
reference: torchok/metrics/representation_ranx.py:54-111, ranx-backed; here
over the vectorized ranking formulas of metrics/ranking.py and the index of
ops/knn.py on the vectors' device)."""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from torchok_tpu_torch.constructor import METRICS
from torchok_tpu_torch.metrics import ranking
from torchok_tpu_torch.metrics.index_base_metric import IndexBasedMeter

__all__ = []


class RanxBasedMeter(IndexBasedMeter):
    def process_data_for_metric_func(self, closest_scores, closest_idxs,
                                     relevants_idxs, query_col_idxs, scores, k) -> List:
        searched = [np.stack((closest_idxs[i], np.ones(len(closest_idxs[i]))), axis=1)
                    for i in range(len(closest_idxs))]
        if query_col_idxs is None:
            rels = [np.stack((np.asarray(r, np.int64),
                              np.ones(len(r), dtype=np.float64)), axis=1)
                    for r in relevants_idxs]
        else:
            rels = [np.stack((np.asarray(r, np.int64),
                              scores[np.asarray(r, np.int64), c]), axis=1)
                    for r, c in zip(relevants_idxs, query_col_idxs)]
        return [rels, searched, k - 1]


def _register(name: str, func: Callable):
    @METRICS.register_class(name=name)
    class _Meter(RanxBasedMeter):  # noqa: N801
        def __init__(self, dataset_type: str, exact_index: bool = True,
                     metric_distance: str = "IP", k: Optional[int] = None,
                     search_batch_size: Optional[int] = None,
                     normalize_vectors: bool = False, group_averaging: bool = False,
                     k_as_target_len: bool = False, use_batching_search: bool = True,
                     raise_empty_query: bool = True, **kwargs):
            super().__init__(exact_index=exact_index, dataset_type=dataset_type,
                             metric_distance=metric_distance, metric_func=func,
                             k=k, search_batch_size=search_batch_size,
                             normalize_vectors=normalize_vectors,
                             group_averaging=group_averaging,
                             k_as_target_len=k_as_target_len,
                             use_batching_search=use_batching_search,
                             raise_empty_query=raise_empty_query, **kwargs)
    _Meter.__name__ = name
    return _Meter


HitAtKMeter = _register("HitAtKMeter", ranking.hit_rate)
PrecisionAtKMeter = _register("PrecisionAtKMeter", ranking.precision)
RecallAtKMeter = _register("RecallAtKMeter", ranking.recall)
MeanAveragePrecisionAtKMeter = _register("MeanAveragePrecisionAtKMeter",
                                         ranking.average_precision)
NDCGAtKMeter = _register("NDCGAtKMeter", ranking.ndcg)
