"""Torchmetrics-style retrieval meters (port of
``torchok_tpu.metrics.representation_torchmetrics``; reference:
torchok/metrics/representation_torchmetrics.py:55-175 — nine Retrieval*
meters feeding k-NN results into torchmetrics; formulas implemented
natively here over (preds, target, indexes) batches).

``preds`` are search scores per ranked position, ``target`` the binary
relevance of each retrieved item, rows are queries.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from torchok_tpu_torch.constructor import METRICS
from torchok_tpu_torch.metrics.index_base_metric import IndexBasedMeter

__all__ = []


def _sorted_target(preds: np.ndarray, target: np.ndarray, descending: bool = True):
    order = np.argsort(-preds if descending else preds, axis=1, kind="stable")
    return np.take_along_axis(target, order, axis=1)


def _hit_rate(preds, target, top_k=None):
    t = _sorted_target(preds, target)
    k = top_k or t.shape[1]
    return (t[:, :k].sum(1) > 0).astype(np.float64)


def _precision(preds, target, top_k=None):
    t = _sorted_target(preds, target)
    k = top_k or t.shape[1]
    return t[:, :k].sum(1) / k


def _recall(preds, target, top_k=None):
    t = _sorted_target(preds, target)
    k = top_k or t.shape[1]
    total = np.maximum(target.sum(1), 1)
    return t[:, :k].sum(1) / total


def _fall_out(preds, target, top_k=None):
    t = _sorted_target(preds, target)
    k = top_k or t.shape[1]
    neg_total = np.maximum((1 - target).sum(1), 1)
    return (1 - t[:, :k]).sum(1) / neg_total


def _map(preds, target, top_k=None):
    t = _sorted_target(preds, target)
    k = top_k or t.shape[1]
    t = t[:, :k]
    cum = np.cumsum(t, axis=1)
    ranks = np.arange(1, k + 1)
    precisions = cum / ranks
    denom = np.maximum(t.sum(1), 1)
    return (precisions * t).sum(1) / denom


def _mrr(preds, target, top_k=None):
    t = _sorted_target(preds, target)
    k = top_k or t.shape[1]
    t = t[:, :k]
    first = np.argmax(t, axis=1)
    has = t.sum(1) > 0
    return np.where(has, 1.0 / (first + 1), 0.0)


def _ndcg(preds, target, top_k=None):
    t = _sorted_target(preds, target).astype(np.float64)
    k = top_k or t.shape[1]
    t = t[:, :k]
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    dcg = (t * discounts).sum(1)
    ideal = -np.sort(-target.astype(np.float64), axis=1)[:, :k]
    idcg = (ideal * discounts).sum(1)
    return np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)


def _r_precision(preds, target, top_k=None):
    t = _sorted_target(preds, target)
    out = []
    for row, trow in zip(t, target):
        r = int(trow.sum())
        out.append(row[:r].sum() / r if r > 0 else 0.0)
    return np.array(out)


_FUNCS = {
    "RetrievalHitRateMeter": _hit_rate,
    "RetrievalPrecisionMeter": _precision,
    "RetrievalRecallMeter": _recall,
    "RetrievalFallOutMeter": _fall_out,
    "RetrievalMAPMeter": _map,
    "RetrievalMRRMeter": _mrr,
    "RetrievalNormalizedDCGMeter": _ndcg,
    "RetrievalRPrecisionMeter": _r_precision,
    "RetrievalPrecisionRecallCurveMeter": _precision,  # scalar surrogate: p@k
}


class TorchMetricBasedMeter(IndexBasedMeter):
    def __init__(self, exact_index: bool, dataset_type: str, metric_distance: str,
                 metric_fn, metric_params: Optional[Dict[str, Any]] = None,
                 k: Optional[int] = None, search_batch_size: Optional[int] = None,
                 normalize_vectors: bool = False, k_as_target_len: bool = False,
                 use_batching_search: bool = True, group_averaging: bool = False,
                 raise_empty_query: bool = True, **kwargs):
        metric_params = dict(metric_params or {})
        top_k = metric_params.get("top_k") or metric_params.get("k")

        def func(preds, target):
            return metric_fn(preds, target, top_k=top_k)

        super().__init__(exact_index=exact_index, dataset_type=dataset_type,
                         metric_distance=metric_distance, metric_func=func,
                         k=k, search_batch_size=search_batch_size,
                         normalize_vectors=normalize_vectors,
                         k_as_target_len=k_as_target_len,
                         use_batching_search=use_batching_search,
                         group_averaging=group_averaging,
                         raise_empty_query=raise_empty_query, **kwargs)

    def process_data_for_metric_func(self, closest_scores, closest_idxs,
                                     relevants_idxs, query_col_idxs, scores, k) -> List:
        preds = np.asarray(closest_scores, np.float64)
        target = np.stack([
            np.isin(closest_idxs[i], np.asarray(relevants_idxs[i], np.int64))
            for i in range(len(closest_idxs))
        ]).astype(np.int64)
        if self.metric_distance == "L2":
            preds = -preds  # smaller distance = better; flip for descending sort
        return [preds, target]


def _register(name: str):
    fn = _FUNCS[name]

    @METRICS.register_class(name=name)
    class _Meter(TorchMetricBasedMeter):  # noqa: N801
        def __init__(self, dataset_type: str,
                     metric_params: Optional[Dict[str, Any]] = None,
                     exact_index: bool = True, metric_distance: str = "IP",
                     k: Optional[int] = None, search_batch_size: Optional[int] = None,
                     normalize_vectors: bool = False, k_as_target_len: bool = False,
                     use_batching_search: bool = True, group_averaging: bool = False,
                     target_averaging: bool = False, raise_empty_query: bool = True,
                     **kwargs):
            super().__init__(exact_index=exact_index, dataset_type=dataset_type,
                             metric_distance=metric_distance, metric_fn=fn,
                             metric_params=metric_params, k=k,
                             search_batch_size=search_batch_size,
                             normalize_vectors=normalize_vectors,
                             k_as_target_len=k_as_target_len,
                             use_batching_search=use_batching_search,
                             group_averaging=group_averaging or target_averaging,
                             raise_empty_query=raise_empty_query, **kwargs)
    _Meter.__name__ = name
    return _Meter


for _name in _FUNCS:
    _register(_name)
