"""Vectorized ranking formulas (port of ``torchok_tpu.metrics.ranking``, numpy
only; ranx equivalents, reference: torchok/metrics/representation_ranx.py
uses ranx's numba kernels).

Each function takes qrels/run in the ranx convention:
* ``qrels``: per query, array (R, 2) of [doc_id, relevance>0] rows,
* ``run``: per query, array (K, 2) of [doc_id, score] rows ordered by rank,
* ``k``: cutoff (0 = full run length),
and returns a per-query numpy array of metric values.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _hits_at_k(qrel: np.ndarray, run: np.ndarray, k: int) -> np.ndarray:
    k = k if k else len(run)
    run_ids = run[:k, 0].astype(np.int64)
    rel_ids = set(qrel[:, 0].astype(np.int64).tolist())
    return np.array([1.0 if d in rel_ids else 0.0 for d in run_ids])


def hit_rate(qrels: Sequence[np.ndarray], run: Sequence[np.ndarray], k: int = 0) -> np.ndarray:
    return np.array([
        1.0 if _hits_at_k(q, r, k).sum() > 0 else 0.0 for q, r in zip(qrels, run)
    ])


def precision(qrels: Sequence[np.ndarray], run: Sequence[np.ndarray], k: int = 0) -> np.ndarray:
    out = []
    for q, r in zip(qrels, run):
        kk = k if k else len(r)
        out.append(_hits_at_k(q, r, kk).sum() / kk)
    return np.array(out)


def recall(qrels: Sequence[np.ndarray], run: Sequence[np.ndarray], k: int = 0) -> np.ndarray:
    out = []
    for q, r in zip(qrels, run):
        out.append(_hits_at_k(q, r, k).sum() / max(len(q), 1))
    return np.array(out)


def average_precision(qrels: Sequence[np.ndarray], run: Sequence[np.ndarray],
                      k: int = 0) -> np.ndarray:
    out = []
    for q, r in zip(qrels, run):
        hits = _hits_at_k(q, r, k)
        if hits.size == 0:
            out.append(0.0)
            continue
        precisions = np.cumsum(hits) / np.arange(1, hits.size + 1)
        out.append(float(np.sum(precisions * hits) / max(len(q), 1)))
    return np.array(out)


def ndcg(qrels: Sequence[np.ndarray], run: Sequence[np.ndarray], k: int = 0) -> np.ndarray:
    """Jarvelin NDCG: rel / log2(rank + 1)."""
    out = []
    for q, r in zip(qrels, run):
        kk = k if k else len(r)
        rel_map = {int(d): float(s) for d, s in zip(q[:, 0], q[:, 1])}
        gains = np.array([rel_map.get(int(d), 0.0) for d in r[:kk, 0]])
        discounts = 1.0 / np.log2(np.arange(2, gains.size + 2))
        dcg = float(np.sum(gains * discounts))
        ideal = np.sort(q[:, 1].astype(np.float64))[::-1][:kk]
        idcg = float(np.sum(ideal / np.log2(np.arange(2, ideal.size + 2))))
        out.append(dcg / idcg if idcg > 0 else 0.0)
    return np.array(out)
