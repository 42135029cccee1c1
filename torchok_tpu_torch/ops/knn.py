"""k-NN indexes on the gallery's device: exact flat and IVF (port of
``torchok_tpu.ops.knn``; it replaces FAISS IndexFlatIP / IndexFlatL2 /
IndexIVFFlat for the retrieval metrics, reference:
torchok/metrics/index_base_metric.py:523-545).

``torchok_tpu`` leaves these products to XLA (no Pallas kernel), so the port
writes them as ``torch.matmul`` plus a top-k on the device that holds the
gallery. Semantics, as faiss IndexFlat/IndexIVFFlat and ``torchok_tpu``:

* IP: scores are inner products, descending.
* L2: scores are SQUARED Euclidean distances, ascending, clamped at 0.
* k > results found: padded with index -1 and the worst possible score.
* Ties go to the lower index, as ``jax.lax.top_k`` sends them
  (:func:`topk_lower_index`): ``torch.topk`` promises no order among equal
  values, and the meters drop the first column as the query's own row.
* Every product is at least as exact as a full f32 one, never TF32
  (``torchok_tpu`` computes in f32; TF32 can reorder near-equal
  neighbours): the matmuls run in f64 and are rounded to f32
  (:func:`dot_t`; on an H100 f64 runs at the rate of f32 without TF32), the
  IVF's candidate scores as f32 products and sums outside the matmul
  units. No TF32 switch of the process is read or set: PyTorch refuses a
  mix of its legacy and new switches once a program has set one.

``SEARCHES`` counts the searches per device type, so a run can show where
its searches ran.
"""
from __future__ import annotations

import collections
import logging
from typing import Optional, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]

# searches per device type ("cuda", "cpu"): one per search() call
SEARCHES: collections.Counter = collections.Counter()


def dot_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` of two f32 matrices, computed in f64 and rounded to f32."""
    return (a.double() @ b.double().T).float()


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 keys that order like the f32 values of ``x`` (-inf lowest)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF) - 1, bits)


def topk_lower_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest f32 values of each row of ``x`` (2-D), in
    descending order, equal values by ascending column: ``jax.lax.top_k``'s
    order. One ``torch.topk`` over int64 keys that pack the value's order
    above the reversed column index."""
    n = x.shape[1]
    if n >= 2 ** 31:
        raise ValueError(f"a row of {n} values does not fit the packed key")
    column = torch.arange(n - 1, -1, -1, device=x.device, dtype=torch.int64)
    key = _ordered_bits(x.float()) * (2 ** 31) + column
    _, idxs = torch.topk(key, k, dim=1, sorted=True)
    return torch.gather(x, 1, idxs), idxs


def _as_tensor(x: Array, device: Optional[torch.device] = None) -> torch.Tensor:
    """f32 tensor of ``x``: on ``device``, else where a tensor already lies
    (a numpy array: the CPU)."""
    return torch.as_tensor(x, device=device).float()


def _search_block(gallery: torch.Tensor, queries: torch.Tensor, k: int,
                  metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    q = queries.float()
    g = gallery.float()
    sim = dot_t(q, g)
    if metric == "IP":
        return topk_lower_index(sim, k)
    # L2: ||q-g||^2 = ||q||^2 + ||g||^2 - 2 q.g ; pick smallest
    d2 = (torch.sum(q * q, dim=1, keepdim=True) + torch.sum(g * g, dim=1)[None, :]
          - 2.0 * sim)
    neg_scores, idxs = topk_lower_index(-d2, k)
    return torch.clamp_min(-neg_scores, 0.0), idxs


class FlatIndex:
    """Exact flat index over a gallery on the gallery tensor's device (the
    CPU for a numpy array). Counterpart of ``torchok_tpu.ops.knn.TpuIndex``.

    Large galleries are searched in ``gallery_block``-row chunks so the
    (query block, G) similarity tile stays bounded; the chunks' top-k merge
    on the device by a stable sort of their concatenation (chunks in index
    order, so ties still go to the lower index)."""

    def __init__(self, vectors: Array, metric: str = "IP", query_block: int = 1024,
                 gallery_block: int = 32768):
        assert metric in ("IP", "L2")
        self.metric = metric
        self.query_block = query_block
        self.gallery_block = gallery_block
        self.gallery = _as_tensor(vectors).contiguous()
        self.device = self.gallery.device
        self.ntotal = self.gallery.shape[0]

    def _search_queries(self, q: torch.Tensor, k_eff: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.ntotal <= self.gallery_block:
            return _search_block(self.gallery, q, k_eff, self.metric)
        parts_s, parts_i = [], []
        for g0 in range(0, self.ntotal, self.gallery_block):
            gal = self.gallery[g0:g0 + self.gallery_block]
            s, ix = _search_block(gal, q, min(k_eff, gal.shape[0]), self.metric)
            parts_s.append(s)
            parts_i.append(ix + g0)
        scores = torch.cat(parts_s, dim=1)
        idxs = torch.cat(parts_i, dim=1)
        key = -scores if self.metric == "IP" else scores
        order = torch.sort(key, dim=1, stable=True).indices[:, :k_eff]
        return torch.gather(scores, 1, order), torch.gather(idxs, 1, order)

    def search(self, queries: Array, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (n, k) f32, indexes (n, k) int64) on the host. When
        k > ntotal the extra columns hold index -1 and the worst score."""
        SEARCHES[self.device.type] += 1
        k_eff = min(k, self.ntotal)
        queries = _as_tensor(queries, self.device)
        n = queries.shape[0]
        pad_score = -np.inf if self.metric == "IP" else np.inf
        out_scores = torch.full((n, k), pad_score, dtype=torch.float32, device=self.device)
        out_idxs = torch.full((n, k), -1, dtype=torch.int64, device=self.device)
        for i in range(0, n, self.query_block):
            s, ix = self._search_queries(queries[i:i + self.query_block], k_eff)
            out_scores[i:i + self.query_block, :k_eff] = s
            out_idxs[i:i + self.query_block, :k_eff] = ix
        return out_scores.cpu().numpy(), out_idxs.cpu().numpy()


# ---------------------------------------------------------------------------
# IVF (inverted file) index: faiss.IndexIVFFlat's counterpart
# ---------------------------------------------------------------------------
def _kmeans_assign_accumulate(x: torch.Tensor, cent: torch.Tensor, nlist: int, metric: str):
    """One gallery chunk of a Lloyd iteration: assign rows to their nearest
    centroid, return (per-cell sums, per-cell counts, assignments); the cell
    sums are the product onehot(assign).T @ x."""
    x32 = x.float()
    sim = dot_t(x32, cent)  # (n, nlist)
    if metric == "IP":
        assign = torch.argmax(sim, dim=1)
    else:
        d2 = torch.sum(cent * cent, dim=1)[None, :] - 2.0 * sim
        assign = torch.argmin(d2, dim=1)  # ||x||^2 constant per row
    onehot = torch.nn.functional.one_hot(assign, nlist).float()
    return dot_t(onehot.T, x32.T), onehot.sum(0), assign


def kmeans(vectors: Array, nlist: int, n_iter: int = 10, metric: str = "IP",
           chunk: int = 16384, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means in chunks on the vectors' device: (centroids (nlist,
    D), assignment (n,)), both there.

    Assignment uses the index metric (faiss quantizer semantics: IP cells
    by max inner product, L2 by min distance); the update is the cell mean
    either way. Empty cells keep their previous centroid. The initial
    centroids are the rows ``numpy.random.default_rng(seed)`` picks, as in
    ``torchok_tpu``; the final assignment is made against the trained
    centroids."""
    x = _as_tensor(vectors)
    device = x.device
    n, d = x.shape
    rng = np.random.default_rng(seed)
    picks = torch.as_tensor(rng.choice(n, size=nlist, replace=False), device=device)
    cent = x[picks]
    for _ in range(n_iter):
        sums = torch.zeros((nlist, d), dtype=torch.float32, device=device)
        counts = torch.zeros((nlist,), dtype=torch.float32, device=device)
        for i in range(0, n, chunk):
            s, c, _ = _kmeans_assign_accumulate(x[i:i + chunk], cent, nlist, metric)
            sums, counts = sums + s, counts + c
        cent = torch.where(counts[:, None] > 0, sums / counts[:, None], cent)
    parts = [_kmeans_assign_accumulate(x[i:i + chunk], cent, nlist, metric)[2]
             for i in range(0, n, chunk)]
    return cent, torch.cat(parts)


def _ivf_search_block(gallery, cent, members, queries, k: int, nprobe: int, metric: str):
    """Probed search: the top ``nprobe`` cells per query, their padded
    member lists gathered, exact distances on the candidates."""
    q = queries.float()                                        # (B, D)
    csim = dot_t(q, cent)                                      # (B, nlist)
    if metric == "IP":
        _, cells = topk_lower_index(csim, nprobe)
    else:
        cd2 = torch.sum(cent * cent, dim=1)[None, :] - 2.0 * csim
        _, cells = topk_lower_index(-cd2, nprobe)
    cand = members[cells].reshape(q.shape[0], -1)              # (B, M), -1 pad
    valid = cand >= 0
    gvec = gallery[torch.clamp_min(cand, 0)]                   # (B, M, D)
    sim = torch.sum(gvec * q[:, None, :], dim=-1)
    neg_inf = torch.tensor(-float("inf"), device=q.device)
    if metric == "IP":
        scores, pos = topk_lower_index(torch.where(valid, sim, neg_inf), k)
    else:
        d2 = (torch.sum(q * q, dim=1, keepdim=True) + torch.sum(gvec * gvec, dim=-1)
              - 2.0 * sim)
        negs, pos = topk_lower_index(torch.where(valid, -d2, neg_inf), k)
        scores = torch.clamp_min(-negs, 0.0)
    idxs = torch.gather(cand, 1, pos)
    found = torch.gather(valid, 1, pos)
    pad = -float("inf") if metric == "IP" else float("inf")
    return (torch.where(found, scores, torch.full_like(scores, pad)),
            torch.where(found, idxs, torch.full_like(idxs, -1)))


class IvfIndex:
    """faiss.IndexIVFFlat's counterpart, trained and searched on the
    gallery's device (``torchok_tpu.ops.knn.IvfIndex``).

    The coarse quantizer is chunked k-means; each cell's member list is
    padded to the largest cell (capped at ``cell_cap_factor`` times the mean,
    at least 64; members past the cap are dropped with a warning), so the
    probed search is one gather, a batched product and a top-k per query
    block. Results are approximate as faiss's are: only the probed cells'
    members are scored; misses hold index -1 and the worst score.
    ``nprobe`` defaults to ``max(8, round(nlist / 224))``, not faiss's 1."""

    # per-search-block candidate-gather budget: bounds the (B, nprobe*cap, D)
    # f32 gather that scores probed members
    _GATHER_BUDGET_BYTES = 256 * 1024 * 1024

    def __init__(self, vectors: Array, metric: str = "IP", nlist: Optional[int] = None,
                 nprobe: Optional[int] = None, n_iter: int = 10, query_block: int = 256,
                 seed: int = 0, cell_cap_factor: float = 8.0):
        assert metric in ("IP", "L2")
        self.metric = metric
        self.gallery = _as_tensor(vectors).contiguous()
        self.device = self.gallery.device
        n = self.gallery.shape[0]
        # reference formula: nlist = 4 * ceil(sqrt(n))
        # (torchok/metrics/index_base_metric.py:539)
        self.nlist = int(nlist) if nlist else max(1, 4 * int(np.ceil(n ** 0.5)))
        self.nlist = min(self.nlist, n)
        if nprobe is None:
            # a constant probed fraction: 8 of 1792 cells at 200k rows
            nprobe = max(8, round(self.nlist / 224))
        self.nprobe = max(1, min(nprobe, self.nlist))
        self.query_block = query_block
        self.ntotal = n
        self.centroids, assign_t = kmeans(self.gallery, self.nlist, n_iter=n_iter,
                                          metric=metric, seed=seed)
        assign = assign_t.cpu().numpy()
        counts = np.bincount(assign, minlength=self.nlist)
        cap = max(1, int(counts.max()))
        cap_limit = max(64, int(np.ceil(cell_cap_factor * n / self.nlist)))
        if cap > cap_limit:
            dropped = int(np.sum(np.maximum(counts - cap_limit, 0)))
            logging.getLogger(__name__).warning(
                "IvfIndex: skewed clustering (max cell %d > cap %d); "
                "truncating %d of %d members (%.2f%%) — recall on those "
                "rows is lost; consider exact search or more k-means iters",
                cap, cap_limit, dropped, n, 100.0 * dropped / n)
            cap = cap_limit
        # each cell's rows in ascending order, the first ``cap`` of them
        rows = np.argsort(assign, kind="stable")
        cells = assign[rows]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(n) - starts[cells]
        keep = slot < cap
        members = np.full((self.nlist, cap), -1, np.int64)
        members[cells[keep], slot[keep]] = rows[keep]
        self.members = torch.as_tensor(members, device=self.device)

    def search(self, queries: Array, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (n, k) f32, indexes (n, k) int64) on the host."""
        SEARCHES[self.device.type] += 1
        queries = _as_tensor(queries, self.device)
        n, d = queries.shape
        cap = self.members.shape[1]
        k_eff = min(k, self.nprobe * cap)
        pad_score = -np.inf if self.metric == "IP" else np.inf
        out_scores = torch.full((n, k), pad_score, dtype=torch.float32, device=self.device)
        out_idxs = torch.full((n, k), -1, dtype=torch.int64, device=self.device)
        # keep the (B, nprobe*cap, D) candidate gather under budget
        block = max(1, min(self.query_block,
                           self._GATHER_BUDGET_BYTES // max(1, self.nprobe * cap * d * 4)))
        for i in range(0, n, block):
            s, ix = _ivf_search_block(self.gallery, self.centroids, self.members,
                                      queries[i:i + block], k_eff, self.nprobe, self.metric)
            out_scores[i:i + block, :k_eff] = s
            out_idxs[i:i + block, :k_eff] = ix
        return out_scores.cpu().numpy(), out_idxs.cpu().numpy()
