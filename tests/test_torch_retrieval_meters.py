"""The port's retrieval engine against ``torchok_tpu``: the 14 index-based
meters, the flat and IVF indexes and k-means, on the CPU.

* The reference's committed answer tables (``test_retrieval_answer_tables.py``,
  copied here as fixture data) name four meters: the port reproduces every
  entry to 1e-6 absolute. On the same fixture every one of the 14 meters
  equals ``torchok_tpu``'s to 1e-9, at k = 1 to 6.
* Seeded random vectors in both dataset types, with group averaging,
  ``k_as_target_len``, IP and L2, normalised or not, batched search and
  several ``update`` chunks: each meter equals ``torchok_tpu``'s to 1e-9.
* ``FlatIndex``, ``kmeans`` and ``IvfIndex`` against ``TpuIndex``, ``kmeans``
  and ``IvfIndex``: identical indexes (ties to the lower index, padding past
  ``ntotal``, chunked galleries); scores to 1e-5 absolute and 1e-6
  relative (f32 products summed in another order; L2 scores reach 40),
  centroids to 1e-6.
"""
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import METRICS as JAX_METRICS
from torchok_tpu.ops import knn as jax_knn
from torchok_tpu_torch.constructor import METRICS
from torchok_tpu_torch.ops import knn

RANX = ["HitAtKMeter", "PrecisionAtKMeter", "RecallAtKMeter",
        "MeanAveragePrecisionAtKMeter", "NDCGAtKMeter"]
TORCHMETRICS = ["RetrievalHitRateMeter", "RetrievalPrecisionMeter", "RetrievalRecallMeter",
                "RetrievalFallOutMeter", "RetrievalMAPMeter", "RetrievalMRRMeter",
                "RetrievalNormalizedDCGMeter", "RetrievalRPrecisionMeter",
                "RetrievalPrecisionRecallCurveMeter"]
METERS = RANX + TORCHMETRICS

# --- the reference's answer tables (tests/test_retrieval_answer_tables.py) ---
QUERIES = [[0.3281, 0.3934, 0.3079, 0.3238],
           [0.0344, 0.8396, 0.1414, 0.7388],
           [0.5870, 0.1184, 0.1509, 0.3035]]
DATABASE = [[0.0256, 0.2660, 0.5239, 0.0042],
            [0.0513, 0.0375, 0.0321, 0.8175],
            [0.8611, 0.8352, 0.3209, 0.8839],
            [0.8433, 0.3853, 0.3332, 0.5728],
            [0.6903, 0.2962, 0.7524, 0.0826],
            [0.1255, 0.0154, 0.8745, 0.2216]]
VECTORS = np.array([QUERIES[0], DATABASE[4], QUERIES[1], QUERIES[2], DATABASE[0],
                    DATABASE[2], DATABASE[3], DATABASE[5], DATABASE[1]], np.float32)
TARGETS = np.array([0, 0, 1, 2, 1, 2, 2, 2, 1])
GROUP_LABELS = np.array([0, 0, 0, 1, 1, 1, 1, 0, 1])
QUERIES_IDX = np.array([0, -1, 1, 2, -1, -1, -1, -1, -1])
SCORES = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 0], [0, 0, 0], [0, 2, 0],
                   [0, 0, 1], [0, 0, 2], [0, 0, 4], [0, 4, 0]], np.float32)
SCORES_QUERY_AS_RELEVANT = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 3], [0, 1, 0], [0, 2, 0],
                                     [0, 0, 1], [0, 0, 2], [0, 0, 4], [0, 4, 0]], np.float32)
MAX_K = 6
TABLES = {
    "classification": {
        "PrecisionAtKMeter": [4 / 9, 7 / 18, 10 / 27, 11 / 36, 13 / 45, 15 / 54],
        "RecallAtKMeter": [13 / 54, 19 / 54, 5 / 9, 16 / 27, 37 / 54, 7 / 9],
        "MeanAveragePrecisionAtKMeter": [13 / 54, 1 / 3, 67 / 162, 137 / 324, 727 / 1620,
                                         787 / 1620],
    },
    "representation": {
        "PrecisionAtKMeter": [1 / 3, 1 / 3, 4 / 9, 1 / 3, 1 / 3, 1 / 3],
        "RecallAtKMeter": [1 / 9, 2 / 9, 13 / 18, 13 / 18, 5 / 6, 1.0],
        "MeanAveragePrecisionAtKMeter": [1 / 9, 2 / 9, 7 / 18, 7 / 18, 41 / 90, 46 / 90],
        "NDCGAtKMeter": [0.08333333, 0.14328645, 0.42421699, 0.42421699, 0.51373735,
                         0.55886806],
    },
    "query_as_relevant": {
        "PrecisionAtKMeter": [1 / 3, 1 / 2, 4 / 9, 5 / 12, 7 / 15, 4 / 9],
        "RecallAtKMeter": [1 / 12, 5 / 18, 11 / 18, 13 / 18, 11 / 12, 1.0],
    },
}
# each table's run: dataset type, scores, params (as the reference's tests)
FIXTURES = {
    "classification": ("classification", None, {"normalize_vectors": True}),
    "representation": ("representation", SCORES, {}),
    "query_as_relevant": ("representation", SCORES_QUERY_AS_RELEVANT,
                          {"normalize_vectors": True}),
}


def _feed(meter, state, dataset_type, vectors, targets, query_idxs, scores, groups, chunks,
          as_tensor):
    for b in np.array_split(np.arange(len(vectors)), chunks):
        wrap = (lambda a: torch.as_tensor(a)) if as_tensor else (lambda a: a)
        if dataset_type == "classification":
            state = meter.update(state, vectors=wrap(vectors[b]), group_labels=wrap(targets[b]))
        else:
            state = meter.update(state, vectors=wrap(vectors[b]),
                                 query_idxs=wrap(query_idxs[b]), scores=wrap(scores[b]),
                                 group_labels=wrap(groups[b]))
    return state


def _both(name, dataset_type, vectors, targets=None, query_idxs=None, scores=None,
          groups=None, chunks=3, **params):
    """(port value, torchok_tpu value) of one meter on the same inputs."""
    port = METRICS.get(name)(dataset_type=dataset_type, **params)
    ref = JAX_METRICS.get(name)(dataset_type=dataset_type, **params)
    args = (dataset_type, vectors, targets, query_idxs, scores, groups, chunks)
    got = port.compute(_feed(port, port.empty_state("cpu"), *args, as_tensor=True))
    want = ref.compute(_feed(ref, ref.empty_state(), *args, as_tensor=False))
    return got, want


def _table_run(name, fixture, k):
    dataset_type, scores, params = FIXTURES[fixture]
    return _both(name, dataset_type, VECTORS, TARGETS, QUERIES_IDX, scores, GROUP_LABELS,
                 k=k, **params)


@pytest.mark.parametrize("fixture,meter", [(f, m) for f, t in TABLES.items() for m in t])
def test_the_reference_answer_tables(fixture, meter):
    for k in range(1, MAX_K + 1):
        got, _ = _table_run(meter, fixture, k)
        assert got == pytest.approx(TABLES[fixture][meter][k - 1], abs=1e-6), k


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
@pytest.mark.parametrize("meter", METERS)
def test_every_meter_on_the_table_fixture_equals_torchok_tpu(meter, fixture):
    for k in range(1, MAX_K + 1):
        got, want = _table_run(meter, fixture, k)
        assert got == pytest.approx(want, abs=1e-9), k


def _classification_data(seed, n=60, n_classes=6, d=8):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.integers(0, n_classes, n)


def _representation_data(seed, n=48, n_queries=8, d=8):
    """Rows 0..7 are queries (query_idxs 0..7); graded relevance in
    ``scores``, every query with at least one relevant row, some queries
    relevant to others (so they stay in the gallery)."""
    rng = np.random.default_rng(seed)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    query_idxs = np.full(n, -1)
    query_idxs[:n_queries] = np.arange(n_queries)
    scores = np.where(rng.random((n, n_queries)) < 0.2,
                      rng.integers(1, 5, (n, n_queries)), 0).astype(np.float32)
    scores[n_queries + np.arange(n_queries), np.arange(n_queries)] = 3.0
    scores[:n_queries] *= rng.random((n_queries, 1)) < 0.5
    groups = rng.integers(0, 3, n)
    return vectors, query_idxs, scores, groups


CONFIGS = {
    "cls_ip_normalised_batched": ("classification", dict(k=3, normalize_vectors=True,
                                                         search_batch_size=7)),
    "cls_l2_group_averaging": ("classification", dict(k=2, metric_distance="L2",
                                                      group_averaging=True)),
    "cls_k_as_target_len": ("classification", dict(k_as_target_len=True,
                                                   group_averaging=True)),
    "cls_unbatched": ("classification", dict(k=4, use_batching_search=False)),
    "rep_ip_batched": ("representation", dict(k=4, search_batch_size=3)),
    "rep_l2_normalised_groups": ("representation", dict(k=3, metric_distance="L2",
                                                        normalize_vectors=True,
                                                        group_averaging=True)),
    "rep_k_as_target_len": ("representation", dict(k_as_target_len=True)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("meter", METERS)
def test_every_meter_on_random_vectors_equals_torchok_tpu(meter, config):
    dataset_type, params = CONFIGS[config]
    if dataset_type == "classification":
        vectors, targets = _classification_data(5)
        got, want = _both(meter, dataset_type, vectors, targets, chunks=4, **params)
    else:
        vectors, query_idxs, scores, groups = _representation_data(6)
        got, want = _both(meter, dataset_type, vectors, None, query_idxs, scores, groups,
                          chunks=5, **params)
    assert np.isfinite(got)
    assert got == pytest.approx(want, abs=1e-9)


@pytest.mark.parametrize("meter", TORCHMETRICS)
@pytest.mark.parametrize("dataset_type", ["classification", "representation"])
def test_torchmetrics_top_k_and_target_averaging_equal_torchok_tpu(meter, dataset_type):
    params = dict(k=5, metric_params={"top_k": 2}, target_averaging=True)
    if dataset_type == "classification":
        vectors, targets = _classification_data(7)
        got, want = _both(meter, dataset_type, vectors, targets, **params)
    else:
        vectors, query_idxs, scores, groups = _representation_data(8)
        got, want = _both(meter, dataset_type, vectors, None, query_idxs, scores, groups,
                          **params)
    assert got == pytest.approx(want, abs=1e-9)


def test_an_empty_query_raises_as_in_torchok_tpu():
    vectors, targets = _classification_data(9, n=10, n_classes=10)
    targets[:] = np.arange(10)  # every class a single element
    for registry in (METRICS, JAX_METRICS):
        meter = registry.get("HitAtKMeter")(dataset_type="classification", k=1)
        state = meter.empty_state("cpu") if registry is METRICS else meter.empty_state()
        state = meter.update(state, vectors=vectors, group_labels=targets)
        with pytest.raises(ValueError, match="single element"):
            meter.compute(state)
    got, want = _both("HitAtKMeter", "classification", vectors, targets, k=1,
                      raise_empty_query=False)
    assert got == want == 0.0


def test_the_meter_searches_where_its_state_lives():
    vectors, targets = _classification_data(10)
    meter = METRICS.get("RecallAtKMeter")(dataset_type="classification", k=2,
                                          search_batch_size=16)
    state = meter.update(meter.empty_state("cpu"), vectors=torch.as_tensor(vectors),
                         group_labels=torch.as_tensor(targets))
    assert state["vectors"][0].device.type == "cpu"
    knn.SEARCHES.clear()
    meter.compute(state)
    assert knn.SEARCHES == {"cpu": 4}  # 60 queries in batches of 16


# ----------------------------- the indexes ---------------------------------
@pytest.mark.parametrize("metric", ["IP", "L2"])
@pytest.mark.parametrize("gallery_block", [32768, 17])
@pytest.mark.parametrize("k", [7, 120])
def test_flat_index_equals_tpu_index(metric, gallery_block, k):
    """k = 120 > ntotal = 101: the extra columns hold -1 and the worst score."""
    rng = np.random.default_rng(2)
    gallery = rng.normal(size=(101, 16)).astype(np.float32)
    queries = rng.normal(size=(9, 16)).astype(np.float32)
    want_s, want_i = jax_knn.TpuIndex(gallery, metric, gallery_block=gallery_block).search(
        queries, k)
    got_s, got_i = knn.FlatIndex(torch.as_tensor(gallery), metric, query_block=4,
                                 gallery_block=gallery_block).search(torch.as_tensor(queries),
                                                                     k)
    assert got_s.dtype == np.float32 and got_i.dtype == np.int64
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(np.isinf(got_s), np.isinf(want_s))
    real = np.isfinite(want_s)
    np.testing.assert_allclose(got_s[real], want_s[real], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("metric", ["IP", "L2"])
@pytest.mark.parametrize("gallery_block", [32768, 3])
def test_duplicate_vectors_tie_to_the_lower_index(metric, gallery_block):
    """Five vectors, each four times: every query's ties come back in
    ascending index order, across chunk boundaries too (torch.topk alone
    promises no order among equal values)."""
    rng = np.random.default_rng(3)
    gallery = np.repeat(rng.normal(size=(5, 8)).astype(np.float32), 4, axis=0)
    want = jax_knn.TpuIndex(gallery, metric, gallery_block=gallery_block).search(gallery, 6)[1]
    got = knn.FlatIndex(gallery, metric, gallery_block=gallery_block).search(gallery, 6)[1]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[::4, :4], np.arange(20).reshape(5, 4)[:, :4])


def test_topk_lower_index_is_jax_top_k_on_many_ties():
    import jax
    x = np.random.default_rng(4).integers(-3, 4, (16, 40)).astype(np.float32)
    x[0, :5] = -np.inf
    want_v, want_i = jax.lax.top_k(x, 11)
    got_v, got_i = knn.topk_lower_index(torch.as_tensor(x), 11)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _clustered(rng, n_clusters, per_cluster, d, spread=0.05):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    pts = np.repeat(centers, per_cluster, axis=0)
    return (pts + rng.normal(scale=spread, size=pts.shape)).astype(np.float32)


@pytest.mark.parametrize("metric", ["IP", "L2"])
def test_kmeans_equals_torchok_tpu(metric):
    pts = _clustered(np.random.default_rng(12), 8, 32, 16, spread=0.01)
    want_c, want_a = jax_knn.kmeans(pts, 8, n_iter=15, metric=metric, chunk=100, seed=1)
    got_c, got_a = knn.kmeans(torch.as_tensor(pts), 8, n_iter=15, metric=metric, chunk=100,
                              seed=1)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-6)


@pytest.mark.parametrize("metric", ["IP", "L2"])
def test_ivf_index_equals_torchok_tpu(metric):
    rng = np.random.default_rng(10)
    gallery = _clustered(rng, 32, 64, 32)
    queries = gallery[rng.choice(len(gallery), size=128, replace=False)]
    want = jax_knn.IvfIndex(gallery, metric=metric, nlist=32, nprobe=8, seed=0)
    got = knn.IvfIndex(torch.as_tensor(gallery), metric=metric, nlist=32, nprobe=8, seed=0)
    np.testing.assert_array_equal(got.members.numpy(), np.asarray(want.members))
    want_s, want_i = want.search(queries, 5)
    got_s, got_i = got.search(queries, 5)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-5)
    exact = knn.FlatIndex(gallery, metric).search(queries, 1)[1]
    assert np.mean(got_i[:, 0] == exact[:, 0]) >= 0.95


def test_ivf_padding_cap_and_nprobe_default_follow_torchok_tpu():
    rng = np.random.default_rng(11)
    gallery = _clustered(rng, 4, 8, 8)
    got = knn.IvfIndex(gallery, metric="IP", nlist=4, nprobe=1, seed=0)
    want = jax_knn.IvfIndex(gallery, metric="IP", nlist=4, nprobe=1, seed=0)
    got_s, got_i = got.search(gallery[:3], 31)
    want_s, want_i = want.search(gallery[:3], 31)
    np.testing.assert_array_equal(got_i, want_i)
    assert np.all(got_i[:, -1] == -1) and np.all(np.isneginf(got_s[:, -1]))
    # a collapsed gallery: one giant cell truncated at the cap (which cell
    # takes which near-duplicate hangs on f32 roundings in both packages)
    base = rng.normal(size=(1, 16)).astype(np.float32)
    collapsed = base + rng.normal(scale=1e-4, size=(512, 16)).astype(np.float32)
    got = knn.IvfIndex(collapsed, metric="IP", nlist=16, nprobe=2, cell_cap_factor=2.0)
    assert got.members.shape == (16, 64)
    assert np.all(got.search(collapsed[:8], 4)[1][:, 0] >= 0)
    wide = rng.normal(size=(4000, 8)).astype(np.float32)
    for nlist, nprobe, expect in ((64, None, 8), (3584, None, 16), (3584, 4, 4)):
        assert knn.IvfIndex(wide, nlist=nlist, nprobe=nprobe, n_iter=1).nprobe == expect


def test_a_meter_past_ivf_threshold_takes_the_ivf_as_torchok_tpu_does():
    rng = np.random.default_rng(13)
    vectors = _clustered(rng, 16, 16, 16, spread=0.02)
    labels = np.repeat(np.arange(16), 16)
    params = dict(exact_index=False, k=1, normalize_vectors=True, ivf_threshold=64,
                  ivf_nlist=16, ivf_nprobe=4)
    got, want = _both("HitAtKMeter", "classification", vectors, labels, **params)
    assert got == pytest.approx(want, abs=1e-9) and got >= 0.95
