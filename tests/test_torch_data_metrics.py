"""The port's data pipeline and metrics against ``torchok_tpu``'s on the same
numpy inputs: SyntheticClassificationDataset, DataLoader, Normalize and
ToTensorV2 (host and device paths), Accuracy and F1Score."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
from torchok_tpu.constructor import METRICS as JAX_METRICS
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu.data.datasets.examples.synthetic import \
    SyntheticClassificationDataset as JaxSynthetic
from torchok_tpu.data.loader import DataLoader as JaxLoader
from torchok_tpu_torch.constructor import METRICS, TRANSFORMS
from torchok_tpu_torch.data.datasets.examples.synthetic import SyntheticClassificationDataset
from torchok_tpu_torch.data.loader import DataLoader

METRIC_CASES = [
    ("Accuracy", dict(task="multiclass", num_classes=5)),
    ("Accuracy", dict(task="multiclass", num_classes=5, average="macro")),
    ("Accuracy", dict(task="multiclass", num_classes=5, average="none")),
    ("Accuracy", dict(task="multiclass")),
    ("Accuracy", dict(task="binary")),
    ("Accuracy", dict(task="multilabel", num_labels=4)),
    ("F1Score", dict(task="multiclass", num_classes=5)),
    ("F1Score", dict(task="multiclass", num_classes=5, average="weighted")),
    ("F1Score", dict(task="multiclass", num_classes=5, average="macro", ignore_index=0)),
    ("F1Score", dict(task="binary")),
    ("F1Score", dict(task="multilabel", num_labels=4, average="macro")),
]


def _metric_batches(params, seed):
    rng = np.random.default_rng(seed)
    task = params["task"]
    out = []
    for _ in range(2):
        if task == "multiclass":
            preds = rng.normal(size=(16, 5)).astype(np.float32)
            target = rng.integers(0, 5, size=16)
        elif task == "binary":
            preds = rng.normal(size=(16,)).astype(np.float32)
            target = rng.integers(0, 2, size=16)
        else:
            preds = rng.uniform(size=(16, 4)).astype(np.float32)
            target = rng.integers(0, 2, size=(16, 4))
        out.append((preds, target))
    return out


@pytest.mark.parametrize("name,params", METRIC_CASES,
                         ids=[f"{n}-{'-'.join(map(str, p.values()))}" for n, p in METRIC_CASES])
def test_metric_matches_jax(name, params):
    ref_metric = JAX_METRICS.get(name)(**params)
    metric = METRICS.get(name)(**params)
    ref_state, state = ref_metric.empty_state(), metric.empty_state("cpu")
    for preds, target in _metric_batches(params, seed=len(params)):
        ref_state = ref_metric.update(ref_state, preds=jnp.asarray(preds),
                                      target=jnp.asarray(target))
        state = metric.update(state, preds=torch.from_numpy(preds),
                              target=torch.from_numpy(target))
    np.testing.assert_array_equal(state["stats"].numpy(), np.asarray(ref_state["stats"]))
    got, ref = metric.compute(state), ref_metric.compute(ref_state)
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        got, ref = list(got.values()), list(ref.values())
    # the same f32 counts; a macro/weighted mean may sum in another order
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _pipeline(registry):
    return [registry.get("Normalize")(), registry.get("ToTensorV2")()]


def test_normalize_totensor_host_path_matches_jax():
    image = np.random.default_rng(0).integers(0, 256, size=(6, 5, 3), dtype=np.uint8)
    ref, got = {"image": image}, {"image": image}
    for t in _pipeline(JAX_TRANSFORMS):
        ref = t(**ref)
    for t in _pipeline(TRANSFORMS):
        got = t(**got)
    # torchok_tpu keeps HWC (its ToTensorV2 is a cast); the port goes to CHW
    np.testing.assert_array_equal(got["image"], np.asarray(ref["image"]).transpose(2, 0, 1))


def test_normalize_totensor_device_path_matches_jax():
    batch = np.random.default_rng(1).integers(0, 256, size=(2, 6, 5, 3), dtype=np.uint8)
    ref = {"image": jnp.asarray(batch)}
    for t in _pipeline(JAX_TRANSFORMS):
        ref = t.apply_batch(ref, None)
    got = {"image": torch.from_numpy(batch)}
    for t in _pipeline(TRANSFORMS):
        got = t.apply_batch(got, None)
    assert got["image"].dtype == torch.float32 and got["image"].shape == (2, 3, 6, 5)
    np.testing.assert_array_equal(got["image"].permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref["image"]))


def test_synthetic_dataset_and_loader_match_jax():
    kwargs = dict(num_samples=10, image_size=(8, 8), num_classes=4, seed=5)
    ref_ds = JaxSynthetic(transform=_pipeline(JAX_TRANSFORMS), **kwargs)
    ds = SyntheticClassificationDataset(transform=_pipeline(TRANSFORMS), **kwargs)
    np.testing.assert_array_equal(ds.images, ref_ds.images)
    np.testing.assert_array_equal(ds.targets, ref_ds.targets)
    assert ds.host_pipeline_empty and len(ds.device_pipeline.transforms) == 2
    assert ds[3]["image"].dtype == np.uint8 and ds[3]["target"] == ds.targets[3]

    ref_loader = JaxLoader(ref_ds, batch_size=4, shuffle=True, num_workers=0, seed=9)
    sync = DataLoader(ds, batch_size=4, shuffle=True, num_workers=0, seed=9)
    threaded = DataLoader(ds, batch_size=4, shuffle=True, num_workers=2, seed=9)
    ref_batches, sync_batches = list(ref_loader), list(sync)
    assert len(sync) == len(sync_batches) == len(ref_batches) == 3
    for a, b, c in zip(sync_batches, ref_batches, threaded):
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])
    assert len(DataLoader(ds, batch_size=4, drop_last=True)) == 2


def test_loader_stops_early_and_reraises_worker_errors():
    ds = SyntheticClassificationDataset(transform=None, num_samples=40, image_size=(4, 4))
    loader = DataLoader(ds, batch_size=2, num_workers=2, prefetch_factor=1)
    for i, _ in enumerate(loader):
        if i == 1:
            break  # the producer must stop and be joined, not hang

    class Broken(SyntheticClassificationDataset):
        def get_batch(self, idxs):
            raise OSError("unreadable shard")

    broken = Broken(transform=None, num_samples=8, image_size=(4, 4))
    with pytest.raises(OSError, match="unreadable shard"):
        list(DataLoader(broken, batch_size=2, num_workers=2))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, False)])
def test_set_epoch_order_matches_jax(shuffle, drop_last):
    """Epochs 0, 1, 2 visit the same indices in the same batches as
    torchok_tpu's loader for the same seed."""
    kw = dict(num_samples=11, num_classes=10, image_size=(8, 8), seed=5)
    ref = JaxLoader(JaxSynthetic(transform=_pipeline(JAX_TRANSFORMS), **kw), batch_size=4, shuffle=shuffle, drop_last=drop_last,
                    num_workers=0, seed=9)
    got = DataLoader(SyntheticClassificationDataset(transform=_pipeline(TRANSFORMS), **kw),
                     batch_size=4, shuffle=shuffle,
                     drop_last=drop_last, num_workers=0, seed=9)
    orders = []
    for epoch in (0, 1, 2):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        ref_batches, got_batches = ref._index_batches(), got._index_batches()
        assert len(got_batches) == len(ref_batches) == len(got) == len(ref)
        for a, b in zip(got_batches, ref_batches):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got, ref):  # and the batches themselves
            np.testing.assert_array_equal(a["target"], b["target"])
        orders.append(np.concatenate(got_batches).tolist())
    assert (orders[0] != orders[1] and orders[1] != orders[2]) == shuffle


def test_train_phase_metrics_accumulate_and_reset_per_epoch():
    """Phase.TRAIN metrics see every step's outputs, are read at the epoch's
    end and start the next epoch empty, as torchok_tpu's MetricsManager."""
    from torchok_tpu.constructor.config_structure import Phase as JaxPhase
    from torchok_tpu.metrics.metrics_manager import MetricsManager as JaxManager
    from torchok_tpu_torch.constructor.config_structure import Phase
    from torchok_tpu_torch.metrics.metrics_manager import MetricsManager
    params = [{"name": "Accuracy", "params": {"task": "multiclass", "num_classes": 5},
               "mapping": {"preds": "prediction", "target": "target"}},
              {"name": "F1Score", "params": {"task": "multiclass", "num_classes": 5},
               "mapping": {"preds": "prediction", "target": "target"},
               "phases": ["VALID"], "tag": "f1"}]
    ref, got = JaxManager(params), MetricsManager(params)
    rng = np.random.default_rng(8)
    logs = []
    for epoch in range(2):
        for _ in range(3):
            preds = rng.normal(size=(8, 5)).astype(np.float32)
            target = rng.integers(0, 5, size=8)
            ref.update(JaxPhase.TRAIN, 0, prediction=jnp.asarray(preds), target=jnp.asarray(target))
            got.update(Phase.TRAIN, 0, prediction=torch.from_numpy(preds),
                       target=torch.from_numpy(target))
        ref_log, log = ref.on_epoch_end(JaxPhase.TRAIN), got.on_epoch_end(Phase.TRAIN)
        assert set(log) == set(ref_log) == {"train/Accuracy"}  # F1 is VALID-only
        assert log["train/Accuracy"] == pytest.approx(ref_log["train/Accuracy"], abs=1e-7)
        logs.append(log["train/Accuracy"])
    assert logs[0] != logs[1]  # the second epoch did not start from the first's counts
    assert all(m.state is None for m in got.phase2metrics["TRAIN"])
