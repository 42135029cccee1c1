"""Two repairs of the port: every name it defines resolves after ``import
torchok_tpu_torch`` alone (CIFAR-10/100 were missing), and host-side random
transforms draw from seeded generators.

* In a fresh interpreter that imports only ``torchok_tpu_torch``: every
  dataset class the port registers, the two CIFARs, ``PoolingLinear``,
  ``ArcFaceHead`` and the 14 retrieval meters resolve, and no JAX module is
  loaded.
* ``configs/classification_cifar10.yaml`` runs ``+mode=test`` on
  CIFAR-format batches written here (``download: false``).
* A host pipeline (a Compose of a RandomCrop at p = 0.5 and a Resize) draws
  each sample's crops from ``SeedSequence([seed, index])``: two fits are
  bit-equal with 0 or 3 loader threads, another loader seed gives another
  fit, and 2 epochs resumed for a third equal 3 epochs bit for bit.
"""
import copy
import hashlib
import json
import pickle
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import torchok_tpu_torch  # noqa: F401
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint
from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.constructor.config import load_yaml
from torchok_tpu_torch.data.datasets.examples import cifar

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "torchok_tpu_torch"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _registered(registry):
    """Class names the port's sources register in ``registry``."""
    names = []
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        names += re.findall(rf"@{registry}\.register_class\s+class (\w+)", text)
    return names


SLICE = {"DATASETS": ["CIFAR10", "CIFAR100", *_registered("DATASETS")],
         "POOLINGS": ["PoolingLinear"], "HEADS": ["ArcFaceHead"],
         "METRICS": ["HitAtKMeter", "PrecisionAtKMeter", "RecallAtKMeter",
                     "MeanAveragePrecisionAtKMeter", "NDCGAtKMeter",
                     "RetrievalHitRateMeter", "RetrievalPrecisionMeter", "RetrievalRecallMeter",
                     "RetrievalFallOutMeter", "RetrievalMAPMeter", "RetrievalMRRMeter",
                     "RetrievalNormalizedDCGMeter", "RetrievalRPrecisionMeter",
                     "RetrievalPrecisionRecallCurveMeter"]}
NAMES = sorted({(registry, name) for registry, names in SLICE.items() for name in names})


@pytest.fixture(scope="module")
def fresh_registries():
    code = ("import json, sys\nimport torchok_tpu_torch\n"
            "from torchok_tpu_torch import constructor\n"
            f"names = {sorted(SLICE)!r}\n"
            "print(json.dumps({'jax': any(m == 'jax' or m.startswith(('jax.', 'torchok_tpu.'))"
            " or m == 'torchok_tpu' for m in sys.modules),"
            " **{n: sorted(getattr(constructor, n).entries) for n in names}}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_fresh_interpreter_loads_no_jax(fresh_registries):
    assert fresh_registries["jax"] is False
    assert {"SyntheticClassificationDataset", "SyntheticShapesDataset"} <= set(SLICE["DATASETS"])


@pytest.mark.parametrize("registry,name", NAMES)
def test_a_name_resolves_after_importing_the_package_alone(fresh_registries, registry, name):
    assert name in fresh_registries[registry]


def _write_cifar(root, cls, n_classes, label_key):
    """Tiny CIFAR-format batches: (file name, md5) lists and the meta's md5."""
    base = root / cls.base_folder
    base.mkdir(parents=True)
    rng = np.random.default_rng(1)
    listed = []
    for i, (name, _) in enumerate(cls.train_list + cls.test_list):
        entry = {"data": rng.integers(0, 256, (6 + i, 3 * 32 * 32), dtype=np.uint8),
                 label_key: rng.integers(0, n_classes, 6 + i).tolist()}
        (base / name).write_bytes(pickle.dumps(entry))
        listed.append([name, hashlib.md5((base / name).read_bytes()).hexdigest()])
    meta = base / cls.meta["filename"]
    meta.write_bytes(pickle.dumps({cls.meta["key"]: [f"c{i}" for i in range(n_classes)]}))
    return listed, hashlib.md5(meta.read_bytes()).hexdigest()


def test_the_cifar10_recipe_runs_test_mode_on_batches_on_disk(tmp_path, monkeypatch):
    cls = DATASETS.get("CIFAR10")
    assert cls is cifar.CIFAR10
    listed, meta_md5 = _write_cifar(tmp_path / "data", cls, 10, "labels")
    n_train = len(cls.train_list)
    monkeypatch.setattr(cls, "train_list", listed[:n_train])
    monkeypatch.setattr(cls, "test_list", listed[n_train:])
    monkeypatch.setattr(cls, "meta", {**cls.meta, "md5": meta_md5})
    monkeypatch.setattr(cls, "url", "http://invalid.invalid/never-fetched")
    cfg = load_yaml(REPO / "configs" / "classification_cifar10.yaml")
    cfg["data"]["TEST"] = copy.deepcopy(cfg["data"]["VALID"])
    for phase in ("TRAIN", "VALID", "TEST"):
        cfg["data"][phase][0]["dataset"]["params"].update(download=False,
                                                         data_folder=str(tmp_path / "data"))
        cfg["data"][phase][0]["dataloader"]["num_workers"] = 2
    cfg["trainer"]["accelerator"] = "cpu"
    cfg["logger"]["log_dir"] = str(tmp_path / "logs")
    del cfg["hydra"]
    cfg["callbacks"][0]["params"]["dirpath"] = str(tmp_path / "ckpt")
    trainer, logs = run(cfg, "test")
    assert trainer.last_eval["images"] == 6 + n_train  # the test batch's rows
    assert 0.0 <= logs["test/Accuracy"] <= 1.0 and 0.0 <= logs["test/F1Score"] <= 1.0


# ------------------------------ host seeds ---------------------------------
_HOST_CROP = [{"name": "Compose", "params": {"transforms": [
    {"name": "RandomCrop", "params": {"height": 12, "width": 12, "p": 0.5}},
    {"name": "Resize", "params": {"height": 16, "width": 16}}]}}]


def _config(max_epochs, workers=0, loader_seed=0):
    return {
        "task": {"name": "ClassificationTask",
                 "params": {"backbone_name": "resnet18",
                            "backbone_params": {"layers": [1, 1, 1, 1], "pretrained": False},
                            "pooling_name": "Pooling", "head_name": "ClassificationHead",
                            "head_params": {"num_classes": 10}}},
        "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                                   "mapping": {"input": "prediction", "target": "target"}}]},
        "optimization": [{"optimizer": {"name": "SGD", "params": {"lr": 0.01, "momentum": 0.9}}}],
        "data": {"TRAIN": [{
            "dataloader": {"batch_size": 4, "num_workers": workers, "shuffle": True,
                           "drop_last": True, "seed": loader_seed},
            "dataset": {"name": "SyntheticShapesDataset",
                        "params": {"num_samples": 24, "image_size": [16, 16], "seed": 3,
                                   "hardness": 0.6},
                        "augment": copy.deepcopy(_HOST_CROP),
                        "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}}]},
        "trainer": {"accelerator": "cpu", "max_epochs": max_epochs, "num_sanity_val_steps": 0},
        "seed_params": {"seed": 7},
    }


def _params(trainer):
    return {k: v.clone() for k, v in trainer.state.model.state_dict().items()}


def test_each_sample_draws_from_its_own_seeded_generator():
    ds = DATASETS.get("SyntheticShapesDataset")(
        transform=None, num_samples=64, image_size=[16, 16], seed=3,
        augment=torchok_tpu_torch.constructor.constructor.Constructor._create_transforms(
            copy.deepcopy(_HOST_CROP)))
    assert not ds.host_pipeline_empty
    ds.seed(5)
    first = [ds[i]["image"] for i in range(64)]
    with ThreadPoolExecutor(4) as pool:  # any thread, any order
        again = list(pool.map(lambda i: ds[i]["image"], reversed(range(64))))[::-1]
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    ds.seed(6)  # the next epoch's seed draws again
    moved = sum(not np.array_equal(a, ds[i]["image"]) for i, a in enumerate(first))
    assert 8 <= moved <= 56


def test_two_fits_with_host_crops_are_equal_whatever_the_worker_count():
    one, _ = run(_config(2, workers=0), "train")
    other, _ = run(_config(2, workers=3), "train")
    want, have = _params(one), _params(other)
    for key in want:
        assert torch.equal(have[key], want[key]), key
    reseeded, _ = run(_config(2, workers=0, loader_seed=1), "train")
    assert not all(torch.equal(v, want[k]) for k, v in _params(reseeded).items())


def test_a_resume_with_host_crops_equals_the_uninterrupted_fit(tmp_path):
    whole, _ = run(_config(3, workers=2), "train")
    run(_config(2, workers=2), "train", [ModelCheckpoint(dirpath=str(tmp_path), save_last=True)])
    resumed, _ = run({**_config(3, workers=2), "resume_path": str(tmp_path / "last.ckpt")},
                     "train")
    assert resumed.global_step == whole.global_step == 18
    want, have = _params(whole), _params(resumed)
    for key in want:
        assert torch.equal(have[key], want[key]), key
