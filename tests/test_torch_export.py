"""Export and replay in the port, and the recipes' names, on the CPU.

* ``export_task_model`` round trip: the artifact (``model.pt2`` and the JAX
  package's three ``meta.json`` keys) replays the task's eval forward at
  batch sizes 1 and 3 within 1e-6 of its largest magnitude, leaves ArcFace's
  step counter out and every module's mode as it was.
* ``ONNXTask`` on the JAX package's surface (``path_to_onnx`` or
  ``model_path``, ``providers`` ignored, the input's batch key from
  ``keys_mapping_onnx2dataset``), and ``configs/stablehlo_infer.yaml`` as
  ``chip_smoke.py`` runs it, on a written CIFAR-10 batch: its Accuracy and
  F1Score equal the live task's test.
* The three file errors; export of a model whose eval forward runs a
  hand-written kernel raises ``NotImplementedError`` naming it (K1, K3a).
* ``ModelCheckpointWithOnnx`` writes an artifact beside every checkpoint
  it keeps, removes it with a dropped checkpoint, and logs a failed export
  as a warning while the fit goes on.
* Every ``name:`` of the 37 recipes under ``configs/`` resolves in the
  port's registries; ``chip_smoke.py``'s stablehlo_infer dict equals its
  YAML.
"""
import copy
import importlib.util
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import torchok_tpu_torch  # noqa: F401
import torchok_tpu_torch.constructor.logger  # noqa: F401 — registers the loggers
from torchok_tpu_torch import constructor as registries
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.constructor import TASKS
from torchok_tpu_torch.constructor.config import config_from_dict, load_config, load_yaml
from torchok_tpu_torch.constructor.config_structure import merge_structured
from torchok_tpu_torch.data.datasets.examples.cifar import CIFAR10
from torchok_tpu_torch.export import stablehlo
from torchok_tpu_torch.export.stablehlo import StableHLOModel, export_task_model

REPO = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _classification(head="LinearHead", backbone="resnet18", backbone_params=None, size=32,
                    **extra):
    heads = {"LinearHead": {"out_channels": 16, "normalize": True},
             "ArcFaceHead": {"num_classes": 10}}
    params = {"backbone_name": backbone,
              "backbone_params": backbone_params or {"layers": [1, 1, 1, 1]},
              "pooling_name": "Pooling", "head_name": head, "head_params": heads[head],
              "inputs": [{"shape": [3, size, size], "dtype": "float32"}]}
    return {"task": {"name": "ClassificationTask", "params": params}, "data": {},
            "trainer": {"accelerator": "cpu", **extra}}


def _task(cfg):
    config = merge_structured(config_from_dict(copy.deepcopy(cfg)))
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    task.init_weights(torch.Generator().manual_seed(0))
    return task


def _eval_forward(task, x):
    model = task.as_module().eval()
    with torch.no_grad():
        return model.forward_image(x)


@pytest.mark.parametrize("head", ["LinearHead", "ArcFaceHead"])
def test_export_round_trip(tmp_path, head):
    task = _task(_classification(head))
    task.model.train()
    path = export_task_model(task, str(tmp_path / "model.stablehlo"))
    assert all(m.training for m in task.model.modules())
    meta = json.loads((Path(path) / "meta.json").read_text())
    assert meta == {"input_shape": [3, 32, 32], "input_dtype": "float32",
                    "batch_polymorphic": True}
    runner = StableHLOModel(path)
    assert "model.head.step" not in runner.program.state_dict
    if head == "ArcFaceHead":
        assert "step" in dict(task.model.head.named_buffers())
    for batch in (1, 3):
        x = torch.from_numpy(np.random.default_rng(batch).normal(
            size=(batch, 3, 32, 32)).astype(np.float32))
        want = _eval_forward(task, x)
        got = runner(x)
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_onnx_task_takes_the_jax_surface(tmp_path):
    task = _task(_classification())
    path = export_task_model(task, str(tmp_path / "m.stablehlo"))
    cfg = {"task": {"name": "ONNXTask"}, "data": {}, "trainer": {"accelerator": "cpu"}}
    config = merge_structured(config_from_dict(cfg))
    onnx = TASKS.get("ONNXTask")(config, path_to_onnx=path, providers=["CUDAExecutionProvider"],
                                 keys_mapping_onnx2dataset={"input.1": "img"})
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 32, 32)).astype(np.float32))
    out = onnx.model({"img": x, "target": torch.tensor([1, 2])})
    want = _eval_forward(task, x)
    assert set(out) == {"prediction", "embeddings", "target"}
    assert torch.equal(out["prediction"], out["embeddings"])
    assert (out["prediction"] - want).abs().max() <= 1e-6 * want.abs().max()
    alias = TASKS.get("ONNXTask")(config, model_path=path)
    assert alias.model.image_key == "image" and onnx.runner.meta["input_shape"] == [3, 32, 32]
    with pytest.raises(ValueError, match="requires path_to_onnx"):
        TASKS.get("ONNXTask")(config)


def test_stablehlo_infer_recipe_equals_the_live_test(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (24, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 24)
    chip_smoke.write_cifar_batches(str(tmp_path / "cifar"), images, labels)
    for name in ("train_list", "test_list"):
        monkeypatch.setattr(CIFAR10, name, [[f, None] for f, _ in getattr(CIFAR10, name)])
    monkeypatch.setattr(CIFAR10, "meta", {**CIFAR10.meta, "md5": None})
    task = _task(_classification("ArcFaceHead"))
    torch.save({"state_dict": task.model.state_dict()}, tmp_path / "live.ckpt")
    artifact = export_task_model(task, str(tmp_path / "live.stablehlo"))
    cfg, cuts = chip_smoke.stablehlo_infer_config(artifact, str(tmp_path / "cifar"),
                                                  str(tmp_path / "infer"))
    cfg["trainer"]["accelerator"] = "cpu"
    assert len(cuts) == 5
    live = {**_classification("ArcFaceHead"), "metrics": copy.deepcopy(cfg["metrics"]),
            "data": copy.deepcopy({"TEST": cfg["data"]["TEST"]}),
            "resume_path": str(tmp_path / "live.ckpt")}
    _, want = run(live, "test")
    _, got = run(cfg, "test")
    assert set(got) == {"test/Accuracy", "test/F1Score"}
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-9, key


def test_artifact_file_errors(tmp_path):
    (tmp_path / "model.onnx").write_bytes(b"onnx")
    (tmp_path / "model.bin").write_bytes(b"bin")
    (tmp_path / "empty.stablehlo").mkdir()
    with pytest.raises(ValueError, match="real ONNX file"):
        StableHLOModel(str(tmp_path / "model.onnx"))
    with pytest.raises(ValueError, match="is a file"):
        StableHLOModel(str(tmp_path / "model.bin"))
    with pytest.raises(ValueError, match="model.pt2 missing"):
        StableHLOModel(str(tmp_path / "empty.stablehlo"))


@pytest.mark.parametrize("backbone, params, kernel", [
    ("swinv2_custom", dict(img_size=32, patch_size=4, window_size=4, embed_dim=16,
                           depths=[2, 2], num_heads=[2, 4]), "K1"),
    ("gcvit_xxtiny", dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), img_size=32,
                          window_ratio=(8, 8)), "K3a"),
])
def test_export_of_a_kernel_model_raises(tmp_path, backbone, params, kernel):
    cfg = _classification(backbone=backbone, backbone_params=params)
    cfg["task"]["params"]["pooling_name"] = "Pooling"
    with pytest.raises(NotImplementedError, match=rf"hand-written kernel {kernel}\b"):
        export_task_model(_task(cfg), str(tmp_path / "k.stablehlo"))
    assert not (tmp_path / "k.stablehlo").exists()


def _checkpoint_fit(tmp_path, **callback):
    data = {"dataloader": {"batch_size": 8, "num_workers": 0, "drop_last": True,
                           "shuffle": False},
            "dataset": {"name": "SyntheticShapesDataset",
                        "params": {"num_samples": 16, "image_size": [32, 32]},
                        "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}}
    cfg = _classification("ArcFaceHead", max_epochs=2, num_sanity_val_steps=0)
    cfg["task"]["params"].update(pooling_name="PoolingLinear", pooling_params={"out_channels": 8})
    cfg.update(
        data={"TRAIN": [data], "VALID": [copy.deepcopy(data)]},
        joint_loss={"losses": [{"name": "CrossEntropyLoss",
                                "mapping": {"input": "prediction", "target": "target"}}]},
        optimization=[{"optimizer": {"name": "SGD", "params": {"lr": 0.01}},
                       "scheduler": {"name": "ExponentialLR", "params": {"gamma": 0.5}}}],
        logger={"name": "CSVLogger", "log_dir": str(tmp_path / "logs")},
        callbacks=[{"name": "ModelCheckpointWithOnnx", "params": {
            "dirpath": str(tmp_path / "ckpt"), "monitor": "lr", "mode": "min", "save_top_k": 1,
            "save_last": False, "export_to_onnx": True, "remove_head": True,
            "onnx_params": {"opset_version": 16}, **callback}}])
    return run(cfg, "train")


def test_checkpoint_with_onnx_exports_beside_each_checkpoint(tmp_path, monkeypatch):
    calls = []
    export = stablehlo.export_task_model
    monkeypatch.setattr(stablehlo, "export_task_model",
                        lambda *a, **k: calls.append(a[1]) or export(*a, **k))
    trainer, _ = _checkpoint_fit(tmp_path, save_last=True)
    names = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    # epoch 1's lower lr replaced epoch 0's checkpoint, and its artifact with it
    assert names == ["epoch=1-step=4.ckpt", "epoch=1-step=4.stablehlo", "last.ckpt",
                     "last.stablehlo"]
    # last.ckpt of the same step takes a copy of the epoch's artifact
    assert [Path(c).name for c in calls] == ["epoch=0-step=2.stablehlo",
                                             "epoch=1-step=4.stablehlo"]
    x = torch.zeros(2, 3, 32, 32)
    want = _eval_forward(trainer.task, x)
    for name in ("epoch=1-step=4.stablehlo", "last.stablehlo"):
        got = StableHLOModel(str(tmp_path / "ckpt" / name))(x)
        assert torch.allclose(got, want, rtol=0, atol=1e-5), name


def test_a_failed_export_is_a_warning(tmp_path, monkeypatch, caplog):
    def broken(*_, **__):
        raise RuntimeError("no export today")

    monkeypatch.setattr(stablehlo, "export_task_model", broken)
    with caplog.at_level(logging.WARNING):
        trainer, _ = _checkpoint_fit(tmp_path)
    assert trainer.current_epoch == 1
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["epoch=1-step=4.ckpt"]
    assert sum("no export today" in r.getMessage() for r in caplog.records) == 2


# ----------------------------------------------------------------------
# the recipes
# ----------------------------------------------------------------------

RECIPES = sorted(str(p.relative_to(REPO / "configs").with_suffix(""))
                 for p in (REPO / "configs").rglob("*.yaml"))


def _names(node):
    if isinstance(node, dict):
        out = [node["name"]] if isinstance(node.get("name"), str) else []
        return out + [n for v in node.values() for n in _names(v)]
    if isinstance(node, list):
        return [n for v in node for n in _names(v)]
    return []


def _asks(cfg):
    """(registries, name) of every component a recipe names."""
    task = cfg["task"]
    params = task.get("params") or {}
    out = [(("TASKS",), task["name"])]
    for key, regs in (("backbone_name", ("BACKBONES",)), ("pooling_name", ("POOLINGS",)),
                      ("head_name", ("HEADS",)), ("neck_name", ("NECKS", "DETECTION_NECKS"))):
        if params.get(key):
            out.append((regs, params[key]))
    out += [(("LOSSES",), n) for n in _names(cfg.get("joint_loss"))]
    for group in cfg.get("optimization") or []:
        out.append((("OPTIMIZERS",), group["optimizer"]["name"]))
        if group.get("scheduler"):
            out.append((("SCHEDULERS",), group["scheduler"]["name"]))
    for loaders in (cfg.get("data") or {}).values():
        for loader in loaders:
            out.append((("DATASETS",), loader["dataset"]["name"]))
            for key in ("augment", "transform"):
                out += [(("TRANSFORMS",), n) for n in _names(loader["dataset"].get(key))]
    out += [(("CALLBACKS",), c["name"]) for c in cfg.get("callbacks") or []]
    out += [(("METRICS",), m["name"]) for m in cfg.get("metrics") or []]
    if cfg.get("logger"):
        out.append((("LOGGERS",), cfg["logger"]["name"]))
    return out


def test_the_walk_sees_all_37_recipes():
    assert len(RECIPES) == 37


@pytest.mark.parametrize("recipe", RECIPES)
def test_every_name_of_every_recipe_resolves(recipe, monkeypatch):
    monkeypatch.setenv("HOME", "/nonexistent")
    cfg = load_config(REPO / "configs" / Path(recipe).parent, Path(recipe).name).to_dict()
    asks = _asks(cfg)
    assert len(asks) >= 3
    missing = [(regs, n) for regs, n in asks
               if not any(n in getattr(registries, r) for r in regs)]
    assert not missing


def test_chip_smoke_holds_the_stablehlo_infer_recipe():
    assert load_yaml(REPO / "configs" / "stablehlo_infer.yaml") == \
        chip_smoke.STABLEHLO_INFER_RECIPE
