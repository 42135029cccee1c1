"""The port's SwinV2 classification inference slice end to end on the CPU,
against ``torchok_tpu`` run on the same config, data and weights.

``torchok_tpu`` runs ``Trainer.test``/``predict`` with its Pallas attention
in interpret mode; the port runs ``__main__.run`` with ``accelerator: cpu``
(plain attention) on the Flax weights carried over by
``task_flax_to_state_dict`` and loaded through ``resume_path``.
"""
import copy
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
from torchok_tpu.constructor import TASKS as JAX_TASKS
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.config_structure import merge_structured as jax_merge
from torchok_tpu.constructor.runner import create_trainer as jax_create_trainer
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.constructor.config import load_config
from torchok_tpu_torch.utils.flax_convert import task_flax_to_state_dict

REPO = Path(__file__).resolve().parent.parent
BACKBONE = dict(img_size=32, patch_size=4, window_size=4, embed_dim=16,
                depths=[2, 2], num_heads=[2, 4], drop_path_rate=0.0,
                pretrained=False)
_METRIC = {"params": {"task": "multiclass", "num_classes": 10},
           "mapping": {"preds": "prediction", "target": "target"}}
_DATA = [{"dataloader": {"batch_size": 4, "num_workers": 0, "shuffle": False},
          "dataset": {"name": "SyntheticClassificationDataset",
                      "params": {"num_samples": 12, "num_classes": 10,
                                 "image_size": [32, 32], "seed": 3},
                      "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}}]
SMALL_CONFIG = {
    "task": {"name": "ClassificationTask",
             "params": {"backbone_name": "swinv2_custom", "backbone_params": BACKBONE,
                        "pooling_name": "Pooling", "head_name": "ClassificationHead",
                        "head_params": {"num_classes": 10},
                        "inputs": [{"shape": [3, 32, 32], "dtype": "float32"}]}},
    # an even batch: the JAX tests simulate two devices
    "data": {"TEST": _DATA, "PREDICT": _DATA},
    "trainer": {"accelerator": "cpu", "precision": 32,
                "limit_test_batches": 2, "limit_predict_batches": 2},
    "seed_params": {"seed": 7},
    "metrics": [{"name": "Accuracy", **_METRIC}, {"name": "F1Score", **_METRIC}],
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """torchok_tpu's test logs and predictions on perturbed weights, and the
    same weights saved as a port checkpoint."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TORCHOK_WINDOW_ATTN_PALLAS", "1")
    try:
        config = jax_merge(JaxConfigNode(copy.deepcopy(SMALL_CONFIG)))
        task = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
        trainer = jax_create_trainer(config)
        trainer._setup_state(task)
        rng = np.random.default_rng(11)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32)
            + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32),
            trainer.state.params)
        trainer.state = trainer.state.replace(params=params)
        logs = trainer.test(task)
        preds = trainer.predict(task)
    finally:
        mp.undo()
    ckpt = tmp_path_factory.mktemp("port") / "swinv2_small.pt"
    sd = task_flax_to_state_dict("swinv2_custom", {"params": params})
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    return logs, preds, str(ckpt)


def _port_config(ckpt):
    cfg = copy.deepcopy(SMALL_CONFIG)
    cfg["resume_path"] = ckpt
    return cfg


def test_test_mode_metrics_match_exactly(reference):
    ref_logs, _, ckpt = reference
    _, logs = run(_port_config(ckpt), "test")
    assert set(logs) == {"test/Accuracy", "test/F1Score"}
    for key in logs:
        assert logs[key] == ref_logs[key], key


def test_predict_mode_matches_logits(reference):
    _, ref_preds, ckpt = reference
    _, preds = run(_port_config(ckpt), "predict")
    assert len(preds) == len(ref_preds) == 2
    for got, ref in zip(preds, ref_preds):
        assert set(got) == set(ref) == {"embeddings", "prediction", "target"}
        assert got["prediction"].shape == (4, 10)
        # f32 on both sides; sum order differs through 4 blocks
        np.testing.assert_allclose(got["prediction"], np.asarray(ref["prediction"]),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(got["target"], np.asarray(ref["target"]))


def test_random_init_is_seeded():
    cfg = copy.deepcopy(SMALL_CONFIG)
    a = run(cfg, "predict")[1][0]["prediction"]
    b = run(cfg, "predict")[1][0]["prediction"]
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and np.abs(a).max() > 0


@pytest.mark.parametrize("accelerator", ["gpu", "cuda", "auto"])
def test_gpu_accelerator_raises_without_a_card(monkeypatch, accelerator):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = copy.deepcopy(SMALL_CONFIG)
    cfg["trainer"]["accelerator"] = accelerator
    with pytest.raises(RuntimeError, match="CUDA device"):
        run(cfg, "test")


@pytest.mark.parametrize("key,value", [
    ("num_nodes", 2), ("inference_mode", False), ("benchmark", True),
    ("model_parallel_size", 2), ("fast_dev_run", True), ("strategy", "ddp"),
    ("devices", 2)])
def test_unported_trainer_option_raises(key, value):
    cfg = copy.deepcopy(SMALL_CONFIG)
    cfg["trainer"][key] = value
    with pytest.raises(NotImplementedError, match=f"trainer.{key}"):
        run(cfg, "test")


def test_fit_loop_options_do_not_stop_eval():
    cfg = copy.deepcopy(SMALL_CONFIG)
    cfg["trainer"].update(max_epochs=5, gradient_clip_val=1.0, devices=1,
                          limit_test_batches=1)
    logs = run(cfg, "test")[1]
    assert set(logs) == {"test/Accuracy", "test/F1Score"}


def test_unknown_dataloader_key_raises():
    cfg = copy.deepcopy(SMALL_CONFIG)
    cfg["data"] = {"TEST": copy.deepcopy(_DATA)}
    cfg["data"]["TEST"][0]["dataloader"]["pin_memory"] = True
    with pytest.raises(TypeError, match="pin_memory"):
        run(cfg, "test")


def test_import_pulls_in_no_jax_yaml_cv2_or_pil():
    code = ("import sys, torchok_tpu_torch, torchok_tpu_torch.__main__, "
            "torchok_tpu_torch.utils.flax_convert, torchok_tpu_torch.utils.cuda_build; "
            "print(sorted(m for m in ('jax', 'flax', 'yaml', 'cv2', 'PIL', 'torchok_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_chip_smoke_config_equals_the_yaml():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    yaml_cfg = load_config(REPO / "configs", "classification_swinv2_tiny_synthetic")
    assert yaml_cfg.to_dict() == chip_smoke.SLICE_CONFIG


def test_cli_runs_the_yaml_on_cpu(tmp_path):
    """The CLI surface: YAML + overrides, shrunk to a CPU-sized run."""
    (tmp_path / "small.yaml").write_text(
        __import__("json").dumps(SMALL_CONFIG))  # JSON is valid YAML
    from torchok_tpu_torch.__main__ import entrypoint
    entrypoint(["-cp", str(tmp_path), "-cn", "small", "+mode=test",
                "trainer.limit_test_batches=1"])
