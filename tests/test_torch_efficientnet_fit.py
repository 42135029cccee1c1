"""The port's EfficientNet-B0 slice against ``torchok_tpu``: a 5-step fit of
both packages from the same weights (f32 on the CPU), a CLI run of a small
EfficientNet, and the slice's recipes against ``chip_smoke.py``'s dicts. The
backbones themselves are ``tests/test_torch_efficientnet.py``.
"""
import copy
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.tasks.base import BaseTask as JaxBaseTask
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.constructor.config import load_config
from torchok_tpu_torch.ops.common import LAUNCHES
from torchok_tpu_torch.utils.flax_convert import task_flax_to_state_dict, task_name_map
from tests.test_torch_resnet import _fit_jax, _to_torch
from tests.test_torch_train_slice import PortRecorder, small_config

REPO = Path(__file__).resolve().parent.parent

NARROW_B0 = {"depth_mult": 0.5, "drop_path_rate": 0.0, "pretrained": False}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: at these sizes more threads only
    contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _at_size(cfg, size):
    cfg["task"]["params"]["inputs"][0]["shape"] = [3, size, size]
    for loaders in cfg["data"].values():
        for loader in loaders:
            loader["dataset"]["params"]["image_size"] = [size, size]
    return cfg


def test_fit_matches_torchok_tpu_over_5_steps(tmp_path, monkeypatch):
    """B0 at half depth (two blocks in the stages with residual blocks), SGD
    with momentum and weight decay: loss per step, every parameter and every
    running statistic by name. 64x64 images: at 32x32 the last stage's maps
    are 1x1 and its batch statistics over 4 values leave the two packages'
    gradients 1e-3 apart, which 5 steps of momentum amplify."""
    # torchok_tpu initialises its variables op by op (one compile per op: most
    # of a minute here); one compiled function draws the same law
    init_variables = JaxBaseTask.init_variables
    monkeypatch.setattr(JaxBaseTask, "init_variables", lambda self, rng, batch=None: jax.jit(
        lambda r: init_variables(self, r, batch))(rng))
    name = "efficientnet_b0"
    cfg = _at_size(small_config({"name": "SGD", "params": {"lr": 0.01, "momentum": 0.9,
                                                           "weight_decay": 1e-3}},
                                backbone_name=name, backbone_params=NARROW_B0), 64)
    initial, final, ref = _fit_jax(cfg)
    ckpt = tmp_path / "initial.pt"
    torch.save({"state_dict": _to_torch(task_flax_to_state_dict(name, initial))}, ckpt)
    port_cfg = copy.deepcopy(cfg)
    port_cfg["resume_path"] = str(ckpt)
    got = PortRecorder()
    before = dict(LAUNCHES)
    trainer, logs = run(port_cfg, "train", [got])
    assert dict(LAUNCHES) == before  # no kernel and no kernel's plain version on this path

    assert trainer.global_step == 5 and len(got.steps) == len(ref.steps) == 5
    for step, (g, r) in enumerate(zip(got.steps, ref.steps)):
        # f32 on both sides, other summation orders: 1e-4 relative
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-4), f"step {step}"
    assert got.steps[0]["loss"] != got.steps[-1]["loss"]
    for key in ("train/loss", "valid/loss"):
        assert logs[key] == pytest.approx(ref.epochs[-1][key], rel=1e-4), key

    want = task_flax_to_state_dict(name, final)
    start = task_flax_to_state_dict(name, initial)
    state_dict = trainer.state.model.state_dict()
    assert sorted(want) == sorted(state_dict)
    stats = set(task_name_map(name, final, "batch_stats"))
    assert stats and all(k.endswith(("running_mean", "running_var")) for k in stats)
    moved = []
    for key, value in state_dict.items():
        if key in stats:
            np.testing.assert_allclose(value.numpy(), want[key], rtol=1e-4, atol=1e-5,
                                       err_msg=key)
        else:
            # SGD: the difference scales with the gradient difference itself
            np.testing.assert_allclose(value.numpy(), want[key], rtol=0, atol=2e-5, err_msg=key)
        if np.abs(value.numpy() - start[key]).max() > 0:
            moved.append(key)
    assert stats <= set(moved)
    assert "backbone.blocks.3.1.se.fc1.weight" in moved
    assert len(moved) > 0.9 * len(state_dict)


def test_cli_trains_a_small_efficientnet_on_the_cpu(tmp_path):
    cfg = small_config({"name": "Adam", "params": {"lr": 1e-3}},
                       backbone_name="efficientnet_b0",
                       backbone_params={"depth_mult": 0.25, "pretrained": False})
    cfg["trainer"]["accelerator"] = "gpu"  # the override below asks for the CPU
    (tmp_path / "small_effnet.yaml").write_text(json.dumps(cfg))  # JSON is valid YAML
    out = subprocess.run(
        [sys.executable, "-m", "torchok_tpu_torch", "-cp", str(tmp_path), "-cn", "small_effnet",
         "trainer.accelerator=cpu", "trainer.max_epochs=2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})  # one intra-op thread, as above
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("epoch ")]
    assert len(lines) == 2 and lines[1].startswith("epoch 1 | ")
    for part in ("train/loss=", "valid/Accuracy=", "valid/loss="):
        assert part in lines[0]
    assert "10 train steps, 40 images" in out.stdout


def test_recipes_equal_chip_smoke_configs():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for recipe, cfg in (("classification_efficientnet_b0_synthetic",
                         chip_smoke.EFFNET_SLICE_CONFIG),
                        ("classification_efficientnet_b0_synthetic_train",
                         chip_smoke.EFFNET_TRAIN_CONFIG),
                        ("classification_mobilenetv3_large_100_synthetic",
                         chip_smoke.MNV3_SLICE_CONFIG)):
        assert load_config(REPO / "configs", recipe).to_dict() == cfg, recipe
    for cfg, backbone in ((chip_smoke.EFFNET_SLICE_CONFIG, "efficientnet_b0"),
                          (chip_smoke.EFFNET_TRAIN_CONFIG, "efficientnet_b0"),
                          (chip_smoke.MNV3_SLICE_CONFIG, "mobilenetv3_large_100")):
        assert cfg["task"]["params"]["backbone_name"] == backbone
        assert cfg["task"]["params"]["inputs"][0]["shape"] == [3, 224, 224]
        loaders = cfg["data"].get("TEST", cfg["data"].get("TRAIN"))
        assert loaders[0]["dataloader"]["batch_size"] == 256
    train = chip_smoke.EFFNET_TRAIN_CONFIG
    assert train["optimization"][0]["optimizer"] == {"name": "Adam", "params": {"lr": 0.0001}}
    assert train["joint_loss"]["losses"][0]["name"] == "CrossEntropyLoss"
