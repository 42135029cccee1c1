"""The DETR slice as a whole: a ``SingleStageDetectionTask`` with ``DETRHead``
fit in the port against ``torchok_tpu``, f32 on the CPU.

The shape of ``tests/test_detection_train.py::
test_detr_training_with_shipped_loss_mappings`` (resnet10t, DETRHead 1 + 1
layers, 32 wide, 2 heads, 8 queries) with the DETR north star's losses,
AdamW and gradient clipping at 0.1 (``configs/detection_toy_detr.yaml``), 3
steps of 4 images read from PNG files with their boxes at 64x64 (the host
HorizontalFlip left out: the two packages seed host transforms
differently), then one validation over 8 images with MMDetectionMAP at IoU
0.5 (map50) and 0.1 (map10), from the same random weights in both packages.

Each train step's loss (the sum of both decoder outputs' Hungarian-matched
losses) within 2e-5 relative and the validation losses within 6e-5: AdamW's
first update moves every parameter by +-lr whatever its gradient's size, so
the sign of a gradient near zero decides it, and f32 noise flips some.
``tools/compare_detr_fit_f64.py`` runs the same fit in the port in f64: the
JAX package's f32 fit lies 1.29e-5 from it at step 3 and 3.41e-5 on
valid/loss_cls, the port's f32 fit 4.67e-6 and 1.66e-5 (the tolerances are
the sums, rounded up); both f32 fits' parameters lie up to 3.6e-3 of a
tensor's largest element from the f64 fit's. The meters are held on the same
weights: the port tests the JAX package's trained weights, carried over by
the bridge, and its map50 and map10 must equal the JAX validation's to 1e-9.
"""
import copy
import json

import cv2
import jax
import numpy as np
import pandas as pd
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
from torchok_tpu.constructor import TASKS as JAX_TASKS
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.config_structure import merge_structured as jax_merge
from torchok_tpu.constructor.runner import create_trainer as jax_create_trainer
from torchok_tpu.engine.callbacks import Callback as JaxCallback
from torchok_tpu.tasks.base import BaseTask as JaxBaseTask
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.utils.flax_convert import task_flax_to_state_dict
from tests.test_torch_detection_data import chip_smoke
from tests.test_torch_hrnet import draw_variables


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIZE = 64


def _write_set(root, n, seed):
    """``n`` SIZE x SIZE PNGs with one to three bright boxes each."""
    root.mkdir()
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        img = rng.integers(0, 60, (SIZE, SIZE, 3), dtype=np.uint8)
        boxes, labels = [], []
        for _ in range(int(rng.integers(1, 4))):
            w, h = (int(v) for v in rng.integers(10, 30, 2))
            x0, y0 = int(rng.integers(0, SIZE - w)), int(rng.integers(0, SIZE - h))
            img[y0:y0 + h, x0:x0 + w] = int(rng.integers(150, 255))
            boxes.append([x0, y0, w, h])
            labels.append(0)
        cv2.imwrite(str(root / f"{i}.png"), img)
        rows.append({"image_path": f"{i}.png", "bbox": json.dumps(boxes),
                     "label": json.dumps(labels)})
    pd.DataFrame(rows).to_csv(root / "ann.csv", index=False)


def _config(root):
    cfg = copy.deepcopy(chip_smoke.DETR_RECIPE)
    params = cfg["task"]["params"]
    params.update(backbone_name="resnet10t", inputs=[{"shape": [3, SIZE, SIZE],
                                                      "dtype": "float32"}])
    # the recipe's test_cfg (max_per_img 10) keeps all 8 queries, as the JAX
    # head keeps min(100, 8) of them (it reads no test_cfg inside a task)
    params["head_params"].update(num_classes=1, num_queries=8, embed_dim=32, num_heads=2,
                                 num_encoder_layers=1, num_decoder_layers=1, ffn_dim=64)
    for phase, split in (("TRAIN", "train"), ("VALID", "valid")):
        data = cfg["data"][phase][0]
        data["dataloader"].update(batch_size=4, num_workers=0)
        data["dataset"]["params"]["data_folder"] = str(root / split)
        data["dataset"].pop("augment", None)
    del cfg["optimization"][0]["scheduler"]
    cfg["trainer"].update(accelerator="cpu", max_epochs=1, log_every_n_steps=1,
                          steps_per_execution=1, check_val_every_n_epoch=1)
    cfg["metrics"][0]["params"]["num_classes"] = 1
    cfg["metrics"].append({**copy.deepcopy(cfg["metrics"][0]), "tag": "map10",
                           "params": {"iou_thr": 0.1, "num_classes": 1}})
    for key in ("logger", "callbacks"):
        del cfg[key]
    return cfg


class _JaxLosses(JaxCallback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, task, step, logs):
        self.losses.append((step, float(logs["loss"])))


class _PortLosses(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, task, step, logs):
        self.losses.append((step, logs["loss"]))


def test_a_cut_detr_fit_matches_torchok_tpu(monkeypatch, tmp_path):
    _write_set(tmp_path / "train", 12, 0)
    _write_set(tmp_path / "valid", 8, 1)
    init_variables = JaxBaseTask.init_variables
    rng = np.random.default_rng(5)

    def draw(self, key, batch=None):
        return draw_variables(jax.eval_shape(lambda k: init_variables(self, k, batch), key), rng)

    monkeypatch.setattr(JaxBaseTask, "init_variables", draw)
    cfg = _config(tmp_path)
    config = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
    ref_task = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    ref = jax_create_trainer(config)
    ref_losses = _JaxLosses()
    ref.callbacks.append(ref_losses)
    initial = {}
    setup = ref._setup_state

    def setup_and_capture(task_, ckpt_path=None):
        setup(task_, ckpt_path)
        initial.update(jax.device_get({"params": ref.state.params,
                                       "batch_stats": ref.state.batch_stats}))

    ref._setup_state = setup_and_capture
    ref.fit(ref_task)
    ckpt = tmp_path / "initial.pt"
    state = task_flax_to_state_dict("resnet10t", initial)
    assert "bbox_head.transformer.decoder.layers.0.attentions.1.attn.in_proj_weight" in state
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}},
               ckpt)
    losses = _PortLosses()
    trainer, logs = run({**cfg, "resume_path": str(ckpt)}, "train", [losses])
    assert trainer.global_step == ref.global_step == 3
    assert [s for s, _ in losses.losses] == [s for s, _ in ref_losses.losses] == [1, 2, 3]
    for (_, got), (_, want) in zip(losses.losses, ref_losses.losses):
        assert got == pytest.approx(want, rel=2e-5)
    for key in ("valid/loss", "valid/loss_cls", "valid/loss_bbox", "valid/loss_iou"):
        assert logs[key] == pytest.approx(ref.callback_metrics[key], rel=6e-5), key

    # the meters on the same weights: the JAX package's after its 3 steps
    trained = task_flax_to_state_dict("resnet10t", jax.device_get(
        {"params": ref.state.params, "batch_stats": ref.state.batch_stats}))
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in trained.items()}},
               tmp_path / "trained.pt")
    test_cfg = copy.deepcopy(cfg)
    test_cfg["data"]["TEST"] = test_cfg["data"].pop("VALID")
    for meter in test_cfg["metrics"]:
        meter["phases"] = ["TEST"]
    _, test_logs = run({**test_cfg, "resume_path": str(tmp_path / "trained.pt")}, "test")
    for tag in ("map50", "map10"):
        assert test_logs[f"test/{tag}"] == pytest.approx(ref.callback_metrics[f"valid/{tag}"],
                                                         rel=0, abs=1e-9), tag
    assert 0.05 < test_logs["test/map10"] < 1.0
