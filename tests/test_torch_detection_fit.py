"""The detection slice as a whole: a ``SingleStageDetectionTask`` fit in the
port against ``torchok_tpu``, f32 on the CPU.

The north star cut to resnet10t + FPN (32 channels, 3 levels) + FCOSHead
(32 channels, one stacked conv) at its 96x96, its three losses, SGD (lr 1e-4,
momentum 0.9) over 3 steps of 8 images read from PNG files with their boxes
(the host HorizontalFlip left out: the two packages seed host transforms
differently), then one validation over 8 images with MMDetectionMAP at IoU
0.5 (map50) and 0.1 (map10), from the same random weights in both packages
(the box regression started near 40 pixels): each train step's loss and the
validation losses within 1e-5 relative, both mAPs equal to 1e-9. Three steps
this short leave no box above IoU 0.5 in either package (map50 is 0 in
both); map10 is about 0.23.

Why the cut is not smaller or faster: at 64x64 the stride-32 level is 2x2, and
with the recipe's lr 1e-2 (or 1e-3) the third step's loss parted by 3e-5
(1.2e-5). The parting comes from the JAX side: on one step's batch at 96x96
the JAX package's f32 backbone gradients lie up to 8% (layer2's first conv,
in its largest element's units) from the port's f64 ones, where the port's
f32 gradients lie within 3e-6 of them.
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
    """One intra-op thread for the port's fit: at these sizes more threads
    only contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIZE = 96


def _write_set(root, n, seed):
    """``n`` SIZE x SIZE PNGs with one to three bright boxes each."""
    root.mkdir()
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        img = rng.integers(0, 60, (SIZE, SIZE, 3), dtype=np.uint8)
        boxes, labels = [], []
        for _ in range(int(rng.integers(1, 4))):
            w, h = (int(v) for v in rng.integers(10, 40, 2))
            x0, y0 = int(rng.integers(0, SIZE - w)), int(rng.integers(0, SIZE - h))
            img[y0:y0 + h, x0:x0 + w] = int(rng.integers(150, 255))
            boxes.append([x0, y0, w, h])
            labels.append(int(rng.integers(0, 2)))
        cv2.imwrite(str(root / f"{i}.png"), img)
        rows.append({"image_path": f"{i}.png", "bbox": json.dumps(boxes),
                     "label": json.dumps(labels)})
    pd.DataFrame(rows).to_csv(root / "ann.csv", index=False)


LR = 0.0001


def _config(root):
    cfg = copy.deepcopy(chip_smoke.FCOS_RECIPE)
    params = cfg["task"]["params"]
    params.update(backbone_name="resnet10t", inputs=[{"shape": [3, SIZE, SIZE],
                                                      "dtype": "float32"}])
    params["neck_params"]["out_channels"] = 32
    params["head_params"].update(feat_channels=32, stacked_convs=1)
    for phase, split in (("TRAIN", "train"), ("VALID", "valid")):
        data = cfg["data"][phase][0]
        data["dataloader"].update(batch_size=8, num_workers=0)
        data["dataset"]["params"]["data_folder"] = str(root / split)
        data["dataset"].pop("augment", None)
    cfg["optimization"][0] = {"optimizer": {"name": "SGD",
                                            "params": {"lr": LR, "momentum": 0.9}}}
    cfg["trainer"].update(accelerator="cpu", max_epochs=1, log_every_n_steps=1)
    # three steps leave few boxes above IoU 0.5: a second meter at 0.1
    cfg["metrics"].append({**copy.deepcopy(cfg["metrics"][0]), "tag": "map10",
                           "params": {"iou_thr": 0.1, "num_classes": 2}})
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


def test_a_cut_fcos_fit_matches_torchok_tpu(monkeypatch, tmp_path):
    _write_set(tmp_path / "train", 24, 0)
    _write_set(tmp_path / "valid", 8, 1)
    # the initial weights at random (shapes by tracing the JAX init, which
    # compiled would take longer than the fit); the port starts from them
    init_variables = JaxBaseTask.init_variables
    rng = np.random.default_rng(9)

    def draw(self, key, batch=None):
        variables = draw_variables(jax.eval_shape(lambda k: init_variables(self, k, batch), key),
                                   rng)
        # boxes of about 40 pixels from the start, so some match at IoU 0.1
        head = variables["params"]["bbox_head"]
        head["conv_reg"]["bias"][:] = 3.0
        for level in range(3):
            head[f"scale_{level}"]["scale"][...] = 1.0
        return variables

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
    assert "neck.fpn_convs.2.conv.weight" in state and "bbox_head.scales.2.scale" in state
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}},
               ckpt)
    losses = _PortLosses()
    trainer, logs = run({**cfg, "resume_path": str(ckpt)}, "train", [losses])
    assert trainer.global_step == ref.global_step == 3
    assert [s for s, _ in losses.losses] == [s for s, _ in ref_losses.losses] == [1, 2, 3]
    for (_, got), (_, want) in zip(losses.losses, ref_losses.losses):
        assert got == pytest.approx(want, rel=1e-5)
    for key in ("valid/loss", "valid/loss_cls", "valid/loss_bbox", "valid/loss_centerness"):
        assert logs[key] == pytest.approx(ref.callback_metrics[key], rel=1e-5), key
    for key in ("valid/map50", "valid/map10"):
        assert logs[key] == pytest.approx(ref.callback_metrics[key], rel=0, abs=1e-9), key
    assert 0.1 < logs["valid/map10"] < 1.0
