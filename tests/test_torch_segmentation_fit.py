"""A fit of the segmentation north star ``configs/segmentation_shapes.yaml``
in the port against ``torchok_tpu``, f32 on the CPU.

The recipe cut to one HRNet module with one block a branch (widths 8 to
64), 128 images of 16 a step at ``steps_per_execution`` 2, then its
validation over 32 images, from the same random weights in both packages:
the same global step, each execution's loss within 1e-5 relative (measured:
3e-7) and valid/JaccardIndex within 1e-4 (measured: equal).

The cut trains with SGD (lr 1e-3, momentum 0.9) instead of the recipe's Adam
at 1e-3. The packages' gradients agree to 1e-5 of each tensor's largest
element, but Adam's first update is lr x sign(g) wherever a gradient is near
zero, so f32 noise there moves a weight by up to 2 lr: the second
execution's loss differed by 2.5e-4 at Adam's 1e-3, and by 3e-5 with a
JaccardIndex 3e-5 apart at 1e-4. At 8 images a step BatchNorm over 8 values
at the 1x1 branch parts the packages faster. Both loaders give the recipe's
7 executions of 8 steps an epoch at 8000 images.
"""
import copy
import importlib.util
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
from torchok_tpu.data.loader import DataLoader as JaxDataLoader
from torchok_tpu.engine.callbacks import Callback as JaxCallback
from torchok_tpu.models.backbones import hrnet as jax_hrnet
from torchok_tpu.tasks.base import BaseTask as JaxBaseTask
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.data.loader import DataLoader
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.models.backbones import hrnet as port_hrnet
from torchok_tpu_torch.utils.flax_convert import task_flax_to_state_dict
from tests.test_torch_hrnet import CUT, draw_variables

REPO = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's fit: at these sizes more threads
    only contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Sized:
    """A dataset of this many samples (only its length is read)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


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


def test_a_cut_recipe_fit_matches_torchok_tpu(monkeypatch, tmp_path):
    monkeypatch.setitem(jax_hrnet.CFGS, "hrnet_w18_small", CUT)
    monkeypatch.setitem(port_hrnet.CFGS, "hrnet_w18_small", CUT)
    # the initial weights at random (shapes by tracing the JAX init, which
    # compiled would take longer than the fit); the port starts from them
    init_variables = JaxBaseTask.init_variables
    rng = np.random.default_rng(8)
    monkeypatch.setattr(JaxBaseTask, "init_variables", lambda self, key, batch=None:
                        draw_variables(jax.eval_shape(lambda k: init_variables(self, k, batch),
                                                      key), rng))
    # 128 images, 16 a step, 2 steps an execution: 4 executions; validation
    # over 32 images after the epoch
    cfg = copy.deepcopy(chip_smoke.SEGMENTATION_RECIPE)
    cfg["trainer"].update(accelerator="cpu", max_epochs=1, steps_per_execution=2,
                          log_every_n_steps=1)
    cfg["optimization"][0]["optimizer"] = {"name": "SGD",
                                           "params": {"lr": 0.001, "momentum": 0.9}}
    for phase, n, batch in (("TRAIN", 128, 16), ("VALID", 32, 16)):
        cfg["data"][phase][0]["dataloader"].update(batch_size=batch, num_workers=0)
        cfg["data"][phase][0]["dataset"]["params"]["num_samples"] = n
    for key in ("logger", "callbacks"):
        del cfg[key]
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
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in
                               task_flax_to_state_dict("hrnet_w18_small", initial).items()}},
               ckpt)
    losses = _PortLosses()
    trainer, logs = run({**cfg, "resume_path": str(ckpt)}, "train", [losses])
    assert trainer.global_step == ref.global_step == trainer.last_fit["steps"] == 8
    assert [s for s, _ in losses.losses] == [s for s, _ in ref_losses.losses] == \
        [2, 4, 6, 8]
    for (_, got), (_, want) in zip(losses.losses, ref_losses.losses):
        assert got == pytest.approx(want, rel=1e-5)
    jaccard = logs["valid/JaccardIndex"]
    assert jaccard == pytest.approx(ref.callback_metrics["valid/JaccardIndex"], rel=0, abs=1e-4)
    assert 0.0 < jaccard <= 10 / 11
    # the recipe at its short budget: 7 executions of 8 steps an epoch
    for loader in (DataLoader(_Sized(8000), batch_size=128 * 8, drop_last=True),
                   JaxDataLoader(_Sized(8000), batch_size=128 * 8, drop_last=True)):
        assert len(loader) * 8 == 56
    assert chip_smoke.SEGMENTATION_STEPS == 5 * 56
