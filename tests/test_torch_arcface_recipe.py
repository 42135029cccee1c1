"""The retrieval north star ``configs/representation_arcface_shapes.yaml``
in the port against ``torchok_tpu``, on the CPU.

* ``chip_smoke.py``'s recipe dict equals the YAML, with the short budget's
  overrides.
* One train step of the recipe's task (resnet18, PoolingLinear to 128,
  ArcFaceHead, 8 images at 32x32, f32) from the same Flax weights: the loss
  within 1e-5 relative, every gradient within 1e-4 of the largest element of
  its tensor (relative), every running statistic within 1e-5.
* A fit against ``torchok_tpu``'s trainer from the same weights: the recipe
  cut to one block a stage, 72 images of 8 a step, ``steps_per_execution`` 4
  and no random flip runs 8 steps an epoch in both (``drop_last`` takes the
  super-batch), its two executions' losses within 1e-5 relative and every
  parameter within 2e-5 after them (measured: 1e-7 and 1.6e-6; at 4 images
  a step BatchNorm's statistics over 4 values at the 1x1 last stage part
  the two by 1e-2 within 8 steps); the recipe's validation after it, over
  96 images, gives the same valid/recall_at_1 and valid/recall_at_5 in both
  packages (to 1e-9: the eval forward, the embeddings, the search and the
  meters of each); both loaders give the recipe's 3 executions an epoch at
  8000 images.
* A reduced fit through ``run(config, "train")`` logs ``valid/recall_at_1``
  and ``valid/recall_at_5`` in ``metrics.csv``, searching on the CPU, and
  ``chip_smoke.witness_recall`` recounts the last epoch's recall@5 in numpy
  to 1e-9.
* With the dynamic margin, 2 epochs and a resume from ``last.ckpt`` equal 3
  epochs bit for bit, ArcFace's ``step`` included.
"""
import copy
import csv
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
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
from torchok_tpu.tasks.base import BaseTask as JaxBaseTask
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint
from torchok_tpu_torch.constructor import METRICS, TASKS
from torchok_tpu_torch.constructor.config import (config_from_dict, load_config, load_yaml)
from torchok_tpu_torch.constructor.config_structure import merge_structured
from torchok_tpu_torch.data.loader import DataLoader
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.ops import knn
from torchok_tpu_torch.utils.flax_convert import task_flax_to_state_dict

REPO = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: at these sizes more threads only
    contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_arcface_recipe_equals_chip_smoke_config():
    assert load_yaml(REPO / "configs" / "representation_arcface_shapes.yaml") == \
        chip_smoke.ARCFACE_RECIPE
    overrides = ["trainer.max_epochs=8", "data.TRAIN.0.dataset.params.num_samples=8000"]
    assert chip_smoke.ARCFACE_OVERRIDES == overrides
    want = load_config(REPO / "configs", "representation_arcface_shapes",
                       overrides + ["logger.log_dir=/somewhere"])
    assert config_from_dict(chip_smoke.arcface_config("/somewhere")) == want
    assert want.trainer.steps_per_execution == 16 and want.trainer.precision == 32


def _recipe(**trainer):
    cfg = copy.deepcopy(chip_smoke.ARCFACE_RECIPE)
    cfg["trainer"].update(accelerator="cpu", **trainer)
    return cfg


def test_one_train_step_of_the_recipe_task_matches_torchok_tpu(monkeypatch):
    # torchok_tpu initialises op by op (one compile per op); one compiled
    # function draws the same variables
    init_variables = JaxBaseTask.init_variables
    monkeypatch.setattr(JaxBaseTask, "init_variables", lambda self, rng, batch=None: jax.jit(
        lambda r: init_variables(self, r, batch))(rng))
    cfg = _recipe()
    config = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
    ref = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    variables = jax.tree_util.tree_map(np.asarray, ref.init_variables(jax.random.PRNGKey(3)))
    assert int(variables["buffers"]["head"]["step"]) == 0

    port_cfg = merge_structured(config_from_dict(copy.deepcopy(cfg)))
    task = TASKS.get(port_cfg.task.name)(port_cfg, **port_cfg.task.params.to_dict())
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in
             task_flax_to_state_dict("resnet18", variables).items()}
    task.model.load_state_dict(state, strict=True)

    rng = np.random.default_rng(4)
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    target = rng.integers(0, 10, 8)

    def loss_fn(params):
        out, new = ref.model.apply({**variables, "params": params},
                                   {"image": jnp.asarray(images), "target": jnp.asarray(target)},
                                   train=True, mutable=["batch_stats", "buffers"])
        return ref.compute_loss(out)[0], new

    (want_loss, new_vars), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    task.model.train()
    outputs = task.model({"image": torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
                          "target": torch.from_numpy(target)})
    loss, _ = task.compute_loss(outputs)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    want_grads = task_flax_to_state_dict("resnet18", {"params": jax.tree_util.tree_map(
        np.asarray, grads)})
    named = dict(task.model.named_parameters())
    assert sorted(want_grads) == sorted(named)
    for key, param in named.items():
        scale = np.abs(want_grads[key]).max()
        np.testing.assert_allclose(param.grad.numpy(), want_grads[key], rtol=0,
                                   atol=1e-4 * scale + 1e-9, err_msg=key)
    after = task_flax_to_state_dict("resnet18", {"params": variables["params"], **new_vars})
    got = task.model.state_dict()
    for key, value in after.items():
        if key in named:
            continue
        np.testing.assert_allclose(got[key].numpy(), value, rtol=1e-5, atol=1e-5, err_msg=key)
    assert int(got["head.step"]) == 0  # no dynamic margin: the counter stays


class _Sized:
    """A dataset of this many samples (only its length is read)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def _cut(cfg, train_samples, batch=4, valid_samples=None):
    """The recipe cut to one block a stage, few images, no loader threads."""
    cfg["task"]["params"]["backbone_params"]["layers"] = [1, 1, 1, 1]
    cfg["data"]["TRAIN"][0]["dataloader"].update(batch_size=batch, num_workers=0)
    cfg["data"]["TRAIN"][0]["dataset"]["params"]["num_samples"] = train_samples
    if valid_samples is None:
        del cfg["data"]["VALID"]
        cfg["metrics"] = cfg["metrics"][2:]
    else:
        cfg["data"]["VALID"][0]["dataloader"].update(batch_size=16, num_workers=0)
        cfg["data"]["VALID"][0]["dataset"]["params"]["num_samples"] = valid_samples
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


def test_the_super_batch_fit_and_its_step_count_are_torchok_tpus(monkeypatch, tmp_path):
    init_variables = JaxBaseTask.init_variables
    monkeypatch.setattr(JaxBaseTask, "init_variables", lambda self, rng, batch=None: jax.jit(
        lambda r: init_variables(self, r, batch))(rng))
    # 72 images, 8 a step, 4 steps an execution: drop_last on the super-batch
    # of 32 leaves 2 executions, 8 steps (not 9); no random flip, whose
    # draws differ between the packages' generators; the recipe's
    # validation and its meters on 96 images after the epoch
    cfg = _cut(_recipe(max_epochs=1, steps_per_execution=4, log_every_n_steps=1), 72, batch=8,
               valid_samples=96)
    del cfg["data"]["TRAIN"][0]["dataset"]["augment"]
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
                                       "batch_stats": ref.state.batch_stats,
                                       "buffers": ref.state.buffers}))

    ref._setup_state = setup_and_capture
    ref.fit(ref_task)
    final = jax.device_get({"params": ref.state.params, "buffers": ref.state.buffers})
    ckpt = tmp_path / "initial.pt"
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in
                               task_flax_to_state_dict("resnet18", initial).items()}}, ckpt)
    losses = _PortLosses()
    trainer, logs = run({**cfg, "resume_path": str(ckpt)}, "train", [losses])
    for tag in ("valid/recall_at_1", "valid/recall_at_5"):
        assert logs[tag] == pytest.approx(ref.callback_metrics[tag], rel=0, abs=1e-9), tag
    assert logs["valid/recall_at_1"] > 0.1  # some neighbours found: the check can tell
    assert trainer.global_step == ref.global_step == trainer.last_fit["steps"] == 8
    assert [s for s, _ in losses.losses] == [s for s, _ in ref_losses.losses] == [4, 8]
    for (_, got), (_, want) in zip(losses.losses, ref_losses.losses):
        assert got == pytest.approx(want, rel=1e-5)
    want = task_flax_to_state_dict("resnet18", final)
    have = trainer.state.model.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(have[key].numpy(), value, rtol=0, atol=2e-5, err_msg=key)
    # the recipe at its short budget: 3 executions of 16 steps an epoch
    for loader in (DataLoader(_Sized(8000), batch_size=128 * 16, drop_last=True),
                   JaxDataLoader(_Sized(8000), batch_size=128 * 16, drop_last=True)):
        assert len(loader) * 16 == 48
    assert chip_smoke.ARCFACE_STEPS == 8 * 48


def test_a_reduced_fit_logs_both_recall_columns(monkeypatch, tmp_path):
    cfg = _cut(_recipe(max_epochs=2, steps_per_execution=2), 32, valid_samples=48)
    cfg["logger"]["log_dir"] = str(tmp_path)
    recall_meter = METRICS.get("RecallAtKMeter")
    compute, kept = recall_meter.compute, {}

    def keep_state(meter, state):
        kept["state"] = state
        return compute(meter, state)

    monkeypatch.setattr(recall_meter, "compute", keep_state)
    knn.SEARCHES.clear()
    trainer, logs = run(cfg, "train")
    assert trainer.global_step == 2 * 8
    assert dict(knn.SEARCHES) == {"cpu": 2 * 2}  # two meters, two epochs, one batch each
    assert chip_smoke.witness_recall(kept["state"], 5) == pytest.approx(
        logs["valid/recall_at_5"], rel=0, abs=1e-9)
    assert 0.0 <= logs["valid/recall_at_5"] <= 1.0 and 0.0 <= logs["valid/recall_at_1"] <= 1.0
    with open(Path(trainer.logger.log_dir) / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == chip_smoke.ARCFACE_CSV_HEADER
    epochs = [r for r in rows if r["valid/recall_at_1"]]
    assert len(epochs) == 2 and all(r["valid/recall_at_5"] for r in epochs)
    assert float(epochs[-1]["valid/recall_at_1"]) == pytest.approx(logs["valid/recall_at_1"])


def _dynamic(max_epochs):
    cfg = _cut(_recipe(max_epochs=max_epochs, steps_per_execution=2), 24)
    cfg["task"]["params"]["head_params"].update(dynamic_margin=True, num_warmup_steps=10,
                                                min_margin=0.1)
    for key in ("logger", "callbacks"):
        del cfg[key]
    return cfg


def test_a_dynamic_margin_resume_equals_the_uninterrupted_fit(tmp_path):
    # 24 images, 4 a step, 2 steps an execution: 6 steps an epoch
    whole, _ = run(_dynamic(3), "train")
    run(_dynamic(2), "train", [ModelCheckpoint(dirpath=str(tmp_path), save_last=True)])
    saved = torch.load(tmp_path / "last.ckpt", weights_only=True)
    assert int(saved["state_dict"]["head.step"]) == 12
    resumed, _ = run({**_dynamic(3), "resume_path": str(tmp_path / "last.ckpt")}, "train")
    assert resumed.global_step == whole.global_step == 18
    want, have = whole.state.model.state_dict(), resumed.state.model.state_dict()
    assert int(have["head.step"]) == int(want["head.step"]) == 18
    assert have["head.step"].dtype == torch.int32
    for key in want:
        assert torch.equal(have[key], want[key]), key
