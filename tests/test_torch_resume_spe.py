"""The fit loop's ``steps_per_execution`` and resume against ``torchok_tpu``,
on a ResNet-18 cut to one block a stage at 16x16, f32, on the CPU.

* Both packages from the same Flax weights (carried over by
  ``task_flax_to_state_dict``): ``steps_per_execution`` 4 over a ragged tail
  with a step-interval scheduler, and Adam with ExponentialLR per epoch. The
  step counts and the lr of every execution are equal; the losses agree to
  1e-4 relative. The SGD parameters agree to 2e-5 absolute, as in
  ``test_torch_train_slice.py``; Adam's updates, which reach 3.5e-4 at this
  lr, agree to a tenth of their norm and 2e-4 absolute.
* The port's resume: 2 epochs and a resume from ``last.ckpt`` equal 3
  uninterrupted epochs bit for bit; a ``save_weights_only`` resume restarts
  the optimizer and the schedule.
* The reference's resume restarts its scheduler's count (filed in
  ``ROADMAP.md`` under the reference-side caveats); the port keeps the
  uninterrupted run's schedule.
* ``chip_smoke.py``'s shapes recipe equals ``configs/classification_shapes.yaml``
  under the short budget's overrides.
"""
import copy
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
from torchok_tpu.callbacks import model_checkpoint as jax_mc
from torchok_tpu.constructor import TASKS as JAX_TASKS
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.config_structure import merge_structured as jax_merge
from torchok_tpu.constructor.runner import create_trainer as jax_create_trainer
from torchok_tpu.engine.callbacks import Callback as JaxCallback
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint
from torchok_tpu_torch.constructor.config import config_from_dict, load_config, load_yaml
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.utils.flax_convert import task_flax_to_state_dict

REPO = Path(__file__).resolve().parent.parent
NAME = "resnet18"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's fits: at these sizes more threads
    only contend for the cores with the other test workers (a 3 s test took
    54 s on a loaded machine with torch's default of one a core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_METRIC = {"params": {"task": "multiclass", "num_classes": 10},
           "mapping": {"preds": "prediction", "target": "target"}}


def _data(num_samples, seed, shuffle=False, augment=None, batch=4):
    return [{"dataloader": {"batch_size": batch, "num_workers": 0, "shuffle": shuffle,
                            "drop_last": False},
             "dataset": {"name": "SyntheticShapesDataset",
                         "params": {"num_samples": num_samples, "image_size": [16, 16],
                                    "seed": seed, "hardness": 0.6},
                         "augment": augment,
                         "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}}]


def config(optimizer, scheduler, train_samples, **trainer):
    return {
        "task": {"name": "ClassificationTask",
                 "params": {"backbone_name": NAME,
                            "backbone_params": {"layers": [1, 1, 1, 1], "pretrained": False},
                            "pooling_name": "Pooling", "head_name": "ClassificationHead",
                            "head_params": {"num_classes": 10},
                            "inputs": [{"shape": [3, 16, 16], "dtype": "float32"}]}},
        "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                                   "mapping": {"input": "prediction", "target": "target"}}]},
        "optimization": [{"optimizer": optimizer, "scheduler": scheduler}],
        "data": {"TRAIN": _data(train_samples, 3)},
        "trainer": {"accelerator": "cpu", "precision": 32, "log_every_n_steps": 1,
                    "num_sanity_val_steps": 0, **trainer},
        "seed_params": {"seed": 7},
        "metrics": [{"name": "Accuracy", **_METRIC}],
    }


class _Record:
    """The step, losses and lr at each logged execution; each epoch's logs."""

    def __init__(self):
        self.steps, self.epochs = [], []

    def on_train_batch_end(self, trainer, task, step, logs):
        self.steps.append((step, dict(logs), trainer.current_lr()))

    def on_epoch_end(self, trainer, task, logs):
        self.epochs.append(dict(logs))


class JaxRecord(_Record, JaxCallback):
    def __init__(self, keep_epoch=None):
        super().__init__()
        self.keep_epoch, self.kept = keep_epoch, None

    def on_epoch_end(self, trainer, task, logs):
        super().on_epoch_end(trainer, task, logs)
        if trainer.current_epoch == self.keep_epoch:  # the train step donates its state
            self.kept = jax.device_get(trainer.state)


class PortRecord(_Record, Callback):
    pass


def _variables(state):
    return {"params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


def _fit_jax(cfg, keep_epoch=None, ckpt_path=None):
    """torchok_tpu's fit: (initial variables, final variables, record, trainer)."""
    config_ = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
    task = JAX_TASKS.get(config_.task.name)(config_, **config_.task.params.to_dict())
    trainer = jax_create_trainer(config_)
    record = JaxRecord(keep_epoch)
    trainer.callbacks.append(record)
    initial = {}
    setup = trainer._setup_state

    def setup_and_capture(task_, ckpt_path=None):
        setup(task_, ckpt_path)
        initial.update(_variables(trainer.state))

    trainer._setup_state = setup_and_capture
    trainer.fit(task, ckpt_path=ckpt_path)
    return initial, _variables(trainer.state), record, trainer


def _fit_port(cfg, initial, tmp_path, callbacks=()):
    ckpt = tmp_path / "initial.pt"
    sd = task_flax_to_state_dict(NAME, initial)
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, ckpt)
    record = PortRecord()
    trainer, logs = run({**copy.deepcopy(cfg), "resume_path": str(ckpt)}, "train",
                        [record, *callbacks])
    return trainer, logs, record


def _assert_params(trainer, final, atol, stats_atol=1e-5):
    """Parameters within ``atol`` (with ``None``, only the statistics are
    held here); the running statistics within rtol 1e-4 and ``stats_atol``
    (their inputs come from parameters that far apart)."""
    want = task_flax_to_state_dict(NAME, final)
    got = trainer.state.model.state_dict()
    assert sorted(want) == sorted(got)
    for key, value in got.items():
        stats = "running" in key
        if atol is None and not stats:
            continue
        np.testing.assert_allclose(value.numpy(), want[key], rtol=1e-4 if stats else 0,
                                   atol=stats_atol if stats else atol, err_msg=key)


def _assert_updates(trainer, initial, final, norm_rtol, atol):
    """Each parameter's update (final less initial) against the reference's:
    within ``norm_rtol`` of its norm, and every element within ``atol``."""
    start = task_flax_to_state_dict(NAME, initial)
    want = task_flax_to_state_dict(NAME, final)
    for key, value in trainer.state.model.state_dict().items():
        if "running" in key:
            continue
        got, ref = value.numpy() - start[key], want[key] - start[key]
        assert np.abs(ref).max() > 0, key
        assert np.linalg.norm(got - ref) <= norm_rtol * np.linalg.norm(ref), key
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=key)


def test_steps_per_execution_with_a_ragged_tail_matches_torchok_tpu(tmp_path):
    # 46 samples in super-batches of 4 x 6: executions of 4 and 3 + 1 steps
    # (a tail of 4: BatchNorm over 2 values of ResNet's 1x1 last stage would
    # turn f32 roundings into chaos)
    cfg = config({"name": "SGD", "params": {"lr": 0.01, "momentum": 0.9}},
                 {"name": "StepLR", "params": {"step_size": 1, "gamma": 0.9},
                  "pl_params": {"interval": "step", "frequency": 2}},
                 46, max_epochs=1, steps_per_execution=4)
    cfg["data"]["TRAIN"] = _data(46, 3, batch=6)
    initial, final, ref, ref_trainer = _fit_jax(cfg)
    trainer, logs, got = _fit_port(cfg, initial, tmp_path)
    assert trainer.global_step == ref_trainer.global_step == trainer.state.step == 8
    assert [s for s, _, _ in got.steps] == [s for s, _, _ in ref.steps] == [4, 8]
    # the lr moves between executions only, two scheduler steps each
    assert [lr for _, _, lr in got.steps] == pytest.approx([lr for _, _, lr in ref.steps],
                                                           rel=1e-6)
    assert [lr for _, _, lr in got.steps] == pytest.approx([0.01 * 0.9 ** 2, 0.01 * 0.9 ** 4])
    for (_, g, _), (_, r, _) in zip(got.steps, ref.steps):
        assert g["loss"] == pytest.approx(float(r["loss"]), rel=1e-4)
    assert logs["train/loss"] == pytest.approx(ref.epochs[-1]["train/loss"], rel=1e-4)
    _assert_params(trainer, final, 2e-5)


def test_adam_with_exponential_lr_matches_torchok_tpu_and_resume_keeps_the_schedule(tmp_path):
    # the shapes recipe's lr: at 1e-3, Adam's steps on gradients that are f32
    # noise around zero part the packages' losses by 4e-4 within 6 steps
    cfg = config({"name": "Adam", "params": {"lr": 1e-4}},
                 {"name": "ExponentialLR", "params": {"gamma": 0.5}}, 32, max_epochs=3)
    # 2 steps an epoch of 16 images: at 8 the running means of the first
    # stage, fed by weights 3e-4 apart, part by 3e-3
    cfg["data"]["TRAIN"] = _data(32, 3, batch=16)
    initial, final, ref, ref_trainer = _fit_jax(cfg, keep_epoch=1)
    trainer, logs, got = _fit_port(cfg, initial, tmp_path)
    assert trainer.global_step == ref_trainer.global_step == 6
    assert [e["lr"] for e in got.epochs] == pytest.approx([e["lr"] for e in ref.epochs], rel=1e-6)
    assert [e["lr"] for e in got.epochs] == pytest.approx([5e-5, 2.5e-5, 1.25e-5])
    for g, r in zip(got.epochs, ref.epochs):
        assert g["train/loss"] == pytest.approx(r["train/loss"], rel=1e-4)
    # Adam moves no parameter more than the lrs' sum, 3.5e-4 here: the
    # updates are held to each other, not the endpoints. Measured: each
    # tensor's update within 3.3% (norm) of the reference's, no element
    # more than 8.9e-5 apart; a port that never stepped is 100% apart
    _assert_updates(trainer, initial, final, norm_rtol=0.1, atol=2e-4)
    _assert_params(trainer, final, None, stats_atol=1e-4)

    # the reference resumed after epoch 1 (its state restored as its
    # restore_train_state returns it) keeps the lr in the optimizer state but
    # rebuilds its scheduler at count 0: the schedule starts over, 0.5 ** 1
    # after the next epoch where the uninterrupted run has 0.5 ** 3
    config_ = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
    task = JAX_TASKS.get(config_.task.name)(config_, **config_.task.params.to_dict())
    resumed = jax_create_trainer(config_)
    original = jax_mc.restore_train_state
    try:
        jax_mc.restore_train_state = lambda path, state: (ref.kept, {"epoch": 1,
                                                                      "global_step": 4})
        resumed._setup_state(task, "kept-in-memory")
    finally:
        jax_mc.restore_train_state = original
    scheduler = resumed.bundles[0].scheduler
    assert resumed.current_epoch == 2 and scheduler.last_epoch == 0
    assert scheduler.step() == pytest.approx(5e-5) != pytest.approx(ref.epochs[-1]["lr"])
    assert ref.epochs[-1]["lr"] == pytest.approx(1.25e-5)


def _state(trainer):
    opt = trainer.state.optimizers[0].state_dict()["state"]
    return trainer.state.model.state_dict(), opt, trainer.current_lr()


def test_resume_from_last_ckpt_equals_the_uninterrupted_fit_bit_for_bit(tmp_path):
    cfg = config({"name": "Adam", "params": {"lr": 1e-3}},
                 {"name": "ExponentialLR", "params": {"gamma": 0.5}}, 12, max_epochs=3,
                 steps_per_execution=2)
    # shuffled, and flipped on the device: the loader's and the transform
    # generator's draws must carry on across the resume
    cfg["data"]["TRAIN"] = _data(12, 3, shuffle=True, augment=[{"name": "HorizontalFlip"}])
    whole, _ = run(cfg, "train", [ModelCheckpoint(dirpath=str(tmp_path / "a"), save_last=True)])
    first = copy.deepcopy(cfg)
    first["trainer"]["max_epochs"] = 2
    run(first, "train", [ModelCheckpoint(dirpath=str(tmp_path / "b"), save_last=True)])
    resumed, logs = run({**copy.deepcopy(cfg), "resume_path": str(tmp_path / "b" / "last.ckpt")},
                        "train")
    assert (resumed.global_step, resumed.current_epoch) == (whole.global_step, 2) == (9, 2)
    want, want_opt, want_lr = _state(whole)
    have, have_opt, have_lr = _state(resumed)
    assert have_lr == want_lr == pytest.approx(1.25e-4)
    for key in want:
        assert torch.equal(have[key], want[key]), key
    assert sorted(have_opt) == sorted(want_opt)
    for index, moments in want_opt.items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(have_opt[index][key], moments[key]), (index, key)
    assert logs["lr"] == pytest.approx(1.25e-4)


def test_a_weights_only_resume_restarts_the_optimizer_and_schedule(tmp_path):
    cfg = config({"name": "Adam", "params": {"lr": 1e-3}},
                 {"name": "ExponentialLR", "params": {"gamma": 0.5}}, 8, max_epochs=2)
    saver = ModelCheckpoint(dirpath=str(tmp_path), save_last=True, save_weights_only=True)
    first, _ = run(cfg, "train", [saver])
    ckpt = torch.load(tmp_path / "last.ckpt", weights_only=True)
    assert "optimizer_states" not in ckpt and (ckpt["epoch"], ckpt["global_step"]) == (1, 4)
    resumed, logs = run({**copy.deepcopy(cfg), "resume_path": str(tmp_path / "last.ckpt"),
                         "trainer": {**cfg["trainer"], "max_epochs": 3}}, "train")
    assert resumed.global_step == 6
    steps = {int(s["step"]) for s in resumed.state.optimizers[0].state_dict()["state"].values()}
    assert steps == {2}  # a fresh Adam: one epoch's two steps, not six
    assert logs["lr"] == pytest.approx(5e-4)  # a fresh schedule: one epoch's decay


def test_shapes_recipe_equals_chip_smoke_config():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert load_yaml(REPO / "configs" / "classification_shapes.yaml") == chip_smoke.SHAPES_RECIPE
    overrides = ["trainer.max_epochs=6", "data.TRAIN.0.dataset.params.num_samples=8000"]
    assert chip_smoke.SHAPES_OVERRIDES == overrides
    want = load_config(REPO / "configs", "classification_shapes",
                       overrides + ["logger.log_dir=/somewhere"])
    assert config_from_dict(chip_smoke.shapes_config("/somewhere")) == want
    assert want.trainer.steps_per_execution == 16 and want.trainer.max_epochs == 6
