"""The port's SwinV2 classification train slice end to end on the CPU,
against ``torchok_tpu`` run on the same config, data and initial weights.

``torchok_tpu`` runs ``Trainer.fit`` with its Pallas attention kernels
(forward and backward) in interpret mode; the port runs ``__main__.run(...,
"train")`` with ``accelerator: cpu`` (plain attention forward and backward)
from the Flax initial weights carried over by ``task_flax_to_state_dict`` and
loaded through ``resume_path``. f32, no drop path, no shuffling.
"""
import copy
import json
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
from torchok_tpu.engine.callbacks import Callback as JaxCallback
from torchok_tpu.tasks.base import BaseTask as JaxBaseTask
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.ops import swin_attention as ops
from torchok_tpu_torch.ops.common import Dropout, DropPath, install_dropout_generator
from torchok_tpu_torch.utils.flax_convert import (state_dict_to_task_flax,
                                                  task_flax_to_state_dict, task_name_map)

REPO = Path(__file__).resolve().parent.parent
BACKBONE = dict(img_size=32, patch_size=4, window_size=4, embed_dim=16,
                depths=[2, 2], num_heads=[2, 4], drop_path_rate=0.0, pretrained=False)
_METRIC = {"params": {"task": "multiclass", "num_classes": 10},
           "mapping": {"preds": "prediction", "target": "target"}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's fits: at these sizes more threads
    only contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _persist_every_compile():
    """The persistent compilation cache keeps every compile of the JAX
    fits, not only those over half a second: a fit compiles some forty
    executables, most of them small."""
    least = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", least)


@pytest.fixture(autouse=True)
def _jitted_jax_init(monkeypatch):
    """The JAX task's initial variables from one jitted init. Eagerly, Flax
    compiles each of the init's ~200 primitives on its own (20 s of the
    first fit here), and the persistent compilation cache keeps none of
    them; one jitted init is one compile, which it keeps. The port
    starts from whatever the JAX init gives, so the comparisons are those
    of an eager init."""
    init = JaxBaseTask.init_variables
    monkeypatch.setattr(JaxBaseTask, "init_variables", lambda self, rng, batch=None:
                        jax.jit(lambda key: init(self, key, batch))(rng))


def _data(num_samples, seed, shuffle=False, size=32):
    # an even batch: the JAX tests simulate two devices
    return [{"dataloader": {"batch_size": 4, "num_workers": 0, "shuffle": shuffle,
                            "drop_last": True},
             "dataset": {"name": "SyntheticClassificationDataset",
                         "params": {"num_samples": num_samples, "num_classes": 10,
                                    "image_size": [size, size], "seed": seed},
                         "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}}]


def small_config(optimizer, backbone_name="swinv2_custom", backbone_params=BACKBONE, **trainer):
    return {
        "task": {"name": "ClassificationTask",
                 "params": {"backbone_name": backbone_name,
                            "backbone_params": copy.deepcopy(backbone_params),
                            "pooling_name": "Pooling", "head_name": "ClassificationHead",
                            "head_params": {"num_classes": 10},
                            "inputs": [{"shape": [3, 32, 32], "dtype": "float32"}]}},
        "joint_loss": {"losses": [{"name": "CrossEntropyLoss", "tag": "ce",
                                   "mapping": {"input": "prediction", "target": "target"}}]},
        "optimization": [{"optimizer": optimizer}],
        # 5 train steps per epoch, one epoch, 2 validation batches
        "data": {"TRAIN": _data(20, 3), "VALID": _data(8, 4)},
        "trainer": {"accelerator": "cpu", "precision": 32, "max_epochs": 1,
                    "log_every_n_steps": 1, **trainer},
        "seed_params": {"seed": 7},
        "metrics": [{"name": "Accuracy", **_METRIC}],
    }


class _Steps:
    """Per-step host losses and the last epoch's logs."""

    def __init__(self):
        self.steps, self.epochs, self.rng_states = [], [], []

    def on_fit_start(self, trainer, task):
        self.rng_states.append(torch.get_rng_state())

    def on_fit_end(self, trainer, task):
        self.rng_states.append(torch.get_rng_state())

    def on_train_batch_end(self, trainer, task, step, logs):
        self.steps.append(dict(logs))

    def on_epoch_end(self, trainer, task, logs):
        self.epochs.append(dict(logs))


class JaxRecorder(_Steps, JaxCallback):
    pass


class PortRecorder(_Steps, Callback):
    pass


def _fit_jax(cfg):
    """torchok_tpu's fit: (initial params, final params, recorder)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TORCHOK_WINDOW_ATTN_PALLAS", "1")
    # the initial variables from one jitted init, which the persistent
    # compilation cache keeps (an eager init compiles each of its primitives
    # on its own and keeps none); the port starts from whatever it gives
    init = JaxBaseTask.init_variables
    mp.setattr(JaxBaseTask, "init_variables", lambda self, rng, batch=None:
               jax.jit(lambda key: init(self, key, batch))(rng))
    try:
        config = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
        task = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
        trainer = jax_create_trainer(config)
        recorder = JaxRecorder()
        trainer.callbacks.append(recorder)
        initial = {}
        setup = trainer._setup_state

        def setup_and_capture(task_, ckpt_path=None):
            setup(task_, ckpt_path)
            initial["params"] = jax.tree_util.tree_map(np.asarray, trainer.state.params)

        trainer._setup_state = setup_and_capture
        trainer.fit(task)
        final = jax.tree_util.tree_map(np.asarray, trainer.state.params)
    finally:
        mp.undo()
    return initial["params"], final, recorder


def _fit_port(cfg, initial, tmp_path):
    ckpt = tmp_path / "initial.pt"
    sd = task_flax_to_state_dict(cfg["task"]["params"]["backbone_name"], {"params": initial})
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    cfg = copy.deepcopy(cfg)
    cfg["resume_path"] = str(ckpt)
    recorder = PortRecorder()
    before = dict(ops.LAUNCHES)
    trainer, logs = run(cfg, "train", [recorder])
    launched = {k: n - before.get(k, 0) for k, n in ops.LAUNCHES.items() if n > before.get(k, 0)}
    return trainer, logs, recorder, launched


# Adam divides by sqrt(v): where a gradient is f32 noise around zero the two
# packages may step in different directions, so after 5 steps of lr 1e-3 a
# parameter may differ by a few steps' worth. SGD's difference scales with the
# gradient difference itself, so it is held much tighter (at lr 0.05 with
# momentum the loss bounces between 1.6 and 3.4 and rounding differences grow
# tenfold per step, hence lr 0.01 there).
CASES = {
    "adam": ({"name": "Adam", "params": {"lr": 1e-3}}, {}, 2e-3),
    "sgd_momentum": ({"name": "SGD", "params": {"lr": 0.01, "momentum": 0.9,
                                                "weight_decay": 1e-3}}, {}, 2e-5),
    "sgd_clip_accumulate": ({"name": "SGD", "params": {"lr": 0.05}},
                            {"gradient_clip_val": 0.5, "accumulate_grad_batches": 2}, 2e-5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_torchok_tpu_over_5_steps(case, tmp_path):
    optimizer, trainer_keys, param_atol = CASES[case]
    cfg = small_config(optimizer, **trainer_keys)
    initial, final, ref = _fit_jax(cfg)
    trainer, logs, got, launched = _fit_port(cfg, initial, tmp_path)

    # 5 steps + 2 sanity + 2 validation batches, 4 blocks each, all plain on the CPU
    assert launched == {ops.PLAIN: 4 * 9, ops.PLAIN_BWD: 4 * 5}
    assert trainer.global_step == trainer.state.step == 5 and trainer.last_fit["steps"] == 5
    assert len(got.steps) == len(ref.steps) == 5
    for step, (g, r) in enumerate(zip(got.steps, ref.steps)):
        assert set(g) == set(r) == {"loss", "ce"}
        for key in g:
            # f32 on both sides, other summation orders: 1e-4 relative
            assert g[key] == pytest.approx(r[key], rel=1e-4), f"step {step} {key}"
    assert got.steps[0]["loss"] != got.steps[-1]["loss"]

    ref_logs = ref.epochs[-1]
    assert set(logs) == set(ref_logs)
    assert logs["valid/Accuracy"] == ref_logs["valid/Accuracy"]
    assert logs["train/Accuracy"] == ref_logs["train/Accuracy"]
    assert logs["lr"] == pytest.approx(ref_logs["lr"], rel=1e-6)  # JAX reads back an f32 leaf
    for key in ("train/loss", "train/ce", "valid/loss", "valid/ce"):
        assert logs[key] == pytest.approx(ref_logs[key], rel=1e-4), key

    want = task_flax_to_state_dict("swinv2_custom", {"params": final})
    state_dict = trainer.state.model.state_dict()
    assert sorted(want) == sorted(state_dict)
    moved = 0
    for key, value in state_dict.items():
        np.testing.assert_allclose(value.numpy(), want[key], rtol=0, atol=param_atol,
                                   err_msg=key)
        start = task_flax_to_state_dict("swinv2_custom", {"params": initial})[key]
        moved += bool(np.abs(value.numpy() - start).max() > 0)
    assert moved > 0.9 * len(state_dict)


def test_name_map_round_trip():
    cfg = small_config({"name": "SGD", "params": {"lr": 0.1}})
    config = jax_merge(JaxConfigNode(cfg))
    task = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    params = jax.tree_util.tree_map(np.asarray,
                                    task.init_variables(jax.random.PRNGKey(0))["params"])
    sd = task_flax_to_state_dict("swinv2_custom", {"params": params})
    assert sorted(task_name_map("swinv2_custom", {"params": params})) == sorted(sd)
    back = state_dict_to_task_flax("swinv2_custom", sd, {"params": params})
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# port-only behaviour
# ---------------------------------------------------------------------------
def _grads(grad_checkpointing, seed, drop_path_rate=0.3):
    backbone = BACKBONES.get("swinv2_custom")(**{**BACKBONE, "drop_path_rate": drop_path_rate,
                                                 "grad_checkpointing": grad_checkpointing})
    init = torch.Generator().manual_seed(0)
    for p in backbone.parameters():
        with torch.no_grad():
            p.copy_(0.1 * torch.randn(p.shape, generator=init))
    generator = torch.Generator().manual_seed(seed)
    install_dropout_generator(backbone, generator)
    backbone.train()
    x = torch.randn((4, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    out = backbone(x)
    out.square().mean().backward()
    after = generator.get_state()
    return out.detach(), {n: p.grad for n, p in backbone.named_parameters()
                          if p.grad is not None}, after


def test_grad_checkpointing_gives_the_same_gradients_with_drop_path():
    out_a, grads_a, state_a = _grads(False, seed=3)
    before = dict(ops.LAUNCHES)
    out_b, grads_b, state_b = _grads(True, seed=3)
    # every block's forward ran twice (once recomputed), its backward once
    assert ops.LAUNCHES[ops.PLAIN] - before.get(ops.PLAIN, 0) == 8
    assert ops.LAUNCHES[ops.PLAIN_BWD] - before.get(ops.PLAIN_BWD, 0) == 4
    torch.testing.assert_close(out_b, out_a, rtol=0, atol=0)
    assert grads_a.keys() == grads_b.keys() and len(grads_a) > 40
    for name in grads_a:
        # the recomputation redraws the same drop-path masks: same arithmetic
        torch.testing.assert_close(grads_b[name], grads_a[name], rtol=1e-6, atol=1e-7, msg=name)
    # and the generator ends where the plain run left it
    assert torch.equal(state_a, state_b)
    out_c, _, _ = _grads(True, seed=4)
    assert not torch.equal(out_c, out_a)


def test_drop_path_is_seeded_and_leaves_the_global_rng_alone():
    cfg = small_config({"name": "Adam", "params": {"lr": 1e-3}}, num_sanity_val_steps=0)
    cfg["task"]["params"]["backbone_params"]["drop_path_rate"] = 0.5
    cfg["data"]["TRAIN"] = _data(20, 3, shuffle=True)

    def losses(seed):
        c = copy.deepcopy(cfg)
        c["seed_params"]["seed"] = seed
        recorder = PortRecorder()
        run(c, "train", [recorder])
        # module constructors draw their default init from the global state;
        # from the start of fit to its end (5 train steps with drop path,
        # shuffling, validation) nothing may
        start, end = recorder.rng_states
        assert torch.equal(start, end), "fit drew from torch's global RNG"
        return [s["loss"] for s in recorder.steps]

    first = losses(7)
    assert losses(7) == first
    assert losses(8) != first

    cfg["task"]["params"]["backbone_params"]["drop_path_rate"] = 0.0
    recorder = PortRecorder()
    run(cfg, "train", [recorder])
    assert [s["loss"] for s in recorder.steps] != first  # drop path really dropped


def test_dropout_modules_need_and_use_the_generator():
    x = torch.ones(8, 16)
    for module in (DropPath(0.5), Dropout(0.5)):
        module.train()
        with pytest.raises(RuntimeError, match="no generator"):
            module(x)
        install_dropout_generator(module, torch.Generator().manual_seed(1))
        a = module(x)
        install_dropout_generator(module, torch.Generator().manual_seed(1))
        assert torch.equal(module(x), a)
        assert set(a.unique().tolist()) == {0.0, 2.0}
        module.eval()
        assert module(x) is x
    assert DropPath(0.0).train()(x) is x


def test_step_scheduler_writes_the_lr_into_the_param_groups():
    cfg = small_config({"name": "SGD", "params": {"lr": 0.1},
                        "paramwise_cfg": {"bias_lr_mult": 2.0}}, num_sanity_val_steps=0)
    cfg["optimization"][0]["scheduler"] = {
        "name": "StepLR", "params": {"step_size": 1, "gamma": 0.5},
        "pl_params": {"interval": "step", "frequency": 2}}
    trainer, logs = run(cfg, "train")
    # 5 steps, a scheduler step every 2: base lr 0.2 (the largest group's) halved twice
    assert logs["lr"] == pytest.approx(0.2 * 0.25)
    groups = {g["label"]: g["lr"] for g in trainer.bundles[0].optimizer.param_groups}
    assert groups == pytest.approx({"lr1.0_wd0.0": 0.025, "lr1.0_wd1.0": 0.025,
                                    "lr2.0_wd0.0": 0.05})


def test_max_steps_and_limits():
    cfg = small_config({"name": "SGD", "params": {"lr": 0.1}}, max_steps=3,
                       limit_val_batches=1, num_sanity_val_steps=1)
    cfg["trainer"]["max_epochs"] = 4
    trainer, logs = run(cfg, "train")
    assert trainer.global_step == 3 and trainer.current_epoch == 0 and trainer.should_stop
    assert "valid/Accuracy" in logs and trainer.last_eval["images"] == 4


@pytest.mark.parametrize("key,value", [
    ("steps_per_execution", 2), ("overfit_batches", 2), ("val_check_interval", 0.5),
    ("max_time", "00:00:01:00"), ("reload_dataloaders_every_n_epochs", 1),
    ("enable_checkpointing", True), ("detect_anomaly", True)])
def test_fit_only_keys_raise_in_fit_and_not_in_test(key, value, tmp_path, monkeypatch):
    cfg = small_config({"name": "SGD", "params": {"lr": 0.1}}, **{key: value})
    if key == "steps_per_execution":  # ported: super-batches of 2 x 4 with drop_last
        trainer, _ = run(cfg, "train")
        assert trainer.global_step == trainer.state.step == 4  # 20 samples: 2 executions
    elif key == "enable_checkpointing":  # ported: the default ModelCheckpoint
        monkeypatch.chdir(tmp_path)  # with no logger: ./checkpoints/checkpoints, as the reference
        run(cfg, "train")
        assert sorted(p.name for p in (tmp_path / "checkpoints" / "checkpoints").iterdir()) \
            == ["epoch=0-step=5.ckpt"]
    else:
        with pytest.raises(NotImplementedError, match=f"trainer.{key}"):
            run(cfg, "train")
    cfg["data"]["TEST"] = cfg["data"]["VALID"]
    assert "test/Accuracy" in run(cfg, "test")[1]


def test_unported_sections_raise():
    base = small_config({"name": "SGD", "params": {"lr": 0.1}})
    for patch, match in (
            ({"logger": {"name": "WandbLogger", "log_dir": "/tmp/x"}}, "WandbLogger"),
            ({"callbacks": [{"name": "StochasticWeightAveraging"}]},
             "StochasticWeightAveraging"),
            ({"optimization": base["optimization"] * 2}, "2 optimization groups"),
            ({"optimization": [{"optimizer": {"name": "Lamb", "params": {"lr": 0.1}}}]},
             "Lamb is not ported")):
        with pytest.raises(NotImplementedError, match=match):
            run({**copy.deepcopy(base), **patch}, "train")
    two = copy.deepcopy(base)
    two["data"]["TRAIN"] = two["data"]["TRAIN"] * 2
    with pytest.raises(NotImplementedError, match="2 TRAIN dataloaders"):
        run(two, "train")
    with pytest.raises(ValueError, match="No TRAIN data"):
        run({**copy.deepcopy(base), "data": {"VALID": base["data"]["VALID"]}}, "train")
    with pytest.raises(ValueError, match="gradient_clip_algorithm"):
        run(small_config(base["optimization"][0]["optimizer"],
                         gradient_clip_algorithm="sign"), "train")


def test_resuming_optimizer_state_raises(tmp_path):
    """Resuming optimizer state is ported: a ModelCheckpoint file restores
    the momentum buffers, the epoch and the step counts."""
    from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint
    cfg = small_config({"name": "SGD", "params": {"lr": 0.1, "momentum": 0.9}})
    trainer, _ = run(cfg, "train", [ModelCheckpoint(dirpath=str(tmp_path), save_last=True)])
    cfg["resume_path"] = str(tmp_path / "last.ckpt")
    resumed, _ = run(cfg, "train")  # max_epochs 1: nothing is left to train
    assert (resumed.current_epoch, resumed.global_step, resumed.state.step) == (1, 5, 5)
    saved = trainer.state.optimizers[0].state_dict()["state"]
    got = resumed.state.optimizers[0].state_dict()["state"]
    assert sorted(got) == sorted(saved) and len(got) > 10
    for key in saved:
        assert torch.equal(got[key]["momentum_buffer"], saved[key]["momentum_buffer"])


def test_clip_by_value_and_on_exception_hook():
    class Boom(Callback):
        seen = None

        def on_train_epoch_end(self, trainer, task, logs):
            raise KeyError("boom")

        def on_exception(self, trainer, task, exception):
            Boom.seen = exception

    cfg = small_config({"name": "SGD", "params": {"lr": 0.1}}, gradient_clip_val=1e-3,
                       gradient_clip_algorithm="value", num_sanity_val_steps=0)
    with pytest.raises(KeyError, match="boom"):
        run(cfg, "train", [Boom()])
    assert isinstance(Boom.seen, KeyError)
    trainer, _ = run(cfg, "train")
    start = run({**cfg, "data": {"TEST": cfg["data"]["VALID"]}}, "test")[0].state.model.state_dict()
    # 5 SGD steps of lr 0.1 on gradients clamped to 1e-3 move nothing further than 5e-4
    for key, value in trainer.state.model.state_dict().items():
        assert (value - start[key]).abs().max().item() <= 5e-4 + 1e-7, key


@pytest.mark.parametrize("accelerator", ["gpu", "auto"])
def test_gpu_accelerator_raises_without_a_card_in_train_mode(monkeypatch, accelerator):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small_config({"name": "SGD", "params": {"lr": 0.1}}, accelerator=accelerator)
    with pytest.raises(RuntimeError, match="CUDA device"):
        run(cfg, "train")


def test_cli_trains_on_the_cpu_and_prints_the_epoch_lines(tmp_path):
    """The CLI surface in a process of its own: YAML + overrides, mode
    ``train`` by default."""
    cfg = small_config({"name": "Adam", "params": {"lr": 1e-3}})
    cfg["trainer"]["accelerator"] = "gpu"  # the override below asks for the CPU
    (tmp_path / "small.yaml").write_text(json.dumps(cfg))  # JSON is valid YAML
    out = subprocess.run(
        [sys.executable, "-m", "torchok_tpu_torch", "-cp", str(tmp_path), "-cn", "small",
         "trainer.accelerator=cpu", "trainer.max_epochs=2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("epoch ")]
    assert len(lines) == 2 and lines[1].startswith("epoch 1 | ")
    for part in ("train/loss=", "train/ce=", "valid/Accuracy=", "valid/loss=", "lr=0.0010"):
        assert part in lines[0]
    assert "10 train steps, 40 images" in out.stdout


def test_train_recipe_equals_chip_smoke_config():
    import importlib.util
    from torchok_tpu_torch.constructor.config import load_config
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    yaml_cfg = load_config(REPO / "configs", "classification_swinv2_tiny_synthetic_train")
    assert yaml_cfg.to_dict() == chip_smoke.TRAIN_CONFIG
    smoke = chip_smoke.smoke_train_config(10)
    assert smoke["data"]["TRAIN"][0]["dataset"]["params"]["num_samples"] == 128
    assert {k: v for k, v in smoke.items() if k not in ("data", "trainer")} \
        == {k: v for k, v in chip_smoke.TRAIN_CONFIG.items() if k not in ("data", "trainer")}
