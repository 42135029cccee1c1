"""The port's loggers, common callbacks, ModelCheckpoint and the runner's
callback assembly against ``torchok_tpu``'s, driven with the same calls.

CSVLogger's files are compared byte for byte; ModelCheckpoint's kept files,
best path and best score exactly over one metric sequence (the reference's
Orbax writer is replaced by a stub that makes the checkpoint directory, the
port writes real files); the stop epochs of EarlyStopping and Timer exactly.
"""
import copy
import json

import jax
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.callbacks import common as jax_common
from torchok_tpu.callbacks import model_checkpoint as jax_mc
from torchok_tpu.constructor import TASKS as JAX_TASKS
from torchok_tpu.constructor import logger as jax_logger
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.config_structure import merge_structured as jax_merge
from torchok_tpu.constructor.runner import create_trainer as jax_create_trainer
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.callbacks import common
from torchok_tpu_torch.constructor import CALLBACKS, LOGGERS, TASKS
from torchok_tpu_torch.constructor import logger as port_logger
from torchok_tpu_torch.constructor.config import config_from_dict
from torchok_tpu_torch.constructor.config_structure import merge_structured
from torchok_tpu_torch.constructor.runner import create_trainer
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.engine.state import TrainState


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's fits: at these sizes more threads
    only contend for the cores with the other test workers (a 3 s test took
    54 s on a loaded machine with torch's default of one a core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HPARAMS = {"task": {"name": "ClassificationTask", "params": {"num_classes": 10}},
           "trainer": {"max_epochs": 3, "precision": 16}, "seed_params": {"seed": 42}}
LOG_CALLS = [({"train/loss": 2.25}, 50), ({"train/loss": 1.5, "valid/Accuracy": 0.25}, 96),
             ({"lr": 9.7e-05, "valid/F1Score": 0.3125, "train/loss": 1.0}, 144)]


def _drive_logger(cls, log_dir):
    log = cls(log_dir=str(log_dir), experiment_name="exp", timestamp="2026-01-01/00-00-00")
    log.log_hyperparams(HPARAMS)
    for metrics, step in LOG_CALLS:
        log.log_metrics(metrics, step=step)
    log.finalize("success")
    return log


def test_csv_logger_writes_the_references_files_byte_for_byte(tmp_path):
    ref = _drive_logger(jax_logger.CSVLogger, tmp_path / "jax")
    got = _drive_logger(LOGGERS.get("CSVLogger"), tmp_path / "port")
    assert got.log_dir == str(tmp_path / "port" / "exp" / "2026-01-01" / "00-00-00")
    for name in ("hparams.json", "metrics.csv", "status.txt"):
        assert (got.save_dir / name).read_bytes() == (ref.save_dir / name).read_bytes(), name
    assert (got.save_dir / "status.txt").read_text() == "success"


def _scalars(log_dir):
    """(tag, step, value) of every scalar in the event files under ``log_dir``
    (TFRecord framing: length, its CRC, the serialized Event, its CRC)."""
    import struct
    from pathlib import Path

    from tensorboardX.proto.event_pb2 import Event
    out = []
    for path in sorted(Path(log_dir).glob("events.out.tfevents.*")):
        data, pos = path.read_bytes(), 0
        while pos < len(data):
            (length,) = struct.unpack("<Q", data[pos:pos + 8])
            event = Event.FromString(data[pos + 12:pos + 12 + length])
            pos += 16 + length
            out += [(v.tag, event.step, v.simple_value) for v in event.summary.value]
    return out


def test_tensorboard_logger_writes_readable_scalars_and_needs_tensorboardx(tmp_path, monkeypatch):
    got = _drive_logger(LOGGERS.get("TensorBoardLogger"), tmp_path)
    scalars = _scalars(got.log_dir)
    assert sorted({tag for tag, _, _ in scalars}) == ["lr", "train/loss", "valid/Accuracy",
                                                      "valid/F1Score"]
    assert [(step, v) for tag, step, v in scalars if tag == "train/loss"] \
        == [(50, 2.25), (96, 1.5), (144, 1.0)]
    monkeypatch.setitem(__import__("sys").modules, "tensorboardX", None)
    with pytest.raises(ImportError):
        LOGGERS.get("TensorBoardLogger")(log_dir=str(tmp_path / "no"), experiment_name="x")


@pytest.mark.parametrize("name", ["MLFlowLogger", "MLFlowLoggerX", "WandbLogger",
                                  "NeptuneLogger"])
def test_loggers_not_ported_raise_by_name(name, tmp_path):
    with pytest.raises(NotImplementedError, match=name):
        port_logger.create_logger(config_from_dict({"name": name, "log_dir": str(tmp_path)}))


class _Stub:
    """What a callback reads of a trainer."""

    def __init__(self, state=None):
        self.logger = None
        self.state = state
        self.bundles = []
        self.current_epoch = 0
        self.global_step = 0
        self.callback_metrics = {}
        self.max_epochs = 10

    def current_lr(self):
        return 0.1


def _port_state():
    model = torch.nn.Linear(3, 2)
    return TrainState(model=model, optimizers=[torch.optim.SGD(model.parameters(), lr=0.1)])


SCORES = [0.5, 0.7, 0.6, 0.9, 0.8, 0.65]
CHECKPOINTS = {
    **{f"{mode}-top{k}": {"monitor": "valid/F1Score", "mode": mode, "save_top_k": k}
       for mode in ("min", "max") for k in (0, 1, 2, -1)},
    "no-monitor": {"monitor": None, "save_last": True},
    "every-2": {"monitor": "valid/F1Score", "mode": "max", "save_top_k": 2,
                "every_n_epochs": 2},
    "template": {"monitor": "valid/F1Score", "mode": "max", "save_top_k": 2,
                 "filename": "best-{epoch:02d}-{step}", "save_last": True},
    "async": {"monitor": "valid/F1Score", "mode": "max", "save_top_k": 1, "save_last": True,
              "save_async": True},
}


@pytest.mark.parametrize("case", list(CHECKPOINTS))
def test_model_checkpoint_keeps_the_references_files(case, tmp_path, monkeypatch):
    def stub_save(path, state, meta=None, background=False):
        import pathlib
        pathlib.Path(path).mkdir(parents=True, exist_ok=True)

    monkeypatch.setattr(jax_mc, "save_train_state", stub_save)
    params = CHECKPOINTS[case]
    ref = jax_mc.ModelCheckpoint(dirpath=str(tmp_path / "jax"), **params)
    got = CALLBACKS.get("ModelCheckpoint")(dirpath=str(tmp_path / "port"), **params)
    jax_trainer, port_trainer = _Stub(), _Stub(_port_state())
    for cb, trainer in ((ref, jax_trainer), (got, port_trainer)):
        cb.setup(trainer, None)
        for epoch, score in enumerate(SCORES):
            trainer.current_epoch, trainer.global_step = epoch, 4 * (epoch + 1)
            logs = {"valid/F1Score": score, "train/loss": 1.0 / (epoch + 1)}
            trainer.callback_metrics = dict(logs)
            cb.on_epoch_end(trainer, None, logs)
        cb.on_fit_end(trainer, None)
    kept = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert kept == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert got.best_model_score == ref.best_model_score
    assert (got.best_model_path is None) == (ref.best_model_path is None)
    if ref.best_model_path is not None:
        assert got.best_model_path.split("/")[-1] == ref.best_model_path.split("/")[-1]
    assert [s for s, _ in got.best_k] == [s for s, _ in ref.best_k]
    for name in kept:  # each file holds its epoch's state and logs
        ckpt = torch.load(tmp_path / "port" / name, weights_only=True)
        assert set(ckpt) == {"state_dict", "optimizer_states", "lr_schedulers", "epoch",
                             "global_step", "monitor", "metrics"}
        assert ckpt["global_step"] == 4 * (ckpt["epoch"] + 1)
        assert ckpt["metrics"]["valid/F1Score"] == SCORES[ckpt["epoch"]]


def test_a_failed_background_write_is_raised(tmp_path, monkeypatch):
    # one write an epoch: last.ckpt (the monitor is never logged)
    got = CALLBACKS.get("ModelCheckpoint")(dirpath=str(tmp_path), monitor="valid/loss",
                                          save_last=True, save_async=True)
    trainer = _Stub(_port_state())
    got.setup(trainer, None)

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    got.on_epoch_end(trainer, None, {})
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        got.on_fit_end(trainer, None)
    got.on_epoch_end(trainer, None, {})
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        got.on_exception(trainer, None, KeyError("x"))
    assert list(tmp_path.iterdir()) == []


def test_early_stopping_and_timer_stop_where_the_references_do(monkeypatch):
    losses = [1.0, 0.8, 0.81, 0.79, 0.85, 0.9, 0.95, 0.7]
    for params in ({"monitor": "valid/loss", "patience": 2},
                   {"monitor": "valid/loss", "patience": 2, "min_delta": 0.05},
                   {"monitor": "valid/loss", "patience": 1, "mode": "max"}):
        stops = []
        for cls in (jax_common.EarlyStopping, CALLBACKS.get("EarlyStopping")):
            cb, trainer = cls(**params), _Stub()
            stop = None
            for epoch, value in enumerate(losses):
                cb.on_epoch_end(trainer, None, {"valid/loss": value})
                if stop is None and cb.should_stop(trainer):
                    stop = epoch
            stops.append((stop, cb.best, cb.wait))
        assert stops[0] == stops[1], params
    clock = {"t": 0.0}
    monkeypatch.setattr(jax_common.time, "monotonic", lambda: clock["t"])
    monkeypatch.setattr(common.time, "monotonic", lambda: clock["t"])
    stops = []
    for cls in (jax_common.Timer, CALLBACKS.get("Timer")):
        clock["t"] = 0.0
        cb, trainer = cls(duration="00:00:01:30"), _Stub()
        cb.on_fit_start(trainer, None)
        stop = None
        for epoch in range(5):
            clock["t"] += 25.0
            cb.on_epoch_end(trainer, None, {})
            if stop is None and cb.should_stop(trainer):
                stop = epoch
        stops.append(stop)
    assert stops == [3, 3]


@pytest.mark.parametrize("exception,status", [(KeyError("x"), "FAILED"),
                                              (KeyboardInterrupt(), "KILLED")])
def test_finalize_logger_writes_the_status(exception, status, tmp_path):
    for cls, log_cls, root in ((jax_common.FinalizeLogger, jax_logger.CSVLogger, "jax"),
                               (CALLBACKS.get("FinalizeLogger"), LOGGERS.get("CSVLogger"),
                                "port")):
        trainer = _Stub()
        trainer.logger = log_cls(log_dir=str(tmp_path / root), experiment_name="e",
                                 timestamp="t")
        cls().on_exception(trainer, None, exception)
        assert (trainer.logger.save_dir / "status.txt").read_text() == status


SMALL = {
    "task": {"name": "ClassificationTask",
             "params": {"backbone_name": "resnet18",
                        "backbone_params": {"layers": [1, 1, 1, 1], "pretrained": False},
                        "pooling_name": "Pooling", "head_name": "ClassificationHead",
                        "head_params": {"num_classes": 10},
                        "inputs": [{"shape": [3, 16, 16], "dtype": "float32"}]}},
    "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                               "mapping": {"input": "prediction", "target": "target"}}]},
    "optimization": [{"optimizer": {"name": "SGD", "params": {"lr": 0.01}}}],
    "data": {"TRAIN": [{"dataloader": {"batch_size": 4, "num_workers": 0, "drop_last": True},
                        "dataset": {"name": "SyntheticShapesDataset",
                                    "params": {"num_samples": 8, "image_size": [16, 16]},
                                    "transform": [{"name": "Normalize"},
                                                  {"name": "ToTensorV2"}]}}]},
    "trainer": {"accelerator": "cpu", "max_epochs": 1},
    "metrics": [],
}


def test_model_summary_totals_match_the_flax_tree(capsys):
    config = jax_merge(JaxConfigNode(copy.deepcopy(SMALL)))
    task = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    # the summary counts shapes: the init is traced for them, not run
    variables = jax.eval_shape(task.init_variables, jax.random.PRNGKey(0))
    state = type("S", (), {})()
    state.params = variables["params"]
    state.batch_stats = variables.get("batch_stats", {})
    state.buffers = {}
    state.grad_mask = jax.tree_util.tree_map(lambda x: np.ones((), np.float32), state.params)
    trainer = _Stub(state)
    jax_common.ModelSummary().on_fit_start(trainer, None)
    ref = capsys.readouterr().out.splitlines()

    config = merge_structured(config_from_dict(copy.deepcopy(SMALL)))
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    task.init_weights(torch.Generator().manual_seed(0))
    CALLBACKS.get("ModelSummary")().on_fit_start(_Stub(TrainState(model=task.model)), None)
    got = capsys.readouterr().out.splitlines()
    assert got[-4:] == ref[-4:]  # trainable, non-trainable, norm stats, total
    assert [ln.split()[-1] for ln in got[:-4]] == [ln.split()[-1] for ln in ref[:-4]]
    assert got[-2] == "Norm stats / buffers: 0.01M" and got[-1].startswith("Total params: 4.")


def _callback_names(trainer):
    return [type(cb).__name__ for cb in trainer.callbacks]


@pytest.mark.parametrize("trainer_keys,callbacks", [
    ({"enable_checkpointing": True}, []),
    ({"enable_checkpointing": True}, [{"name": "ModelCheckpoint"}]),
    ({"enable_checkpointing": None, "enable_model_summary": True}, [{"name": "FinalizeLogger"}]),
    ({"barebones": True}, [{"name": "ModelCheckpoint"}, {"name": "TQDMProgressBar"},
                           {"name": "ModelSummary"}, {"name": "EarlyStopping",
                                                      "params": {"monitor": "valid/loss"}}]),
])
def test_runner_assembles_the_references_callbacks(trainer_keys, callbacks, tmp_path):
    cfg = copy.deepcopy(SMALL)
    cfg["trainer"].update(trainer_keys)
    cfg["callbacks"] = callbacks
    cfg["logger"] = {"name": "CSVLogger", "log_dir": str(tmp_path), "timestamp": "t"}
    ref = jax_create_trainer(jax_merge(JaxConfigNode(copy.deepcopy(cfg))))
    got = create_trainer(merge_structured(config_from_dict(copy.deepcopy(cfg))))
    assert _callback_names(got) == _callback_names(ref)
    assert (got.logger is None) == (ref.logger is None)
    if got.logger is not None:
        assert type(got.logger).__name__ == "CSVLogger"


def test_runner_refuses_a_checkpoint_with_checkpointing_off():
    cfg = copy.deepcopy(SMALL)
    cfg["trainer"]["enable_checkpointing"] = False
    cfg["callbacks"] = [{"name": "ModelCheckpoint"}]
    with pytest.raises(ValueError, match="enable_checkpointing=false"):
        jax_create_trainer(jax_merge(JaxConfigNode(copy.deepcopy(cfg))))
    with pytest.raises(ValueError, match="enable_checkpointing=false"):
        create_trainer(merge_structured(config_from_dict(copy.deepcopy(cfg))))


@pytest.mark.parametrize("name", ["DeviceStatsMonitor", "GradientAccumulationScheduler",
                                  "StochasticWeightAveraging", "ModelPruning"])
def test_callbacks_not_ported_raise_by_name(name):
    with pytest.raises(NotImplementedError, match=name):
        CALLBACKS.get(name)()


def test_a_fit_logs_to_csv_and_finalizes(tmp_path):
    """A fit with a CSVLogger and FinalizeLogger: success, then FAILED."""
    cfg = copy.deepcopy(SMALL)
    cfg["logger"] = {"name": "CSVLogger", "log_dir": str(tmp_path), "timestamp": "ok"}
    cfg["callbacks"] = [{"name": "FinalizeLogger"}]
    cfg["trainer"].update(max_epochs=2, log_every_n_steps=1)
    trainer, _ = run(cfg, "train")
    rows = (tmp_path / "default" / "ok" / "metrics.csv").read_text().splitlines()
    assert rows[0].startswith("step,train/loss,train/")
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2", "2", "3", "4", "4"]
    assert (tmp_path / "default" / "ok" / "status.txt").read_text() == "success"
    assert json.loads((tmp_path / "default" / "ok" / "hparams.json").read_text())["trainer"][
        "max_epochs"] == 2

    class Boom(Callback):
        def on_train_epoch_end(self, trainer, task, logs):
            raise KeyError("boom")

    cfg["logger"]["timestamp"] = "failed"
    with pytest.raises(KeyError):
        run(cfg, "train", [Boom()])
    assert (tmp_path / "default" / "failed" / "status.txt").read_text() == "FAILED"
