"""``trainer.deterministic`` in the port (Lightning's meaning; the JAX package
accepts the key and needs nothing, its jitted programs being reproducible
already): the global flags during ``run()`` and after it, cuBLAS's workspace
setting and its refusal once the card is in use, and a toy DETR fit of a
few steps run twice to bit-equal parameters on the CPU.
"""
import copy
import os

import pytest
import torch

from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.engine import trainer as engine
from tests.test_torch_detection_data import chip_smoke
from tests.test_torch_slice import _DATA, SMALL_CONFIG


def flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)


@pytest.fixture
def restore_flags():
    before = flags()
    yield
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2:]


@pytest.mark.parametrize("mode", ["train", "test", "predict"])
@pytest.mark.parametrize("value", [True, False, None])
def test_flags_hold_during_run_and_are_restored(monkeypatch, restore_flags, mode, value):
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    before = flags()
    cfg = copy.deepcopy(SMALL_CONFIG)
    cfg["data"]["TRAIN"] = copy.deepcopy(_DATA)
    cfg["trainer"].update(deterministic=value, max_epochs=1, limit_train_batches=1)
    cfg["optimization"] = [{"optimizer": {"name": "SGD", "params": {"lr": 0.01}}}]
    cfg["joint_loss"] = {"losses": [{"name": "CrossEntropyLoss", "tag": "ce", "mapping": {
        "input": "prediction", "target": "target"}}]}
    seen, setup = [], engine.Trainer._setup_state

    def record(self, *args, **kwargs):  # in every mode, before the first batch
        seen.append(flags())
        return setup(self, *args, **kwargs)
    monkeypatch.setattr(engine.Trainer, "_setup_state", record)
    run(cfg, mode)
    assert seen == [(True, False, True, False) if value else before]
    assert flags() == before


def test_cublas_workspace_is_set_before_the_card_is_used(monkeypatch):
    cuda = torch.device("cuda", 0)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    engine._cublas_workspace(torch.device("cpu"))
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    engine._cublas_workspace(cuda)
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    engine._cublas_workspace(cuda)  # already reproducible: nothing to do
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    engine._cublas_workspace(cuda)
    for value in (None, ":0:0"):
        if value is None:
            monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
        else:
            monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", value)
        with pytest.raises(RuntimeError, match="too late"):
            engine._cublas_workspace(cuda)


def test_toy_detr_fit_is_bit_equal_twice_under_deterministic(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "TOYDET_SPLITS", (("train", 128, 1), ("valid", 8, 2)))
    chip_smoke.ensure_toy_detection(str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        finals = []
        for _ in range(2):
            cfg = chip_smoke.detr_steps_config(str(tmp_path), 4, True)
            cfg["trainer"]["accelerator"] = "cpu"
            trainer, _ = run(cfg, "train")
            assert trainer.global_step == 4
            finals.append({k: v.clone() for k, v in trainer.state.model.state_dict().items()})
    finally:
        torch.set_num_threads(threads)
    assert finals[0].keys() == finals[1].keys() and len(finals[0]) > 200
    for name, value in finals[0].items():
        assert torch.equal(value, finals[1][name]), name
