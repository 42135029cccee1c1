"""ModelCheckpoint (port of ``torchok_tpu.callbacks.model_checkpoint``;
the reference re-registers Lightning's ModelCheckpoint,
torchok/callbacks/__init__.py:18).

monitor / save_top_k / mode / save_last / every_n_epochs /
save_weights_only / save_async with Lightning's file names
(``epoch={n}-step={s}.ckpt``, ``last.ckpt``, or the ``filename`` template).
A checkpoint is one ``torch.save`` file holding

* ``state_dict``: the model's parameters and buffers;
* ``optimizer_states`` and ``lr_schedulers``: each optimization group's
  optimizer and host-side scheduler state (left out with
  ``save_weights_only``, so a resume starts a fresh optimizer and schedule);
* ``dropout_generator`` and ``transform_generator``: the states of the
  generators that dropout and drop path, and the train set's random device
  transforms, draw from;
* ``epoch``, ``global_step``, ``monitor`` and ``metrics`` (the epoch's logs).

After each save :meth:`ModelCheckpoint.on_checkpoint_saved` is called (an
export callback writes its artifact there); a checkpoint dropped from the
best k takes the artifact beside it along.

``Trainer.fit(task, ckpt_path)`` resumes from such a file with
:func:`restore_train_state`; test and predict read its ``state_dict``.
"""
from __future__ import annotations

import logging
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchok_tpu_torch.constructor import CALLBACKS
from torchok_tpu_torch.engine.callbacks import Callback

logger = logging.getLogger(__name__)

_PENDING_SAVES: List[threading.Thread] = []
_WRITER_ERRORS: List[BaseException] = []


def wait_for_pending_saves() -> None:
    """Block until every background checkpoint write has finished, and
    re-raise the first writer failure: a checkpoint that failed to write
    must not count as saved."""
    for t in list(_PENDING_SAVES):
        t.join()
    _PENDING_SAVES.clear()
    if _WRITER_ERRORS:
        err = _WRITER_ERRORS[0]
        _WRITER_ERRORS.clear()
        raise RuntimeError("background checkpoint write failed") from err


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def train_state_payload(trainer, weights_only: bool = False) -> Dict[str, Any]:
    """What a checkpoint holds of the trainer's state, copied to the host."""
    state = trainer.state
    payload: Dict[str, Any] = {"state_dict": state.model.state_dict()}
    if not weights_only:
        payload["optimizer_states"] = [opt.state_dict() for opt in state.optimizers]
        payload["lr_schedulers"] = [b.scheduler.state_dict() if b.scheduler is not None
                                    else None for b in trainer.bundles]
    for key in ("dropout_generator", "transform_generator"):
        generator = getattr(state, key)
        if generator is not None:
            payload[key] = generator.get_state()
    return _to_host(payload)


def save_train_state(path: str, payload: Dict[str, Any], meta: Optional[Dict] = None,
                     background: bool = False) -> None:
    """Write a checkpoint: ``payload`` (host tensors, from
    :func:`train_state_payload`) and ``meta`` in one ``torch.save`` file,
    written to a temporary name and renamed, so a failed write leaves no
    partial file under ``path``. With ``background`` the write runs on one
    writer thread (writes stay in order, one at a time) and a failure is
    raised by the next :func:`wait_for_pending_saves`."""
    path = str(Path(path).absolute())
    blob = {**payload, **(meta or {})}

    def _write() -> None:
        tmp = f"{path}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)

    def _write_bg() -> None:
        try:
            _write()
        except BaseException as exc:  # noqa: BLE001 — raised at the next join
            _WRITER_ERRORS.append(exc)

    if background:
        wait_for_pending_saves()  # one writer at a time, in order
        t = threading.Thread(target=_write_bg, name="ckpt-writer", daemon=True)
        t.start()
        _PENDING_SAVES.append(t)
    else:
        _write()


def restore_train_state(ckpt: Dict[str, Any], trainer) -> None:
    """Resume the trainer's state from a loaded checkpoint: the optimizers and
    schedulers (unless it was saved weights-only; then they stay freshly
    built), the generators, the epoch and the step counts. The model's
    ``state_dict`` is loaded by the caller before the model moves to its
    device."""
    state = trainer.state
    optimizer_states = ckpt.get("optimizer_states")
    if optimizer_states is None:
        logger.info("weights-only checkpoint: optimizer and schedules freshly initialized")
    else:
        schedulers = ckpt.get("lr_schedulers") or [None] * len(optimizer_states)
        if len(optimizer_states) != len(state.optimizers) or \
                len(schedulers) != len(trainer.bundles):
            raise ValueError(
                f"the checkpoint holds {len(optimizer_states)} optimizer states and "
                f"{len(schedulers)} schedules; the config builds {len(state.optimizers)}")
        for optimizer, saved in zip(state.optimizers, optimizer_states):
            optimizer.load_state_dict(saved)
        for bundle, saved in zip(trainer.bundles, schedulers):
            if (bundle.scheduler is None) != (saved is None):
                raise ValueError("the checkpoint's schedulers differ from the config's")
            if saved is not None:
                bundle.scheduler.load_state_dict(saved)
    for key in ("dropout_generator", "transform_generator"):
        if key in ckpt and getattr(state, key) is not None:
            getattr(state, key).set_state(ckpt[key])
    trainer.current_epoch = int(ckpt["epoch"]) + 1
    trainer.global_step = state.step = int(ckpt["global_step"])


@CALLBACKS.register_class
class ModelCheckpoint(Callback):
    def __init__(self, dirpath: Optional[str] = None, filename: Optional[str] = None,
                 monitor: Optional[str] = None, save_top_k: int = 1,
                 save_last: bool = False, mode: str = "min",
                 save_weights_only: bool = False, every_n_epochs: int = 1,
                 export_to_onnx: bool = False, save_async: bool = False, **_):
        self.dirpath = dirpath
        self.filename = filename
        self.monitor = monitor
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.mode = mode
        self.save_weights_only = save_weights_only
        self.every_n_epochs = max(1, every_n_epochs)
        # the copy to the host stays inline, the write goes to a writer thread
        self.save_async = save_async
        self.best_k: List[Tuple[float, str]] = []  # (score, path)
        self.best_model_path: Optional[str] = None
        self.best_model_score: Optional[float] = None

    def setup(self, trainer, task) -> None:
        if self.dirpath is None:
            base = trainer.logger.log_dir if trainer.logger else "checkpoints"
            self.dirpath = str(Path(base) / "checkpoints")
        Path(self.dirpath).mkdir(parents=True, exist_ok=True)

    def _is_better(self, score: float, ref: float) -> bool:
        return score < ref if self.mode == "min" else score > ref

    def _ckpt_name(self, trainer) -> str:
        if self.filename:
            return self.filename.format(epoch=trainer.current_epoch, step=trainer.global_step)
        return f"epoch={trainer.current_epoch}-step={trainer.global_step}"

    def _save(self, trainer, task, path: str) -> None:
        save_train_state(path, train_state_payload(trainer, self.save_weights_only), meta={
            "epoch": trainer.current_epoch,
            "global_step": trainer.global_step,
            "monitor": self.monitor,
            "metrics": {k: float(v) for k, v in trainer.callback_metrics.items()},
        }, background=self.save_async)
        self.on_checkpoint_saved(trainer, task, path)

    def on_checkpoint_saved(self, trainer, task, path: str) -> None:
        """Called after every save (CheckpointStableHLO exports there)."""

    def on_fit_end(self, trainer, task) -> None:
        wait_for_pending_saves()

    def on_exception(self, trainer, task, exc) -> None:
        wait_for_pending_saves()  # do not lose an in-flight write on failure

    def on_epoch_end(self, trainer, task, logs: Dict[str, float]) -> None:
        if (trainer.current_epoch + 1) % self.every_n_epochs != 0:
            return
        if self.monitor is not None and self.monitor in logs and self.save_top_k != 0:
            score = float(logs[self.monitor])
            path = str(Path(self.dirpath) / (self._ckpt_name(trainer) + ".ckpt"))
            if self.save_top_k < 0 or len(self.best_k) < self.save_top_k:
                self._save(trainer, task, path)
                self.best_k.append((score, path))
            else:
                worst_idx = int(np.argmin([s for s, _ in self.best_k])) \
                    if self.mode == "max" else int(np.argmax([s for s, _ in self.best_k]))
                worst_score, worst_path = self.best_k[worst_idx]
                if self._is_better(score, worst_score):
                    self._save(trainer, task, path)
                    if worst_path != path:
                        Path(worst_path).unlink(missing_ok=True)
                        # and the artifact an export callback wrote beside it
                        shutil.rmtree(Path(worst_path).with_suffix(".stablehlo"),
                                      ignore_errors=True)
                    self.best_k[worst_idx] = (score, path)
            best_idx = int(np.argmax([s for s, _ in self.best_k])) \
                if self.mode == "max" else int(np.argmin([s for s, _ in self.best_k]))
            self.best_model_score, self.best_model_path = self.best_k[best_idx]
        elif self.monitor is None:
            path = str(Path(self.dirpath) / (self._ckpt_name(trainer) + ".ckpt"))
            self._save(trainer, task, path)
            self.best_model_path = path
        if self.save_last:
            self._save(trainer, task, str(Path(self.dirpath) / "last.ckpt"))
