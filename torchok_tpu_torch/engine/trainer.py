"""Evaluation engine (port of the ``test``/``predict`` part of
``torchok_tpu.engine.trainer``; reference: torchok/constructor/runner.py +
Lightning internals).

* The trainer holds an explicit ``torch.device`` resolved from
  ``trainer.accelerator``: ``gpu``, ``cuda`` and ``auto`` mean the first CUDA
  card and raise when there is none; ``cpu`` means the CPU. Nothing falls
  back to the CPU quietly.
* Model weights are drawn from a ``torch.Generator`` seeded from
  ``seed_params.seed``, or loaded from ``ckpt_path`` (a ``torch.save`` of a
  ``state_dict``, optionally under a ``"state_dict"`` key).
* Input pipeline: loader threads fetch and collate numpy batches; the batch
  is copied to the device and the dataset's device transform suffix runs
  there, batched.
* ``precision: 16`` (or ``bf16``) runs the eval step under
  ``torch.autocast(device, torch.bfloat16)``; every eval step runs under
  ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.constructor.config_structure import Phase, TrainerParams
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.engine.state import TrainState

# trainer keys the eval engine reads
_HONOURED = frozenset({"accelerator", "precision", "limit_test_batches",
                       "limit_predict_batches"})
# trainer keys that steer only the fit loop (epochs, validation, gradients,
# checkpointing), or that change nothing in a one-device eval: a training
# recipe keeps them and still runs in test/predict mode
_EVAL_INERT = frozenset({
    "max_epochs", "min_epochs", "max_steps", "min_steps", "max_time",
    "limit_train_batches", "limit_val_batches", "overfit_batches",
    "val_check_interval", "check_val_every_n_epoch", "num_sanity_val_steps",
    "log_every_n_steps", "enable_checkpointing", "accumulate_grad_batches",
    "gradient_clip_val", "gradient_clip_algorithm", "detect_anomaly",
    "reload_dataloaders_every_n_epochs", "multiple_trainloader_mode",
    "steps_per_execution", "sync_batchnorm", "use_distributed_sampler",
})


def _check_ported(tp: ConfigNode) -> None:
    """Raise on a trainer key the eval engine does not honour when it is set
    away from its default, so no recipe quietly runs something else."""
    for f in dataclasses.fields(TrainerParams):
        if f.name in _HONOURED or f.name in _EVAL_INERT:
            continue
        value = tp.get(f.name, f.default)
        if f.name == "devices" and str(value) in ("1", "-1"):
            continue
        if value != f.default:
            raise NotImplementedError(
                f"trainer.{f.name}={value!r} is not ported yet (only {f.default!r} runs)")


def resolve_device(accelerator: Optional[str]) -> torch.device:
    """trainer.accelerator -> torch.device; raises when the card is absent."""
    acc = str(accelerator or "auto").lower()
    if acc in ("gpu", "cuda", "auto"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"trainer.accelerator={acc} needs a CUDA device and none is "
                "available; set trainer.accelerator=cpu to run on the CPU")
        return torch.device("cuda", 0)
    if acc == "cpu":
        return torch.device("cpu")
    raise ValueError(f"trainer.accelerator={accelerator!r}: expected gpu, cuda, auto or cpu")


class Trainer:
    def __init__(self, trainer_params: ConfigNode,
                 callbacks: Optional[List[Callback]] = None, seed: int = 0):
        tp = trainer_params
        _check_ported(tp)
        self.callbacks = callbacks or []
        self.seed = seed
        self.limit_test_batches = tp.get("limit_test_batches")
        self.limit_predict_batches = tp.get("limit_predict_batches")
        self.device = resolve_device(tp.get("accelerator"))

        self.state: Optional[TrainState] = None
        self.task = None
        # images and host seconds of the last eval loop, first batch fetch to
        # the metrics read-back (which waits for the device)
        self.last_eval: Dict[str, float] = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _limit(n_batches: int, limit) -> int:
        if limit is None:
            return n_batches
        if isinstance(limit, float) and limit <= 1.0:
            return max(1, int(n_batches * limit))
        return min(n_batches, int(limit))

    def _make_device_fn(self, dataset) -> Callable:
        pipe = dataset.device_pipeline
        device = self.device
        generator = torch.Generator(device=device)
        generator.manual_seed(self.seed + 31)

        def device_fn(host_batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            batch = {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()
                     if isinstance(v, np.ndarray)}
            if pipe:
                batch = pipe(batch, generator)
            if not batch["image"].is_floating_point():
                batch["image"] = batch["image"].float()
            return batch

        return device_fn

    def _install_device_fns(self, loaders: Sequence) -> None:
        for ld in loaders:
            ld.device_fn = self._make_device_fn(ld.dataset)

    def _make_eval_step(self, task) -> Callable:
        model = self.state.model
        dtype = task.compute_dtype
        device_type = self.device.type

        def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            with torch.inference_mode(), \
                    torch.autocast(device_type, dtype=dtype, enabled=dtype is not None):
                return model(batch)

        return eval_step

    # ------------------------------------------------------------------
    def _setup_state(self, task, ckpt_path: Optional[str] = None) -> None:
        generator = torch.Generator()
        generator.manual_seed(self.seed)
        task.init_weights(generator)
        if ckpt_path:
            ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
            task.model.load_state_dict(ckpt.get("state_dict", ckpt), strict=True)
        self.state = TrainState(model=task.model.to(self.device).eval())

    def _run_eval(self, task, eval_step, loaders, phase: Phase, limit) -> Dict[str, float]:
        n_images = 0
        start = time.perf_counter()
        with torch.inference_mode():
            for dl_idx, loader in enumerate(loaders):
                n_batches = self._limit(len(loader), limit)
                for bidx, batch in enumerate(loader):
                    if bidx >= n_batches:
                        break
                    outputs = eval_step(batch)
                    task.metrics_manager.update(phase, dl_idx, **outputs)
                    n_images += batch["image"].shape[0]
            logs = task.metrics_manager.on_epoch_end(phase)
        self.last_eval = {"images": n_images, "seconds": time.perf_counter() - start}
        return logs

    def _prepare(self, task, loaders, ckpt_path: Optional[str]) -> Callable:
        self.task = task
        if self.state is None:
            self._setup_state(task, ckpt_path)
        self._install_device_fns(loaders)
        return self._make_eval_step(task)

    def test(self, task, ckpt_path: Optional[str] = None) -> Dict[str, float]:
        loaders = task.test_dataloader()
        eval_step = self._prepare(task, loaders, ckpt_path)
        logs = self._run_eval(task, eval_step, loaders, Phase.TEST, self.limit_test_batches)
        for cb in self.callbacks:
            cb.on_test_end(self, task, logs)
        return logs

    def predict(self, task, ckpt_path: Optional[str] = None) -> List[Dict[str, np.ndarray]]:
        loaders = task.predict_dataloader()
        eval_step = self._prepare(task, loaders, ckpt_path)
        results = []
        for loader in loaders:
            n_batches = self._limit(len(loader), self.limit_predict_batches)
            for bidx, batch in enumerate(loader):
                if bidx >= n_batches:
                    break
                outputs = eval_step(batch)
                results.append({k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                                for k, v in outputs.items()})
        return results
