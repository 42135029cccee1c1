"""Common callbacks (port of ``torchok_tpu.callbacks.common``; reference:
torchok/callbacks/__init__.py:11-23, Lightning's callbacks rebuilt natively).

``DeviceStatsMonitor``, ``GradientAccumulationScheduler``,
``StochasticWeightAveraging`` and ``ModelPruning`` are not ported yet and
raise by name when a recipe asks for them.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

from torch import nn

from torchok_tpu_torch.constructor import CALLBACKS
from torchok_tpu_torch.engine.callbacks import Callback

logger = logging.getLogger(__name__)


@CALLBACKS.register_class
class EarlyStopping(Callback):
    def __init__(self, monitor: str, min_delta: float = 0.0, patience: int = 3,
                 mode: str = "min", **_):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.wait = 0
        self._stop = False

    def on_epoch_end(self, trainer, task, logs: Dict[str, float]) -> None:
        if self.monitor not in logs:
            return
        value = float(logs[self.monitor])
        improved = (self.best is None or
                    (value < self.best - self.min_delta if self.mode == "min"
                     else value > self.best + self.min_delta))
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self._stop = True
                logger.info("EarlyStopping: %s did not improve for %d epochs",
                            self.monitor, self.patience)

    def should_stop(self, trainer) -> bool:
        return self._stop


@CALLBACKS.register_class
class FinalizeLogger(Callback):
    """Flush the logger with KILLED or FAILED status on any exception
    (reference: torchok/callbacks/finalize_logger.py:7-14)."""

    def on_exception(self, trainer, task, exception: BaseException) -> None:
        if trainer.logger is not None:
            status = "KILLED" if isinstance(exception, KeyboardInterrupt) else "FAILED"
            trainer.logger.finalize(status)


@CALLBACKS.register_class
class LearningRateMonitor(Callback):
    def __init__(self, logging_interval: str = "epoch", **_):
        self.logging_interval = logging_interval

    def on_epoch_end(self, trainer, task, logs: Dict[str, float]) -> None:
        if trainer.logger is not None:
            trainer.logger.log_metrics({"lr": trainer.current_lr()}, step=trainer.global_step)


@CALLBACKS.register_class
class TQDMProgressBar(Callback):
    """Console progress reporting: no tqdm, one summary line per epoch."""

    def __init__(self, refresh_rate: int = 1, **_):
        self.refresh_rate = refresh_rate
        self._t0 = None

    def on_train_epoch_start(self, trainer, task) -> None:
        self._t0 = time.perf_counter()

    def on_epoch_end(self, trainer, task, logs: Dict[str, float]) -> None:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        parts = [f"epoch {trainer.current_epoch}", f"{dt:.1f}s"]
        for k, v in sorted(logs.items()):
            if isinstance(v, (int, float)) and not k.endswith("epoch_time_s"):
                parts.append(f"{k}={v:.4f}")
        print(" | ".join(parts), flush=True)


@CALLBACKS.register_class
class RichProgressBar(TQDMProgressBar):
    pass


def _is_norm(module: nn.Module) -> bool:
    from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
    return isinstance(module, (BatchNorm2d, nn.modules.batchnorm._BatchNorm))


@CALLBACKS.register_class
class ModelSummary(Callback):
    """Per-module parameter table at fit start (Lightning's ModelSummary).
    ``max_depth`` bounds how deep into the module tree the breakdown goes;
    modules without parameters are left out, as they have no entry in a Flax
    parameter tree. "Trainable" leaves out the parameters the freeze mask
    holds (``TrainState.frozen_params``), as the JAX package counts its
    ``grad_mask``. "Norm stats / buffers" counts the BatchNorm running
    means and variances (no ``num_batches_tracked``), as ``batch_stats``
    holds them."""

    def __init__(self, max_depth: int = 1, **_):
        self.max_depth = max_depth

    @staticmethod
    def _count(module: nn.Module) -> int:
        return sum(p.numel() for p in module.parameters())

    def _rows(self, module: nn.Module, prefix: str, depth: int) -> List[Tuple[str, int]]:
        if depth >= self.max_depth:
            return []
        rows = []
        for name, child in module.named_children():
            count = self._count(child)
            if not count:
                continue
            rows.append((f"{prefix}{name}", count))
            rows.extend(self._rows(child, f"{prefix}{name}.", depth + 1))
        return rows

    def on_fit_start(self, trainer, task) -> None:
        model = trainer.state.model
        total = self._count(model)
        frozen = trainer.state.frozen_params  # the grad mask, as the JAX package counts it
        trainable = sum(p.numel() for n, p in model.named_parameters() if n not in frozen)
        stats = sum(buf.numel() for m in model.modules() if _is_norm(m)
                    for name, buf in m.named_buffers(recurse=False)
                    if name in ("running_mean", "running_var"))
        rows = self._rows(model, "", 0)
        width = max([len(r[0]) for r in rows], default=4)
        lines = [f"  {name:<{width}}  {cnt / 1e6:>8.2f}M" for name, cnt in rows]
        print("\n".join([
            *lines,
            f"Trainable params: {trainable / 1e6:.2f}M",
            f"Non-trainable params: {(total - trainable) / 1e6:.2f}M",
            f"Norm stats / buffers: {stats / 1e6:.2f}M",
            f"Total params: {total / 1e6:.2f}M",
        ]), flush=True)


@CALLBACKS.register_class
class RichModelSummary(ModelSummary):
    pass


@CALLBACKS.register_class
class Timer(Callback):
    def __init__(self, duration: Optional[str] = None, interval: str = "epoch", **_):
        self.duration_s = self._parse(duration) if duration else None
        self._start = None
        self._stop = False

    @staticmethod
    def _parse(duration: str) -> float:
        parts = [float(p) for p in str(duration).split(":")]
        while len(parts) < 4:
            parts.insert(0, 0.0)
        d, h, m, s = parts[-4:]
        return ((d * 24 + h) * 60 + m) * 60 + s

    def on_fit_start(self, trainer, task) -> None:
        self._start = time.monotonic()

    def on_epoch_end(self, trainer, task, logs) -> None:
        if self.duration_s and time.monotonic() - self._start > self.duration_s:
            self._stop = True

    def should_stop(self, trainer) -> bool:
        return self._stop


def _not_ported(name: str):
    class NotPorted(Callback):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(f"callback {name} is not ported yet")

    NotPorted.__name__ = NotPorted.__qualname__ = name
    return NotPorted


for _name in ("DeviceStatsMonitor", "GradientAccumulationScheduler",
              "StochasticWeightAveraging", "ModelPruning"):
    CALLBACKS.register_class(_not_ported(_name))
