"""Logger backends (port of ``torchok_tpu.constructor.logger``; reference:
torchok/constructor/logger.py:192-240).

The output directory is ``log_dir/experiment_name/timestamp``, as in the
reference (reference logger.py:52-73). ``CSVLogger`` writes ``hparams.json``,
``metrics.csv`` and ``status.txt`` there as ``torchok_tpu`` does.
``TensorBoardLogger`` imports ``tensorboardX`` when it is built and raises
``ImportError`` where that is absent. The MLflow, Weights & Biases and
Neptune loggers are not ported yet and raise by name.
"""
from __future__ import annotations

import csv
import datetime
import json
import logging
from pathlib import Path
from typing import Dict, Optional

from torchok_tpu_torch.constructor import LOGGERS
from torchok_tpu_torch.constructor.config import ConfigNode

logger = logging.getLogger(__name__)


class BaseLogger:
    def __init__(self, log_dir: str, experiment_name: str = "default",
                 timestamp: Optional[str] = None, **params):
        if timestamp is None:
            timestamp = datetime.datetime.now().strftime("%Y-%m-%d/%H-%M-%S")
        self.save_dir = Path(log_dir) / experiment_name / timestamp
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.params = params

    @property
    def log_dir(self) -> str:
        return str(self.save_dir)

    def log_hyperparams(self, hparams) -> None:
        try:
            data = hparams.to_dict() if isinstance(hparams, ConfigNode) else dict(hparams)
            with open(self.save_dir / "hparams.json", "w") as f:
                json.dump(data, f, indent=2, default=str)
        except Exception as e:  # noqa: BLE001 — as the reference: a warning, the fit goes on
            logger.warning("Failed to dump hparams: %s", e)

    def log_metrics(self, metrics: Dict[str, float], step: int = 0) -> None:
        raise NotImplementedError

    def finalize(self, status: str) -> None:
        pass


@LOGGERS.register_class
class CSVLogger(BaseLogger):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._path = self.save_dir / "metrics.csv"
        self._fields = ["step"]
        self._rows = []

    def log_metrics(self, metrics: Dict[str, float], step: int = 0) -> None:
        row = {"step": step, **metrics}
        for k in row:
            if k not in self._fields:
                self._fields.append(k)
        self._rows.append(row)
        with open(self._path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fields)
            writer.writeheader()
            writer.writerows(self._rows)

    def finalize(self, status: str) -> None:
        with open(self.save_dir / "status.txt", "w") as f:
            f.write(status)


@LOGGERS.register_class
class TensorBoardLogger(BaseLogger):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from tensorboardX import SummaryWriter  # raises ImportError where it is absent
        self.writer = SummaryWriter(logdir=str(self.save_dir))

    def log_metrics(self, metrics: Dict[str, float], step: int = 0) -> None:
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(k, float(v), global_step=step)
            except (TypeError, ValueError):
                pass

    def finalize(self, status: str) -> None:
        self.writer.flush()
        self.writer.close()


def _not_ported(name: str):
    class NotPorted(BaseLogger):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is not ported yet: it waits for utils/mlflow_store.py and the "
                "offline run writers; use CSVLogger or TensorBoardLogger")

    NotPorted.__name__ = NotPorted.__qualname__ = name
    return NotPorted


for _name in ("MLFlowLogger", "MLFlowLoggerX", "WandbLogger", "NeptuneLogger"):
    LOGGERS.register_class(_not_ported(_name))


def create_logger(logger_params) -> Optional[BaseLogger]:
    """Build a logger backend from config (reference logger.py:192-240)."""
    if not logger_params:
        return None
    name = logger_params.name
    kwargs = dict(
        log_dir=logger_params.log_dir,
        experiment_name=logger_params.get("experiment_name", "default"),
        timestamp=logger_params.get("timestamp"),
    )
    extra = logger_params.get("params") or {}
    if hasattr(extra, "to_dict"):
        extra = extra.to_dict()
    kwargs.update(extra)
    return LOGGERS.get(name)(**kwargs)
