"""MetricsManager: per-phase, per-dataloader metric orchestration
(reference: torchok/metrics/metrics_manager.py:78-206).

Each managed metric carries an explicit state dict on the trainer's device;
updates run eagerly on the step outputs and only ``on_epoch_end`` reads
values back to the host.
"""
from __future__ import annotations

import numbers
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torchok_tpu_torch.constructor import METRICS
from torchok_tpu_torch.constructor.config_structure import MetricParams, Phase


class MetricWithUtils:
    def __init__(self, metric, mapping: Dict[str, str], log_name: str,
                 dataloader_idx: int):
        self.metric = metric
        self.mapping = mapping
        self.log_name = log_name
        self.dataloader_idx = dataloader_idx
        self.state: Optional[Dict[str, Any]] = None  # created on first update

    def map_arguments(self, task_output: Dict[str, Any]) -> Dict[str, Any]:
        metric_input = {}
        for metric_target, metric_source in self.mapping.items():
            if metric_source not in task_output:
                raise ValueError(
                    f"Cannot find {metric_source} for your mapping {metric_target} : "
                    f"{metric_source}. You should either add {metric_source} output to "
                    f"your model or remove the mapping from configuration"
                )
            metric_input[metric_target] = task_output[metric_source]
        return metric_input

    def update(self, dataloader_idx: int = 0, **kwargs) -> None:
        if dataloader_idx == self.dataloader_idx:
            targeted = self.map_arguments(kwargs)
            if self.state is None:
                device = next(iter(targeted.values())).device
                self.state = self.metric.empty_state(device)
            self.state = self.metric.update(self.state, **targeted)

    def compute(self):
        state = self.state if self.state is not None else self.metric.empty_state("cpu")
        return self.metric.compute(state)

    def reset(self) -> None:
        self.state = None


class MetricsManager:
    def __init__(self, params: Optional[List] = None):
        parsed = []
        for p in params or []:
            d = p.to_dict() if hasattr(p, "to_dict") else dict(p)
            if not d.get("mapping"):
                raise ValueError(
                    f"Metric {d.get('name')!r} has no 'mapping' block; map "
                    "metric arguments to task outputs, e.g. "
                    "mapping: {preds: prediction, target: target}")
            phases = d.get("phases") or [ph.name for ph in Phase]
            parsed.append(MetricParams(
                name=d["name"], mapping=d["mapping"],
                params=d.get("params") or {},
                phases=[ph if isinstance(ph, Phase) else Phase[str(ph).upper()]
                        for ph in phases],
                val_dataloader_idxs=d.get("val_dataloader_idxs") or [0],
                test_dataloader_idxs=d.get("test_dataloader_idxs") or [0],
                tag=d.get("tag"),
            ))
        self.phase2metrics: Dict[str, List[MetricWithUtils]] = {
            phase.name: self._get_phase_metrics(parsed, phase) for phase in Phase
        }

    @staticmethod
    def _get_phase_metrics(params: List[MetricParams], phase: Phase) -> List[MetricWithUtils]:
        added_log_names: List[str] = []
        metrics: List[MetricWithUtils] = []
        for mp in params:
            if phase not in mp.phases:
                continue
            base_log_name = mp.name if mp.tag is None else mp.tag
            if phase == Phase.VALID:
                dataloader_idxs = mp.val_dataloader_idxs
            elif phase == Phase.TEST:
                dataloader_idxs = mp.test_dataloader_idxs
            else:
                dataloader_idxs = [0]

            if phase in (Phase.VALID, Phase.TEST) and len(dataloader_idxs) > 1:
                log_names = [f"{base_log_name}_dataloader_{i}" for i in dataloader_idxs]
            else:
                log_names = [base_log_name]

            for log_name in log_names:
                if log_name in added_log_names:
                    raise ValueError(
                        f"Got two metrics with identical names: {log_name}. Please, set "
                        f"different prefixes for identical metrics in the config file."
                    )
                added_log_names.append(log_name)

            for dataloader_idx, log_name in zip(dataloader_idxs, log_names):
                metric = METRICS.get(mp.name)(**(mp.params or {}))
                metrics.append(MetricWithUtils(metric=metric, mapping=mp.mapping,
                                               log_name=log_name,
                                               dataloader_idx=dataloader_idx))
        return metrics

    def update(self, phase: Phase, dataloader_idx: int = 0, **kwargs) -> None:
        for m in self.phase2metrics[phase.name]:
            m.update(dataloader_idx, **kwargs)

    @staticmethod
    def is_number(num: Any) -> bool:
        if isinstance(num, (np.ndarray, torch.Tensor)):
            return num.ndim == 0 and not isinstance(num.tolist(), bool)
        return isinstance(num, numbers.Number)

    def on_epoch_end(self, phase: Phase) -> Dict[str, float]:
        log: Dict[str, float] = {}
        for m in self.phase2metrics[phase.name]:
            value = m.compute()
            if isinstance(value, dict):
                out = {}
                for k, v in value.items():
                    if self.is_number(v):
                        out[f"{phase.value}/{m.log_name}_{k}"] = float(v)
                if not out:
                    raise ValueError(
                        f"Metric manager on_epoch_end method. Metric {m.log_name} "
                        f"return dict with has no numeric values."
                    )
                log.update(out)
            elif self.is_number(value):
                log[f"{phase.value}/{m.log_name}"] = float(value)
            else:
                raise ValueError(
                    f"Metric manager on_epoch_end method. Metric {m.log_name} "
                    f"return no numeric value."
                )
            m.reset()
        return log
