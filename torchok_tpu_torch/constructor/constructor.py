"""Constructor: factories for dataloaders and metrics (reference:
torchok/constructor/constructor.py:21-395).

The port builds what evaluation needs: datasets with their transform chains,
dataloaders and the metrics manager. Optimizers, schedulers and losses come
with the training slice; a config that asks for them raises here instead of
running without them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from torchok_tpu_torch.constructor import DATASETS, TRANSFORMS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.constructor.config_structure import Phase
from torchok_tpu_torch.data.loader import DataLoader
from torchok_tpu_torch.data.transforms import Compose
from torchok_tpu_torch.metrics.metrics_manager import MetricsManager


class Constructor:
    def __init__(self, hparams: ConfigNode):
        self._hparams = hparams

    @property
    def hparams(self) -> ConfigNode:
        return self._hparams

    # ------------------------------------------------------------------
    # Data
    # ------------------------------------------------------------------
    def create_dataloaders(self, phase: Phase) -> List[DataLoader]:
        data = self._hparams.get("data") or {}
        phase_cfgs = data.get(phase.name) if hasattr(data, "get") else None
        if not phase_cfgs:
            return []
        loaders = []
        for pc in phase_cfgs:
            if pc is None:
                continue
            if pc.get("sampler"):
                raise NotImplementedError("dataset samplers are not ported yet")
            loaders.append(DataLoader(dataset=self._create_dataset(pc.dataset),
                                      **_as_dict(pc.dataloader)))
        return loaders

    @staticmethod
    def _create_dataset(dataset_params):
        transform = Constructor._create_transforms(dataset_params.get("transform"))
        augment = Constructor._create_transforms(dataset_params.get("augment"))
        dataset_class = DATASETS.get(dataset_params.name)
        return dataset_class(transform=transform, augment=augment,
                             **_as_dict(dataset_params.get("params") or {}))

    @staticmethod
    def _prepare_transforms_recursively(transforms) -> List:
        out = []
        for info in transforms or []:
            params = _as_dict(info.get("params") or {})
            if "transforms" in params:
                out.append(Constructor._prepare_base_compose(info["name"], **params))
            else:
                out.append(TRANSFORMS.get(info["name"])(**params))
        return out

    @staticmethod
    def _prepare_base_compose(compose_name: str, **kwargs):
        transforms = kwargs.pop("transforms", None)
        if transforms is None:
            raise ValueError(f"There are transforms must be specified for {compose_name} composition")
        tlist = Constructor._prepare_transforms_recursively(transforms)
        return TRANSFORMS.get(compose_name)(transforms=tlist, **kwargs)

    @staticmethod
    def _create_transforms(transforms_params) -> Optional[Compose]:
        if not transforms_params:
            return None
        return Constructor._prepare_base_compose("Compose", transforms=transforms_params)

    # ------------------------------------------------------------------
    # Losses / metrics
    # ------------------------------------------------------------------
    def configure_losses(self):
        if self._hparams.get("joint_loss"):
            raise NotImplementedError("joint_loss: losses are not ported yet")
        return None

    def configure_metrics_manager(self) -> MetricsManager:
        return MetricsManager(self._hparams.get("metrics") or [])


def _as_dict(obj: Any) -> Dict[str, Any]:
    if obj is None:
        return {}
    if isinstance(obj, ConfigNode):
        return obj.to_dict()
    if isinstance(obj, dict):
        return {k: (v.to_dict() if isinstance(v, ConfigNode) else v) for k, v in obj.items()}
    return dict(obj)
