"""Constructor: factories for dataloaders and metrics (reference:
torchok/constructor/constructor.py:21-395).

Optimizers are ``torch.optim`` objects built over the model's named
parameters. The reference's mmcv-style ``paramwise_cfg`` (custom_keys
longest-substring match, bias_lr_mult, norm_decay_mult, dwconv_decay_mult)
is realised as param groups: every parameter gets the label
``lr{lr_mult}_wd{decay_mult}`` that ``torchok_tpu``'s ``leaf_label`` gives the
same parameter, and each label becomes one group. A group keeps its
``base_lr`` so the engine can write ``base_lr * factor`` into ``lr`` when the
host-side scheduler moves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Collection, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import torch
from torch import nn

from torchok_tpu_torch.constructor import DATASETS, LOSSES, OPTIMIZERS, SCHEDULERS, TRANSFORMS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.constructor.config_structure import Phase
from torchok_tpu_torch.data.loader import DataLoader
from torchok_tpu_torch.data.transforms import Compose
from torchok_tpu_torch.losses.base import JointLoss
from torchok_tpu_torch.metrics.metrics_manager import MetricsManager


@dataclasses.dataclass
class OptimizerBundle:
    """One optimization group: the optimizer plus scheduler info."""
    optimizer: torch.optim.Optimizer
    # label -> base lr of that param group (rescaled when the scheduler moves)
    group_base_lrs: Dict[str, float]
    scheduler: Optional[Any] = None
    scheduler_interval: str = "epoch"
    scheduler_frequency: int = 1
    scheduler_monitor: str = "val_loss"


def _is_norm_param(path: str) -> bool:
    lowered = path.lower()
    return any(tok in lowered for tok in ("bn", "norm", "batchnorm", "layernorm", "groupnorm"))


def norm_parameter_names(model: nn.Module) -> Set[str]:
    """Names of the parameters owned by normalisation modules. timm's names
    hide some of them from :func:`_is_norm_param` (a ResNet's
    ``downsample.1.weight``, ``conv1.1.bias``, ``maxpool.1.weight``) where the
    JAX package's names (``downsample/bn/scale``, ``bn1_0/bias``) do not."""
    from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
    kinds = (BatchNorm2d, nn.GroupNorm, nn.LayerNorm, nn.modules.batchnorm._BatchNorm)
    return {f"{prefix}.{name}" if prefix else name
            for prefix, module in model.named_modules() if isinstance(module, kinds)
            for name, _ in module.named_parameters(recurse=False)}


def _is_dwconv_weight(path: str, param: torch.Tensor) -> bool:
    # Conv2d weights are OIHW: one input channel per group means depthwise
    return path.endswith("weight") and param.ndim == 4 and param.shape[1] == 1


class Constructor:
    def __init__(self, hparams: ConfigNode):
        self._hparams = hparams

    @property
    def hparams(self) -> ConfigNode:
        return self._hparams

    # ------------------------------------------------------------------
    # Optimizers
    # ------------------------------------------------------------------
    def configure_optimizers(self, named_parameters: Iterable[Tuple[str, torch.Tensor]],
                             no_weight_decay_paths: Sequence[str] = (),
                             optim_idx: int = -1, norm_names: Collection[str] = ()
                             ) -> List[OptimizerBundle]:
        named_parameters = list(named_parameters)
        optims_params = self._hparams.optimization or []
        if 0 <= optim_idx < len(optims_params):
            optims_params = [optims_params[optim_idx]]
        elif optim_idx >= len(optims_params):
            raise ValueError(
                f"You requested optimization with index {optim_idx} while there're only "
                f"{len(optims_params)} optimization parameters are specified"
            )
        bundles = []
        for op in optims_params:
            optimizer, group_lrs = self.create_optimizer(named_parameters, op.optimizer,
                                                         no_weight_decay_paths, norm_names)
            bundle = OptimizerBundle(optimizer=optimizer, group_base_lrs=group_lrs)
            sched = op.get("scheduler")
            if sched:
                scheduler = SCHEDULERS.get(sched.name)(**_as_dict(sched.params))
                scheduler.attach(max(group_lrs.values()) if group_lrs else 0.0)
                bundle.scheduler = scheduler
                pl = sched.get("pl_params") or {}
                bundle.scheduler_interval = pl.get("interval", "epoch") or "epoch"
                bundle.scheduler_frequency = pl.get("frequency", 1) or 1
                bundle.scheduler_monitor = pl.get("monitor", "val_loss") or "val_loss"
            bundles.append(bundle)
        return bundles

    @staticmethod
    def param_labels(named_parameters: Iterable[Tuple[str, torch.Tensor]],
                     optimizer_params, no_weight_decay_paths: Sequence[str] = (),
                     norm_names: Collection[str] = ()) -> Dict[str, str]:
        """``lr{lr_mult}_wd{decay_mult}`` label of every parameter, by name.
        ``norm_names`` (see :func:`norm_parameter_names`) are norm parameters
        whatever they are called."""
        opt_cfg = _as_dict(optimizer_params.get("params") or {})
        paramwise_cfg = _as_dict(optimizer_params.get("paramwise_cfg") or {})
        base_wd = opt_cfg.get("weight_decay", None)

        custom_keys = paramwise_cfg.get("custom_keys", {})
        sorted_keys = sorted(sorted(custom_keys.keys()), key=len, reverse=True)
        bias_lr_mult = paramwise_cfg.get("bias_lr_mult", 1.0)
        bias_decay_mult = paramwise_cfg.get("bias_decay_mult", 1.0)
        norm_decay_mult = paramwise_cfg.get("norm_decay_mult", 1.0)
        dwconv_decay_mult = paramwise_cfg.get("dwconv_decay_mult", 1.0)

        def label(p: str, param: torch.Tensor) -> str:
            lr_mult, decay_mult = 1.0, 1.0
            matched = False
            for key in sorted_keys:
                if key in p:
                    matched = True
                    lr_mult = custom_keys[key].get("lr_mult", 1.0)
                    if base_wd is not None:
                        decay_mult = custom_keys[key].get("decay_mult", 1.0)
                    break
            if not matched:
                is_bias = p.endswith("bias")
                is_norm = _is_norm_param(p) or p in norm_names
                if is_bias and not is_norm:
                    lr_mult = bias_lr_mult
                if base_wd is not None:
                    if is_norm:
                        decay_mult = norm_decay_mult
                    elif _is_dwconv_weight(p, param):
                        decay_mult = dwconv_decay_mult
                    elif is_bias:
                        decay_mult = bias_decay_mult
                # best-practice no-decay group: biases, 1D tensors, scalars,
                # and module-declared no_weight_decay paths
                if param.ndim <= 1 or any(k in p for k in no_weight_decay_paths):
                    decay_mult = 0.0
            return f"lr{lr_mult}_wd{decay_mult}"

        return {name: label(name, param) for name, param in named_parameters}

    @staticmethod
    def create_optimizer(named_parameters: Iterable[Tuple[str, torch.Tensor]],
                         optimizer_params, no_weight_decay_paths: Sequence[str] = (),
                         norm_names: Collection[str] = ()
                         ) -> Tuple[torch.optim.Optimizer, Dict[str, float]]:
        named_parameters = list(named_parameters)
        opt_factory = OPTIMIZERS.get(optimizer_params.name)
        opt_cfg = _as_dict(optimizer_params.get("params") or {})
        base_lr = opt_cfg.pop("lr", opt_cfg.pop("learning_rate", 1e-3))
        base_wd = opt_cfg.get("weight_decay", None)
        labels = Constructor.param_labels(named_parameters, optimizer_params,
                                          no_weight_decay_paths, norm_names)

        group_lrs: Dict[str, float] = {}
        groups: List[Dict[str, Any]] = []
        for label in sorted(set(labels.values())):
            lr_mult = float(label.split("_")[0][2:])
            decay_mult = float(label.split("_")[1][2:])
            group_lr = base_lr * lr_mult
            group = {"params": [p for n, p in named_parameters if labels[n] == label],
                     "lr": group_lr, "base_lr": group_lr, "label": label}
            if base_wd is not None:
                group["weight_decay"] = base_wd * decay_mult
            groups.append(group)
            group_lrs[label] = group_lr
        return opt_factory(groups, lr=base_lr, **opt_cfg), group_lrs

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
    def configure_losses(self) -> Optional[JointLoss]:
        jl = self._hparams.get("joint_loss")
        if not jl:
            return None
        loss_fns, mappings, tags, weights = [], [], [], []
        for lc in jl.losses:
            loss_fns.append(LOSSES.get(lc.name)(**_as_dict(lc.get("params") or {})))
            mappings.append(_as_dict(lc.mapping))
            tags.append(lc.get("tag"))
            weights.append(lc.get("weight"))
        normalize = jl.get("normalize_weights", True)
        return JointLoss(loss_fns, mappings, tags, weights, normalize)

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
