"""Structured config schema.

Mirrors the YAML surface of the reference schema (reference:
torchok/constructor/config_structure.py:7-196) so user recipes carry over
unchanged; the trainer block is interpreted by the PyTorch engine.

The schema is enforced by :func:`merge_structured`, which plays the role of
``OmegaConf.structured`` + ``OmegaConf.merge``: defaults are filled in and
unknown keys raise, giving typo safety.
"""
from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

from .config import ConfigNode


class Phase(Enum):
    TRAIN = "train"
    VALID = "valid"
    TEST = "test"
    PREDICT = "predict"


@dataclass
class CallbacksParams:
    name: str
    params: Optional[Dict] = field(default_factory=dict)


@dataclass
class OptimizerParams:
    name: str
    params: Optional[Dict] = field(default_factory=dict)
    paramwise_cfg: Optional[Dict] = field(default_factory=dict)


@dataclass
class SchedulerPLParams:
    """Scheduler loop-behavior knobs (interval/frequency/monitor)."""
    interval: Optional[str] = "epoch"
    frequency: Optional[int] = 1
    monitor: Optional[str] = "val_loss"
    strict: Optional[bool] = True
    name: Optional[str] = None


@dataclass
class SchedulerParams:
    name: str
    params: Optional[Dict] = field(default_factory=dict)
    pl_params: Optional[SchedulerPLParams] = field(default_factory=SchedulerPLParams)


@dataclass
class OptimizationParams:
    optimizer: OptimizerParams
    scheduler: Optional[SchedulerParams] = None


@dataclass
class AugmentationParams:
    name: str
    params: Dict = field(default_factory=dict)
    # container transforms (OneOf, Compose, ...) carry nested transform lists
    # inside `params`, handled by the constructor recursively.


@dataclass
class SamplerParams:
    name: str
    params: Dict = field(default_factory=dict)


@dataclass
class DatasetParams:
    name: str
    params: Dict
    transform: List[AugmentationParams] = field(default_factory=list)
    augment: Optional[List[AugmentationParams]] = field(default_factory=list)


@dataclass
class DataParams:
    dataset: DatasetParams
    dataloader: Dict
    sampler: Optional[SamplerParams] = None


@dataclass
class LossParams:
    name: str
    mapping: Dict[str, str]
    params: Optional[Dict] = field(default_factory=dict)
    tag: Optional[str] = None
    weight: Optional[float] = None


@dataclass
class JointLossParams:
    losses: List[LossParams]
    normalize_weights: bool = True


@dataclass
class MetricParams:
    name: str
    mapping: Dict[str, str]
    params: Optional[Dict] = field(default_factory=dict)
    phases: Optional[List[Phase]] = field(
        default_factory=lambda: [Phase.TRAIN, Phase.VALID, Phase.TEST, Phase.PREDICT]
    )
    val_dataloader_idxs: Optional[List[int]] = field(default_factory=lambda: [0])
    test_dataloader_idxs: Optional[List[int]] = field(default_factory=lambda: [0])
    tag: Optional[str] = None


@dataclass
class SeedParams:
    seed: Optional[int] = None
    workers: Optional[bool] = False


@dataclass
class LoadCheckpointParams:
    base_ckpt_path: Optional[str] = None
    overridden_name2ckpt_path: Optional[Dict[str, str]] = None
    exclude_keys: Optional[List[str]] = None
    strict: bool = True


@dataclass
class TaskParams:
    name: str
    compute_loss_on_valid: bool = True
    params: Optional[Dict] = field(default_factory=dict)
    load_checkpoint: Optional[LoadCheckpointParams] = None


@dataclass
class TrainerParams:
    """Loop options. Field names match the reference YAML. The PyTorch
    engine reads ``accelerator`` (``gpu``/``cuda``/``auto`` mean the first
    CUDA card and raise when there is none; ``cpu`` means the CPU),
    ``precision`` (16 and bf16 mean ``torch.autocast`` in bfloat16) and the
    ``limit_*_batches`` knobs. The other keys are accepted so that a recipe
    written for ``torchok_tpu`` validates unchanged; the engine raises when
    one that would change an eval run is set away from its default."""
    accelerator: str = "auto"
    strategy: str = "auto"
    devices: Any = "auto"
    num_nodes: int = 1
    precision: Any = 32
    fast_dev_run: Any = False
    max_epochs: Optional[int] = None
    min_epochs: Optional[int] = None
    max_steps: int = -1
    min_steps: Optional[int] = None
    max_time: Optional[Any] = None
    limit_train_batches: Optional[Any] = None
    limit_val_batches: Optional[Any] = None
    limit_test_batches: Optional[Any] = None
    limit_predict_batches: Optional[Any] = None
    overfit_batches: Any = 0.0
    val_check_interval: Optional[Any] = None
    check_val_every_n_epoch: Optional[int] = 1
    num_sanity_val_steps: Optional[int] = None
    log_every_n_steps: Optional[int] = 50
    enable_checkpointing: Optional[bool] = None
    enable_progress_bar: Optional[bool] = None
    enable_model_summary: Optional[bool] = None
    accumulate_grad_batches: int = 1
    gradient_clip_val: Optional[float] = None
    gradient_clip_algorithm: Optional[str] = None
    deterministic: Optional[bool] = None
    benchmark: Optional[bool] = None
    inference_mode: bool = True
    use_distributed_sampler: bool = True
    profiler: Optional[str] = None
    detect_anomaly: bool = False
    barebones: bool = False
    sync_batchnorm: bool = False
    reload_dataloaders_every_n_epochs: int = 0
    # torchok_tpu extensions, accepted for recipe compatibility
    steps_per_execution: int = 1
    model_parallel_size: int = 1
    # Lightning parity: how several TRAIN dataloaders are combined
    # ("max_size_cycle" or "sequential"); see CombinedTrainLoader
    multiple_trainloader_mode: str = "max_size_cycle"


@dataclass
class LoggerParams:
    name: str
    log_dir: str
    experiment_name: str = "default"
    timestamp: Optional[str] = None
    params: Optional[Dict] = field(default_factory=dict)


@dataclass
class ConfigParams:
    task: TaskParams
    data: Dict[Phase, List[DataParams]]
    trainer: TrainerParams
    optimization: Optional[List[OptimizationParams]] = None
    joint_loss: Optional[JointLossParams] = None
    logger: Optional[LoggerParams] = None
    metrics: Optional[List[MetricParams]] = field(default_factory=list)
    callbacks: Optional[List[CallbacksParams]] = field(default_factory=list)
    resume_path: Optional[str] = None
    seed_params: Optional[SeedParams] = None


# ---------------------------------------------------------------------------
# Structured merge (schema validation + default filling)
# ---------------------------------------------------------------------------

def _strip_optional(tp: Any) -> Any:
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(tp: Any, value: Any, path: str) -> Any:
    tp = _strip_optional(tp)
    if value is None:
        return None
    origin = typing.get_origin(tp)

    if dataclasses.is_dataclass(tp):
        if not isinstance(value, (dict, ConfigNode)):
            raise TypeError(f"{path}: expected a mapping for {tp.__name__}, got {type(value).__name__}")
        return _merge_dataclass(tp, value, path)

    if isinstance(tp, type) and issubclass(tp, Enum):
        if isinstance(value, tp):
            return value
        # accept both 'TRAIN' and 'train'
        for member in tp:
            if value == member.name or value == member.value:
                return member
        raise ValueError(f"{path}: {value!r} is not a valid {tp.__name__} "
                         f"(expected one of {[m.name for m in tp]})")

    if origin in (list, List):
        (elem_tp,) = typing.get_args(tp) or (Any,)
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"{path}: expected a list, got {type(value).__name__}")
        return [_coerce(elem_tp, v, f"{path}[{i}]") for i, v in enumerate(value)]

    if origin in (dict, Dict):
        args = typing.get_args(tp)
        key_tp, val_tp = args if args else (Any, Any)
        if not isinstance(value, (dict, ConfigNode)):
            raise TypeError(f"{path}: expected a mapping, got {type(value).__name__}")
        out = {}
        for k, v in value.items():
            ck = _coerce(key_tp, k, f"{path}.{k}") if key_tp is not Any else k
            out[ck] = _coerce(val_tp, v, f"{path}.{k}") if val_tp is not Any else v
        return out

    if isinstance(value, ConfigNode):
        return value.to_dict()
    return value


def _merge_dataclass(cls: type, data: Any, path: str = "") -> Dict[str, Any]:
    if isinstance(data, ConfigNode):
        data = data.to_dict()
    known = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(known)
    if unknown:
        raise KeyError(
            f"Unknown key(s) {sorted(unknown)} at '{path or cls.__name__}'. "
            f"Valid keys: {sorted(known)}"
        )
    out: Dict[str, Any] = {}
    for name, f in known.items():
        child_path = f"{path}.{name}" if path else name
        if name in data:
            out[name] = _coerce(f.type_resolved if hasattr(f, "type_resolved") else _resolve_field_type(cls, name), data[name], child_path)
        elif f.default is not dataclasses.MISSING:
            out[name] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            out[name] = f.default_factory()  # type: ignore[misc]
        else:
            raise KeyError(f"Missing required config key '{child_path}'")
    return out


def _resolve_field_type(cls: type, name: str) -> Any:
    hints = typing.get_type_hints(cls)
    return hints[name]


def merge_structured(cfg: ConfigNode) -> ConfigNode:
    """Validate a raw config against :class:`ConfigParams` and fill defaults."""
    merged = _merge_dataclass(ConfigParams, cfg)
    return _to_node(merged)


def _to_node(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        node = ConfigNode()
        for k, v in obj.items():
            key = k.name if isinstance(k, Enum) else k
            node[key] = _to_node(v)
        return node
    if isinstance(obj, list):
        return [_to_node(v) for v in obj]
    return obj
