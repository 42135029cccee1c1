"""Global component registries (reference: torchok/constructor/__init__.py:4-17).

The names match ``torchok_tpu.constructor``; the instances are the port's own.
"""
from torchok_tpu_torch.constructor.registry import Registry

DATASETS = Registry("datasets")
TRANSFORMS = Registry("transforms")
OPTIMIZERS = Registry("optimizers")
SCHEDULERS = Registry("schedulers")
LOSSES = Registry("losses")
METRICS = Registry("metrics")
CALLBACKS = Registry("callbacks")
TASKS = Registry("tasks")
BACKBONES = Registry("backbones")
POOLINGS = Registry("poolings")
HEADS = Registry("heads")
NECKS = Registry("necks")
DETECTION_NECKS = Registry("detection_necks")
SAMPLERS = Registry("samplers")
LOGGERS = Registry("loggers")

from torchok_tpu_torch.constructor.config import ConfigNode, load_config  # noqa: E402
from torchok_tpu_torch.constructor.config_structure import ConfigParams, Phase, merge_structured  # noqa: E402
