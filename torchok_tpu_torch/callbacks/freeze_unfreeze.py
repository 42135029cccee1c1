"""FreezeUnfreeze and BackboneFinetuning (port of
``torchok_tpu.callbacks.freeze_unfreeze``; reference:
torchok/callbacks/freeze_unfreeze.py:52-184).

Declarative freeze policies by module path, backbone stage or module class.
At each train epoch's start the callback works out the JAX package's two
masks as sets of names and hands them to ``TrainState.set_masks``:

* the frozen parameters (``grad_mask`` 0): the train step gives them zero
  gradients and still steps them, so weight decay and momentum move them as
  they move the JAX package's;
* the BatchNorms whose running statistics stay put (``bn_mask`` 0): they
  normalise with the batch's statistics in training all the same.

Policy fields (the reference's YAML):
  - ``module_name``: a module path ('' is the whole model);
  - ``epoch``: unfreeze at this epoch (absent: frozen for the whole fit);
  - ``stages`` (or ``stage``): the first N stages of the backbone under
    ``module_name`` (its ``get_stages``);
  - ``module_class``: only modules of this class (``_BatchNorm``,
    ``BatchNorm2d``, ``LayerNorm``, ``Dropout``, or any class name in a
    module's MRO);
  - ``bn_requires_grad``: with ``module_class``, leave those parameters
    trainable; ``bn_track_running_stats`` (default true): with
    ``module_class``, leave their running statistics moving.

Two matches differ from the JAX package on purpose. A path prefix matches
whole dotted segments (``blocks.1`` is not a prefix of ``blocks.10``; the JAX
package's ``str.startswith`` on ``blocks_1`` takes ``blocks_10`` too). A
``module_class`` is decided by the module's type, as TorchOk decides it
(the JAX package looks for name fragments such as ``norm`` or ``bn`` in Flax
paths, which also takes LayerNorms and GroupNorms for ``_BatchNorm``).
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

from torch import nn

from torchok_tpu_torch.constructor import CALLBACKS
from torchok_tpu_torch.engine.callbacks import Callback

logger = logging.getLogger(__name__)

# the reference's class names for the port's own BatchNorm
_CLASS_ALIASES = {"_BatchNorm": "BatchNorm2d", "BatchNorm": "BatchNorm2d"}


def under(name: str, prefix: str) -> bool:
    """``name`` lies under the module path ``prefix``, matched by whole
    dotted segments ('' matches everything)."""
    prefix = prefix.rstrip(".")
    return not prefix or name == prefix or name.startswith(prefix + ".")


def is_class(module: nn.Module, module_class: Optional[str]) -> bool:
    if module_class is None:
        return True
    wanted = {module_class, _CLASS_ALIASES.get(module_class, module_class)}
    return any(cls.__name__ in wanted for cls in type(module).__mro__)


def _as_dict(policy) -> Dict:
    return dict(policy.to_dict() if hasattr(policy, "to_dict") else policy)


@CALLBACKS.register_class
class FreezeUnfreeze(Callback):
    def __init__(self, freeze_modules: List[Dict], **_):
        self.freeze_modules = [_as_dict(m) for m in freeze_modules]

    @staticmethod
    def _prefixes(task, policy: Dict) -> List[str]:
        module_name = policy.get("module_name", "") or ""
        stages = policy.get("stages", policy.get("stage"))
        if stages is None:
            return [module_name]
        backbone = getattr(task.model, "backbone", None)
        if backbone is None:
            logger.warning("FreezeUnfreeze: a stages policy but the task has no backbone")
            return []
        base = f"{module_name}." if module_name else ""
        return [base + p for p in backbone.get_stages(stages)]

    @staticmethod
    def _active(policy: Dict, epoch: int) -> bool:
        unfreeze = policy.get("epoch")
        return unfreeze is None or epoch < unfreeze

    def masks(self, task, epoch: int) -> Tuple[Set[str], Set[str]]:
        """The frozen parameter names and the BatchNorms whose running
        statistics stay, at ``epoch``."""
        model = task.model
        policies = [(p, self._prefixes(task, p)) for p in self.freeze_modules
                    if self._active(p, epoch)]
        owners = {}  # parameter name -> the module that holds it
        for mname, module in model.named_modules():
            for pname, _ in module.named_parameters(recurse=False):
                owners[f"{mname}.{pname}" if mname else pname] = module
        params, stats = set(), set()
        for policy, prefixes in policies:
            module_class = policy.get("module_class")
            for name, module in owners.items():
                if any(under(name, p) for p in prefixes) and is_class(module, module_class) \
                        and not (module_class is not None
                                 and policy.get("bn_requires_grad", False)):
                    params.add(name)
            for mname, module in model.named_modules():
                if not hasattr(module, "update_running_stats"):
                    continue
                if any(under(mname, p) for p in prefixes) and is_class(module, module_class) \
                        and not (module_class is not None
                                 and policy.get("bn_track_running_stats", True)):
                    stats.add(mname)
        return params, stats

    def on_train_epoch_start(self, trainer, task) -> None:
        params, stats = self.masks(task, trainer.current_epoch)
        state = trainer.state
        if (params, stats) != (state.frozen_params, state.frozen_stats):
            logger.info("FreezeUnfreeze: %d parameter tensors and %d norms' statistics frozen "
                        "at epoch %d", len(params), len(stats), trainer.current_epoch)
            trainer.state.set_masks(params, stats)


@CALLBACKS.register_class
class BackboneFinetuning(Callback):
    """Freeze the backbone for ``unfreeze_backbone_at_epoch`` epochs, then
    unfreeze it (Lightning's name; the masks of :class:`FreezeUnfreeze`)."""

    def __init__(self, unfreeze_backbone_at_epoch: int = 10, **_):
        self._inner = FreezeUnfreeze(freeze_modules=[
            {"module_name": "backbone", "epoch": unfreeze_backbone_at_epoch}])

    def on_train_epoch_start(self, trainer, task) -> None:
        self._inner.on_train_epoch_start(trainer, task)
