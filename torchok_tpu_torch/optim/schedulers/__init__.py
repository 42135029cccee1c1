"""LR scheduler registry (reference: torchok/optim/schedulers/__init__.py:14-30;
the port's own copy of ``torchok_tpu.optim.schedulers``, which is pure Python).

Schedulers are host-side lr policies, not ``torch.optim.lr_scheduler``
objects: the engine asks for the lr after each scheduler step (per epoch or
per optimizer step, as configured by ``pl_params.interval``) and writes it,
times each group's lr multiplier, into ``optimizer.param_groups``.

Covers the 10 torch schedulers plus the 6 timm-style ones the reference
re-registers; warmup-enabled timm variants keep their parameter names.
"""
from __future__ import annotations

import ast
import math
from bisect import bisect_right
from typing import Callable, List, Optional, Sequence

from torchok_tpu_torch.constructor import SCHEDULERS

__all__ = []

# --- restricted lr_lambda parser ------------------------------------------
# YAML-provided lambdas are parsed into a whitelisted expression grammar
# (arithmetic, comparisons, ternaries, min/max/abs/round/pow, math.*) —
# never raw eval(), so a config file cannot execute arbitrary code.

_LAMBDA_NODES = (
    ast.Expression, ast.Lambda, ast.arguments, ast.arg,
    ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.IfExp, ast.Compare, ast.Call,
    ast.Constant, ast.Name, ast.Load, ast.Attribute, ast.Tuple,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd, ast.Not, ast.And, ast.Or,
    ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq,
)
_LAMBDA_FUNCS = {"min": min, "max": max, "abs": abs, "float": float,
                 "int": int, "round": round, "pow": pow}


def parse_lr_lambda(src: str) -> Callable[[int], float]:
    """Parse a YAML ``lr_lambda`` string like ``"lambda epoch: 0.95 ** epoch"``
    into a callable, allowing only arithmetic expressions (no attribute access
    except ``math.*``, no builtins beyond min/max/abs/float/int/round/pow)."""
    tree = ast.parse(src.strip(), mode="eval")
    if not isinstance(tree.body, ast.Lambda):
        raise ValueError(f"lr_lambda must be a lambda expression, got: {src!r}")
    arg_names = {a.arg for a in tree.body.args.args}
    for node in ast.walk(tree):
        if not isinstance(node, _LAMBDA_NODES):
            raise ValueError(
                f"disallowed syntax {type(node).__name__!r} in lr_lambda {src!r}")
        if isinstance(node, ast.Attribute):
            if not (isinstance(node.value, ast.Name) and node.value.id == "math"
                    and isinstance(node.ctx, ast.Load)):
                raise ValueError(
                    f"only math.* attributes are allowed in lr_lambda {src!r}")
        if isinstance(node, ast.Name):
            if node.id not in arg_names and node.id != "math" \
                    and node.id not in _LAMBDA_FUNCS:
                raise ValueError(f"unknown name {node.id!r} in lr_lambda {src!r}")
        if isinstance(node, ast.Call):
            fn = node.func
            ok = (isinstance(fn, ast.Name) and fn.id in _LAMBDA_FUNCS) or \
                 (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                  and fn.value.id == "math")
            if not ok or node.keywords:
                raise ValueError(f"disallowed call in lr_lambda {src!r}")
    namespace = {"__builtins__": {}, "math": math, **_LAMBDA_FUNCS}
    return eval(compile(tree, "<lr_lambda>", "eval"), namespace)  # noqa: S307 — AST-whitelisted above


class BaseLRScheduler:
    """Epoch/step-indexed lr policy. ``step()`` advances; ``get_last_lr``
    mirrors the torch API."""

    needs_metric = False

    def __init__(self):
        self.base_lr: float = 0.0
        self.last_epoch: int = 0

    def attach(self, base_lr: float) -> None:
        self.base_lr = base_lr

    def lr_at(self, epoch: int) -> float:
        raise NotImplementedError

    @property
    def current_lr(self) -> float:
        return self.lr_at(self.last_epoch)

    def step(self, metric: Optional[float] = None) -> float:
        self.last_epoch += 1
        return self.current_lr

    def get_last_lr(self) -> List[float]:
        return [self.current_lr]

    def state_dict(self) -> dict:
        """Every attribute but the callables (a parsed ``lr_lambda``), so a
        resumed policy carries on where it stopped (ReduceLROnPlateau's best
        value, bad epochs and lr too)."""
        return {k: v for k, v in vars(self).items() if not callable(v)}

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)


@SCHEDULERS.register_class(name="LambdaLR")
class LambdaLR(BaseLRScheduler):
    def __init__(self, lr_lambda, **_):
        super().__init__()
        if isinstance(lr_lambda, str):
            lr_lambda = parse_lr_lambda(lr_lambda)
        self.lr_lambda = lr_lambda

    def lr_at(self, epoch: int) -> float:
        return self.base_lr * self.lr_lambda(epoch)


@SCHEDULERS.register_class(name="MultiplicativeLR")
class MultiplicativeLR(BaseLRScheduler):
    def __init__(self, lr_lambda, **_):
        super().__init__()
        if isinstance(lr_lambda, str):
            lr_lambda = parse_lr_lambda(lr_lambda)
        self.lr_lambda = lr_lambda

    def lr_at(self, epoch: int) -> float:
        lr = self.base_lr
        for e in range(1, epoch + 1):
            lr *= self.lr_lambda(e)
        return lr


@SCHEDULERS.register_class(name="StepLR")
class StepLR(BaseLRScheduler):
    def __init__(self, step_size: int, gamma: float = 0.1, **_):
        super().__init__()
        self.step_size = step_size
        self.gamma = gamma

    def lr_at(self, epoch: int) -> float:
        return self.base_lr * self.gamma ** (epoch // self.step_size)


@SCHEDULERS.register_class(name="MultiStepLR")
class MultiStepLR(BaseLRScheduler):
    def __init__(self, milestones: Sequence[int], gamma: float = 0.1, **_):
        super().__init__()
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def lr_at(self, epoch: int) -> float:
        return self.base_lr * self.gamma ** bisect_right(self.milestones, epoch)


@SCHEDULERS.register_class(name="ConstantLR")
class ConstantLR(BaseLRScheduler):
    def __init__(self, factor: float = 1.0 / 3, total_iters: int = 5, **_):
        super().__init__()
        self.factor = factor
        self.total_iters = total_iters

    def lr_at(self, epoch: int) -> float:
        return self.base_lr * (self.factor if epoch < self.total_iters else 1.0)


@SCHEDULERS.register_class(name="LinearLR")
class LinearLR(BaseLRScheduler):
    def __init__(self, start_factor: float = 1.0 / 3, end_factor: float = 1.0,
                 total_iters: int = 5, **_):
        super().__init__()
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters

    def lr_at(self, epoch: int) -> float:
        t = min(epoch, self.total_iters) / self.total_iters
        return self.base_lr * (self.start_factor + t * (self.end_factor - self.start_factor))


@SCHEDULERS.register_class(name="ExponentialLR")
class ExponentialLR(BaseLRScheduler):
    def __init__(self, gamma: float, **_):
        super().__init__()
        self.gamma = gamma

    def lr_at(self, epoch: int) -> float:
        return self.base_lr * self.gamma ** epoch


@SCHEDULERS.register_class(name="CosineAnnealingLR")
class CosineAnnealingLR(BaseLRScheduler):
    def __init__(self, T_max: int, eta_min: float = 0.0, **_):
        super().__init__()
        self.T_max = T_max
        self.eta_min = eta_min

    def lr_at(self, epoch: int) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * epoch / self.T_max)) / 2


@SCHEDULERS.register_class(name="CosineAnnealingWarmRestarts")
class CosineAnnealingWarmRestarts(BaseLRScheduler):
    def __init__(self, T_0: int, T_mult: int = 1, eta_min: float = 0.0, **_):
        super().__init__()
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min

    def lr_at(self, epoch: int) -> float:
        t_cur, t_i = epoch, self.T_0
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * t_cur / t_i)) / 2


@SCHEDULERS.register_class(name="CyclicLR")
class CyclicLR(BaseLRScheduler):
    """torch.optim.lr_scheduler.CyclicLR (reference registers it at
    torchok/optim/schedulers/__init__.py:21). Triangular policies between
    base_lr and max_lr; ``base_lr`` falls back to the optimizer lr."""

    def __init__(self, base_lr: Optional[float] = None, max_lr: float = 0.01,
                 step_size_up: int = 2000, step_size_down: Optional[int] = None,
                 mode: str = "triangular", gamma: float = 1.0,
                 scale_fn=None, scale_mode: str = "cycle", **_):
        super().__init__()
        self.cycle_base_lr = base_lr
        self.max_lr = max_lr
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down if step_size_down is not None \
            else step_size_up
        self.mode = mode
        self.gamma = gamma
        if isinstance(scale_fn, str):
            scale_fn = parse_lr_lambda(scale_fn)
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode

    def attach(self, base_lr: float) -> None:
        super().attach(base_lr)
        if self.cycle_base_lr is None:
            self.cycle_base_lr = base_lr

    def lr_at(self, epoch: int) -> float:
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + epoch / total)
        pos = epoch - (cycle - 1) * total
        if pos <= self.step_size_up:
            scale_factor = pos / self.step_size_up
        else:
            scale_factor = (total - pos) / self.step_size_down
        base_height = (self.max_lr - self.cycle_base_lr) * scale_factor
        if self.scale_fn is not None:
            x = cycle if self.scale_mode == "cycle" else epoch
            base_height *= self.scale_fn(x)
        elif self.mode == "triangular2":
            base_height *= 1.0 / (2.0 ** (cycle - 1))
        elif self.mode == "exp_range":
            base_height *= self.gamma ** epoch
        return self.cycle_base_lr + base_height


@SCHEDULERS.register_class(name="OneCycleLR")
class OneCycleLR(BaseLRScheduler):
    """``total_steps``, or ``epochs`` x ``steps_per_epoch`` as
    ``torch.optim.lr_scheduler.OneCycleLR`` takes them (``configs/
    pairwise_sop.yaml`` gives the two; the JAX package's class takes only
    ``total_steps``)."""

    def __init__(self, max_lr: float, total_steps: Optional[int] = None,
                 pct_start: float = 0.3, div_factor: float = 25.0,
                 final_div_factor: float = 1e4, anneal_strategy: str = "cos",
                 epochs: Optional[int] = None, steps_per_epoch: Optional[int] = None, **_):
        super().__init__()
        if total_steps is None:
            if epochs is None or steps_per_epoch is None:
                raise ValueError("OneCycleLR needs total_steps, or epochs and steps_per_epoch")
            total_steps = int(epochs) * int(steps_per_epoch)
        self.max_lr = max_lr
        self.total_steps = total_steps
        self.pct_start = pct_start
        self.div_factor = div_factor
        self.final_div_factor = final_div_factor
        self.anneal_strategy = anneal_strategy

    def lr_at(self, epoch: int) -> float:
        # Matches torch.optim.lr_scheduler.OneCycleLR (three_phase=False):
        # ramp initial->max_lr over [0, pct_start*total-1], then
        # max_lr->final over [pct_start*total-1, total-1].
        initial = self.max_lr / self.div_factor
        final = initial / self.final_div_factor
        up_end = float(self.pct_start * self.total_steps) - 1
        down_end = float(self.total_steps) - 1
        e = min(epoch, self.total_steps - 1)

        def anneal(start, end, pct):
            if self.anneal_strategy == "cos":
                return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
            return start + (end - start) * pct

        if e <= up_end:
            return anneal(initial, self.max_lr, e / max(up_end, 1e-12))
        pct = (e - up_end) / max(down_end - up_end, 1e-12)
        return anneal(self.max_lr, final, min(pct, 1.0))


@SCHEDULERS.register_class(name="ReduceLROnPlateau")
class ReduceLROnPlateau(BaseLRScheduler):
    needs_metric = True

    def __init__(self, mode: str = "min", factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0.0, **_):
        super().__init__()
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._lr: Optional[float] = None

    def attach(self, base_lr: float) -> None:
        super().attach(base_lr)
        self._lr = base_lr

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            delta = self.threshold * abs(self.best)
        else:
            delta = self.threshold
        return metric < self.best - delta if self.mode == "min" else metric > self.best + delta

    def lr_at(self, epoch: int) -> float:
        return self._lr if self._lr is not None else self.base_lr

    def step(self, metric: Optional[float] = None) -> float:
        self.last_epoch += 1
        if metric is None:
            return self._lr
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self.num_bad = 0
                self.cooldown_counter = self.cooldown
        return self._lr


# --------------------------- timm-style schedulers -------------------------

class _WarmupMixin:
    def _warmup_lr(self, epoch: int, warmup_t: int, warmup_lr_init: float,
                   target: float) -> float:
        if warmup_t <= 0 or epoch >= warmup_t:
            return None
        return warmup_lr_init + (target - warmup_lr_init) * epoch / warmup_t


@SCHEDULERS.register_class(name="CosineLRScheduler")
class CosineLRScheduler(BaseLRScheduler, _WarmupMixin):
    """timm cosine with warmup/cycles (timm-compatible parameter names)."""

    def __init__(self, t_initial: int, lr_min: float = 0.0, cycle_mul: float = 1.0,
                 cycle_decay: float = 1.0, cycle_limit: int = 1, warmup_t: int = 0,
                 warmup_lr_init: float = 0.0, warmup_prefix: bool = False,
                 k_decay: float = 1.0, **_):
        super().__init__()
        self.t_initial = t_initial
        self.lr_min = lr_min
        self.cycle_mul = cycle_mul
        self.cycle_decay = cycle_decay
        self.cycle_limit = cycle_limit
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.warmup_prefix = warmup_prefix
        self.k_decay = k_decay

    def lr_at(self, epoch: int) -> float:
        w = self._warmup_lr(epoch, self.warmup_t, self.warmup_lr_init, self.base_lr)
        if w is not None:
            return w
        t = epoch - self.warmup_t if self.warmup_prefix else epoch
        if self.cycle_mul != 1.0:
            i = math.floor(math.log(1 - t / self.t_initial * (1 - self.cycle_mul), self.cycle_mul))
            t_i = self.cycle_mul ** i * self.t_initial
            t_curr = t - (1 - self.cycle_mul ** i) / (1 - self.cycle_mul) * self.t_initial
        else:
            i = t // self.t_initial
            t_i = self.t_initial
            t_curr = t - self.t_initial * i
        if i >= self.cycle_limit:
            return self.lr_min
        gamma = self.cycle_decay ** i
        lr_max = self.base_lr * gamma
        k = self.k_decay
        return self.lr_min + 0.5 * (lr_max - self.lr_min) * \
            (1 + math.cos(math.pi * t_curr ** k / t_i ** k))


@SCHEDULERS.register_class(name="StepLRScheduler")
class StepLRScheduler(BaseLRScheduler, _WarmupMixin):
    def __init__(self, decay_t: int, decay_rate: float = 1.0, warmup_t: int = 0,
                 warmup_lr_init: float = 0.0, **_):
        super().__init__()
        self.decay_t = decay_t
        self.decay_rate = decay_rate
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init

    def lr_at(self, epoch: int) -> float:
        w = self._warmup_lr(epoch, self.warmup_t, self.warmup_lr_init, self.base_lr)
        if w is not None:
            return w
        return self.base_lr * self.decay_rate ** (epoch // self.decay_t)


@SCHEDULERS.register_class(name="MultiStepLRScheduler")
class MultiStepLRScheduler(BaseLRScheduler, _WarmupMixin):
    def __init__(self, decay_t: Sequence[int], decay_rate: float = 1.0,
                 warmup_t: int = 0, warmup_lr_init: float = 0.0, **_):
        super().__init__()
        self.decay_t = sorted(decay_t)
        self.decay_rate = decay_rate
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init

    def lr_at(self, epoch: int) -> float:
        w = self._warmup_lr(epoch, self.warmup_t, self.warmup_lr_init, self.base_lr)
        if w is not None:
            return w
        return self.base_lr * self.decay_rate ** bisect_right(self.decay_t, epoch)


@SCHEDULERS.register_class(name="PolyLRScheduler")
class PolyLRScheduler(BaseLRScheduler, _WarmupMixin):
    def __init__(self, t_initial: int, power: float = 0.5, lr_min: float = 0.0,
                 warmup_t: int = 0, warmup_lr_init: float = 0.0, **_):
        super().__init__()
        self.t_initial = t_initial
        self.power = power
        self.lr_min = lr_min
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init

    def lr_at(self, epoch: int) -> float:
        w = self._warmup_lr(epoch, self.warmup_t, self.warmup_lr_init, self.base_lr)
        if w is not None:
            return w
        t = min(epoch, self.t_initial)
        return self.lr_min + (self.base_lr - self.lr_min) * \
            (1 - t / self.t_initial) ** self.power


@SCHEDULERS.register_class(name="TanhLRScheduler")
class TanhLRScheduler(BaseLRScheduler, _WarmupMixin):
    def __init__(self, t_initial: int, lb: float = -7.0, ub: float = 3.0,
                 lr_min: float = 0.0, warmup_t: int = 0, warmup_lr_init: float = 0.0, **_):
        super().__init__()
        self.t_initial = t_initial
        self.lb = lb
        self.ub = ub
        self.lr_min = lr_min
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init

    def lr_at(self, epoch: int) -> float:
        w = self._warmup_lr(epoch, self.warmup_t, self.warmup_lr_init, self.base_lr)
        if w is not None:
            return w
        t = min(epoch, self.t_initial)
        tr = t / self.t_initial
        return self.lr_min + 0.5 * (self.base_lr - self.lr_min) * \
            (1 - math.tanh(self.lb * (1.0 - tr) + self.ub * tr))


@SCHEDULERS.register_class(name="PlateauLRScheduler")
class PlateauLRScheduler(ReduceLROnPlateau):
    """timm plateau scheduler — same reduction-on-plateau policy."""

    def __init__(self, decay_rate: float = 0.1, patience_t: int = 10,
                 mode: str = "max", threshold: float = 1e-4, cooldown_t: int = 0,
                 lr_min: float = 0.0, **_):
        super().__init__(mode=mode, factor=decay_rate, patience=patience_t,
                         threshold=threshold, cooldown=cooldown_t, min_lr=lr_min)
