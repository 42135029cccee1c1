"""Small shared compute ops (stochastic depth, initializers) and what the
kernel wrappers of this package share (launch counts, argument checks)."""
from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import Callable, Optional

import torch
import torch.utils.checkpoint as checkpoint_util
from torch import nn

LN_100 = math.log(100.0)  # SwinV2 caps the learned temperature at 100

# launches per path; a kernel wrapper adds one per kernel launch and a
# dispatcher one per plain call, so a run can show which path it took
LAUNCHES: collections.Counter = collections.Counter()

# set while export traces a model: a kernel op called then raises
_EXPORTING = threading.local()


@contextlib.contextmanager
def refusing_kernels():
    """Make every kernel op raise inside the block (export): ``torch.export``
    cannot trace a kernel bound through ``ctypes``, and tracing its plain
    version instead would ship another computation than the model runs."""
    previous = getattr(_EXPORTING, "on", False)
    _EXPORTING.on = True
    try:
        yield
    finally:
        _EXPORTING.on = previous


def refuse_in_export(kernel: str) -> None:
    """Raise ``NotImplementedError`` naming ``kernel`` (its name in the
    kernel table, "K1" to "K9") when called inside :func:`refusing_kernels`."""
    if getattr(_EXPORTING, "on", False):
        raise NotImplementedError(
            f"the model's eval forward runs the hand-written kernel {kernel}, which is bound "
            "through ctypes and cannot be traced by torch.export; exporting its plain version "
            "instead would give another computation, so this model is not exported (export "
            "through torch.library.custom_op is on the roadmap)")


# the element types the kernels take, as their entry points number them
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_tensor(t: torch.Tensor, name: str, shape, dtype, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape and type on
    ``device``: what a kernel's entry point takes as a bare pointer."""
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth: drop the entire residual branch per sample. The
    draw comes from ``generator`` (on ``x``'s device), never from torch's
    global state."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _training_generator(module: nn.Module) -> torch.Generator:
    if module.dropout_generator is None:
        raise RuntimeError(
            f"{type(module).__name__} with rate {module.rate} in training mode has no "
            "generator: call install_dropout_generator(model, generator) first")
    return module.dropout_generator


class DropPath(nn.Module):
    """Per-sample stochastic depth; identity in eval mode. Draws from
    ``dropout_generator``, which :func:`install_dropout_generator` sets."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.dropout_generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        return drop_path(x, self.rate, _training_generator(self))


class Dropout(nn.Module):
    """Elementwise dropout drawing from ``dropout_generator`` (the
    counterpart of ``flax.linen.Dropout`` on the ``dropout`` rng stream);
    identity in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.dropout_generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, device=x.device,
                          generator=_training_generator(self)) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def install_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Hand one generator to every module of ``model`` that draws dropout
    noise (those with a ``dropout_generator`` attribute)."""
    for m in model.modules():
        if hasattr(m, "dropout_generator"):
            m.dropout_generator = generator


@contextlib.contextmanager
def replay_generator(generator: torch.Generator, state: torch.Tensor):
    """Run a block from ``state`` and put the generator back afterwards:
    a checkpointed block recomputed in the backward redraws its forward's
    noise without disturbing the draws that follow."""
    now = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(now)


def checkpoint_block(block: Callable[..., torch.Tensor], generator: Optional[torch.Generator],
                     *args) -> torch.Tensor:
    """``block(*args)`` with its activations recomputed in the backward
    instead of kept (reference: ``torch.utils.checkpoint`` per block). With a
    dropout ``generator`` the recomputation redraws from the state the
    forward started at."""
    context_fn = checkpoint_util.noop_context_fn
    if generator is not None:
        state = generator.get_state()

        def context_fn():
            return contextlib.nullcontext(), replay_generator(generator, state)
    return checkpoint_util.checkpoint(block, *args, use_reentrant=False, context_fn=context_fn)


# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(weight: torch.Tensor, scale: float, fan: int,
                      generator: torch.Generator) -> None:
    """Flax's ``variance_scaling(scale, mode, "truncated_normal")`` over
    ``fan``: a normal cut at two standard deviations, rescaled so its
    variance is ``scale / fan`` (LeCun normal is scale 1 over fan_in)."""
    std = math.sqrt(scale / fan) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def trunc_normal_init(module: nn.Module, generator: torch.Generator,
                      std: float = 0.02) -> None:
    """timm's transformer init, drawn from an explicit generator: truncated
    normal weights for Linear and Conv2d, zero biases, unit LayerNorm."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
