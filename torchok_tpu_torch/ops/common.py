"""Small shared compute ops (stochastic depth, initializers)."""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.utils.checkpoint as checkpoint_util
from torch import nn


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
