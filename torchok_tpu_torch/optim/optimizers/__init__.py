"""Optimizer registry (reference: torchok/optim/optimizers/__init__.py:9-19;
port of ``torchok_tpu.optim.optimizers``).

Each entry is a factory ``make(param_groups, lr, **torch_style_params) ->
torch.optim.Optimizer``. ``torchok_tpu`` builds its optimizers as optax
chains; the port uses the ``torch.optim`` class wherever its update is the
chain's, step for step:

* ``Adam``: ``add_decayed_weights -> scale_by_adam -> -lr`` is
  ``torch.optim.Adam`` (L2 decay joins the gradient before the moments);
* ``AdamW``: ``scale_by_adam -> add_decayed_weights -> -lr`` is
  ``torch.optim.AdamW`` (``p - lr (u + wd p)`` either way);
* ``SGD``: ``add_decayed_weights -> trace(momentum, nesterov) -> -lr`` is
  ``torch.optim.SGD`` with ``dampening=0``: the optax chain has no
  dampening, so the key is accepted and not applied, as there;
* ``amsgrad=True``: optax keeps the running maximum of the *bias-corrected*
  second moment, ``torch.optim`` of the raw one, so that update is written
  out here (:class:`AmsgradAdam`).

The other optimizers of ``torchok_tpu`` are registered and raise until they
are ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from torchok_tpu_torch.constructor import OPTIMIZERS

__all__ = []


class AmsgradAdam(torch.optim.Optimizer):
    """Adam / AdamW with optax's ``scale_by_amsgrad``: the denominator uses
    the running maximum of the bias-corrected second moment."""

    def __init__(self, params, lr: float, betas: Tuple[float, float], eps: float,
                 weight_decay: float, decoupled: bool):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, decoupled=decoupled))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, lr, eps = group["weight_decay"], group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                grad = p.grad
                if wd and not group["decoupled"]:
                    grad = grad + wd * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                    state["nu_max"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                state["mu"].mul_(b1).add_(grad, alpha=1 - b1)
                state["nu"].mul_(b2).addcmul_(grad, grad, value=1 - b2)
                mu_hat = state["mu"] / (1 - b1 ** t)
                torch.maximum(state["nu_max"], state["nu"] / (1 - b2 ** t), out=state["nu_max"])
                update = mu_hat / (state["nu_max"].sqrt() + eps)
                if wd and group["decoupled"]:
                    update = update + wd * p
                p.add_(update, alpha=-lr)
        return loss


@OPTIMIZERS.register_class(name="Adam")
def adam(params, lr: float, betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-8, weight_decay: float = 0.0, amsgrad: bool = False,
         **_ignored) -> torch.optim.Optimizer:
    betas = (float(betas[0]), float(betas[1]))
    if amsgrad:
        return AmsgradAdam(params, lr, betas, eps, weight_decay, decoupled=False)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)


@OPTIMIZERS.register_class(name="AdamW")
def adamw(params, lr: float, betas: Tuple[float, float] = (0.9, 0.999),
          eps: float = 1e-8, weight_decay: float = 0.01, amsgrad: bool = False,
          **_ignored) -> torch.optim.Optimizer:
    betas = (float(betas[0]), float(betas[1]))
    if amsgrad:
        return AmsgradAdam(params, lr, betas, eps, weight_decay, decoupled=True)
    return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)


@OPTIMIZERS.register_class(name="SGD")
def sgd(params, lr: float, momentum: float = 0.0, dampening: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False,
        **_ignored) -> torch.optim.Optimizer:
    # optax.trace with nesterov and no momentum is plain SGD; torch refuses it
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                           weight_decay=weight_decay,
                           nesterov=bool(nesterov and momentum))


def _not_ported(name: str):
    def make(params, lr: float = 0.0, **_ignored):
        raise NotImplementedError(f"optimizer {name} is not ported yet "
                                  "(available: Adam, AdamW, SGD)")
    make.__name__ = name
    OPTIMIZERS.register_class(make, name=name)


for _name in ("Adamax", "RMSprop", "Adagrad", "Adadelta", "Rprop", "LBFGS", "ASGD",
              "SparseAdam", "Lion", "Lamb"):
    _not_ported(_name)
