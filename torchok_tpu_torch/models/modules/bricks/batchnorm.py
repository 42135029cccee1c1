"""BatchNorm with the statistics of ``flax.linen.BatchNorm`` as ``torchok_tpu``
configures it (``momentum=0.9, epsilon=1e-5``).

Two things differ from ``torch.nn.BatchNorm2d``: Flax's momentum 0.9 is
torch's 0.1 (``running = 0.9 * running + 0.1 * batch``), and Flax stores the
**biased** batch variance in the running average where torch stores the
unbiased one (times ``n / (n - 1)``). This module normalises through
``F.batch_norm`` (whose batch statistics are the biased ones in both
frameworks) and then takes the unbiased factor back out of the running
variance, so a train step leaves the same ``running_mean`` / ``running_var``
as the JAX package's ``batch_stats``. It has no ``num_batches_tracked``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.Module):
    """Over the channels of an NCHW map; ``weight``/``bias`` are Flax's
    ``scale``/``bias``, ``running_mean``/``running_var`` its ``mean``/``var``."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 zero_init: bool = False):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum  # Flax's: the share the running average keeps
        self.eps = eps
        self.zero_init = zero_init
        # off: a training forward still normalises with the batch's
        # statistics but leaves the running ones as they are (the JAX
        # package's bn_mask at 0, set by FreezeUnfreeze)
        self.update_running_stats = True
        self.weight = nn.Parameter(torch.zeros(num_features) if zero_init
                                   else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_init else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if not self.update_running_stats:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        # the library call updates copies: autograd keeps what it was handed,
        # and the buffers are written once, after the correction
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0 - self.momentum,
                         self.eps)
        with torch.no_grad():
            if n > 1:
                # var now holds kept + (1 - momentum) * batch_var * n/(n-1):
                # take the unbiased factor out of the new share
                kept = self.running_var * self.momentum
                var = var - (var - kept) / n
            self.running_mean.copy_(mean)
            self.running_var.copy_(var)
        return y

    def extra_repr(self) -> str:
        return f"{self.num_features}, momentum={self.momentum}, eps={self.eps}"
